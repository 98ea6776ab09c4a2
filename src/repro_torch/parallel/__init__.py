"""Logical-axis sharding on a ``torch.distributed`` ``DeviceMesh``
(counterpart of ``repro.parallel``)."""
