"""The RailX collective schedules and gradient compression on a
``torch.distributed`` ``DeviceMesh`` (counterpart of ``repro.collectives``)."""

from .schedules import (  # noqa: F401
    all_gather_axis,
    all_reduce_axis,
    all_to_all_axis,
    byte_ledger,
    flat_all_reduce,
    hierarchical_all_gather,
    hierarchical_all_reduce,
    hierarchical_reduce_scatter,
    make_all_reduce_fn,
    reduce_scatter_axis,
    ring_all_reduce_2d,
    tree_flat_all_reduce,
    tree_hierarchical_all_reduce,
)
from .compression import (  # noqa: F401
    ErrorFeedback,
    Int8Compressed,
    compressed_hierarchical_all_reduce,
    ef_compress,
    int8_compress,
    int8_decompress,
)
