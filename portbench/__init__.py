"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it
(``portbench.bench``): ``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``, ``limits/<workload>.json`` and, by a configuration's
``kind``, ``runners/<kind>.py``.  The yardstick (the token stream, the
weights, the plain reference, the operation and byte counts, the trace's
reduction and the comparison that decides ``correct``) lives here, so a
change to ``repro_torch`` cannot move it.  Nothing here imports ``jax`` or
the JAX package ``repro`` (``portbench.guard``).
"""
