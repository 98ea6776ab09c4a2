"""PyTorch/CUDA port of the ``repro`` LLM stack, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``models``, ``kernels``, ``serve``, ``train``,
``checkpoint``, ``data``, ``launch``) so each function has an obvious
counterpart there.  It imports ``torch`` only: never ``jax`` and nothing of
``repro``.

Entry points (``ModelZoo.init``, ``ModelZoo.init_cache``,
``make_serve_step``, ``make_train_step``, ``python -m
repro_torch.launch.train``) run on the card unless called with
``device="cpu"``; without a card and without that argument they raise.  On
the CPU every hand-written kernel is replaced by its plain PyTorch version.
"""
