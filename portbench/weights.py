"""The weights of a run, made on the device from the seed.

Each leaf of the reference's ``param_layout`` is one draw on the device, in
the type the configuration stores (bf16 in the cells), by a generator of its
own seeded from (seed, leaf index): a normal draw cut at +-2 and scaled, or
ones.  So a leaf can be made again alone (``make_leaf``), bit for bit, for
the change of the program's weights after its first steps.  The program and
the reference take the same tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

WEIGHTS = 2  # the purpose index of the weights in the seed's SeedSequence


def _leaf_seed(seed: int, index: int) -> int:
    state = np.random.SeedSequence([int(seed), WEIGHTS, index]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_leaf(layout: Dict[str, Tuple[Tuple[int, ...], str, float]], name: str, seed: int,
              dtype: torch.dtype, device: Any) -> torch.Tensor:
    shape, init, scale = layout[name]
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_leaf_seed(seed, list(layout).index(name)))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.clamp_(-2.0, 2.0).mul_(scale)


def make(layout: Dict[str, Tuple[Tuple[int, ...], str, float]], seed: int, dtype: torch.dtype,
         device: Any) -> Dict[str, torch.Tensor]:
    return {name: make_leaf(layout, name, seed, dtype, device) for name in layout}
