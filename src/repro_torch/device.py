"""Device resolution for the port's entry points.

The default is the card.  A missing card is an error, never a silent move
to the CPU: a caller who wants the plain CPU versions says ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises if a CUDA device is asked for and
    there is none.  ``"meta"`` holds shapes only and computes nothing (the
    dry run, ``launch/dryrun.py``, traces there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def generator(seed_or_gen: Union[int, torch.Generator], device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: an int is a seed (on the meta
    device, which draws nothing, a CPU generator)."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    g = torch.Generator(device=device if device.type != "meta" else "cpu")
    g.manual_seed(int(seed_or_gen))
    return g
