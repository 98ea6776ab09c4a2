"""Keeps a run to the port: no JAX, nothing of the JAX package.

``install(root)`` starts watching, at the start of a run: an audit hook
records every file the process opens (``open`` and ``io.open_code``, so
imports too) that lies under ``benchmarks/`` or ``src/repro/`` of the
checkout, the JAX package's harness and the package itself.  ``problems()``
lists those paths and every loaded module whose top-level name (the part
before the first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or
``repro``; ``repro_torch`` is another name and passes.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
FORBIDDEN_DIRS = ("benchmarks", os.path.join("src", "repro"))

_opened: List[str] = []
_roots: List[str] = []


def _hook(event: str, args) -> None:
    if event != "open" or not _roots or not args:
        return
    path = args[0]
    if isinstance(path, int):  # a file descriptor
        return
    if isinstance(path, bytes):
        path = os.fsdecode(path)
    path = os.path.abspath(os.fspath(path))
    for base in _roots:
        if path == base or path.startswith(base + os.sep):
            _opened.append(path)
            return


def install(root: Path) -> None:
    """Watch the files this process opens from now on."""
    if not _roots:
        sys.addaudithook(_hook)
    _roots[:] = [os.path.join(os.path.abspath(root), d) for d in FORBIDDEN_DIRS]


def loaded_forbidden() -> List[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN_MODULES)


def problems() -> List[str]:
    found = [f"module {m} is loaded" for m in loaded_forbidden()]
    found += [f"opened {p}" for p in dict.fromkeys(_opened)]
    return found
