"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into its own shared
library under ``build/kernels/`` at the root of the checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I kernels/common \
         -o build/kernels/<name>-<hash>.so <src>

``kernels/common/`` holds the headers the kernel families share.  The file
name carries a hash of the source, the ``*.cuh`` headers beside it and in
``common/``, and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  The sources have a plain C interface
(pointers, ints, the stream), which keeps a build to seconds; nothing
includes PyTorch's headers.  A failed build or load
raises.  ``build_all`` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

KERNELS_DIR = Path(__file__).resolve().parent
COMMON_DIR = KERNELS_DIR / "common"
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# source (relative to kernels/) -> loaded library
_LIBS: Dict[str, ctypes.CDLL] = {}
# source -> {"seconds": build time or 0.0 when cached, "log": nvcc's output}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(source: str) -> Path:
    src = KERNELS_DIR / source
    # the headers beside a source and the shared ones are part of it
    headers = sorted(src.parent.glob("*.cuh")) + sorted(COMMON_DIR.glob("*.cuh"))
    data = src.read_bytes() + b"".join(h.read_bytes() for h in headers)
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _start(source: str):
    out = _target(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(COMMON_DIR), "-o", str(tmp), str(KERNELS_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(source: str, started) -> None:
    if started is None:
        BUILD_INFO.setdefault(source, {"seconds": 0.0, "log": "(cached build)"})
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_INFO[source] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all(sources: Iterable[str]) -> List[Path]:
    """Build every source not yet built, one nvcc each, all in parallel."""
    sources = list(sources)
    started = [(s, _start(s)) for s in sources]
    for source, st in started:
        _finish(source, st)
    return [_target(s) for s in sources]


def load(source: str) -> ctypes.CDLL:
    """The library built from ``source`` (a path relative to ``kernels/``),
    building it first if needed."""
    if source not in _LIBS:
        (path,) = build_all([source])
        try:
            _LIBS[source] = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"could not load {path}: {e}") from e
    return _LIBS[source]
