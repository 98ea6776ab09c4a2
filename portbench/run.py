"""Runs one cell of ``BENCHMARK.json`` once, on the card(s) of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted`` and ``failed`` (the window's steps, and
those whose loss was not finite), ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the profiled steps),
with ``--trace 1`` a ``breakdown`` of the device's operations and idle
gaps, and last ``checks``: each number compared for ``correct`` with its
limit, which also close standard error.  Exits non-zero and prints no result
without enough CUDA cards, or when the run loaded JAX or the JAX package or
opened a file of it (``portbench.guard``).  Caches (the port's kernels under
``build/kernels``) stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, guard  # noqa: E402


def _fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _number(x: float):
    """A JSON number, or the name of a value JSON has none for."""
    return x if math.isfinite(x) else repr(x)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.replace("\n", "; ")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    guard.install(ROOT)
    if guard.problems():
        _fail("before the run: " + "; ".join(guard.problems()), 3)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    cell = bench.find_cell(args.workload, ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count {torch.cuda.device_count()}")
    print(f"portbench: {args.workload} seed {args.seed} on {_card_line()}", flush=True)

    out = bench.runner(cell.config["kind"]).run(cell, args.seed, args.seconds,
                                                 bool(args.trace), T_START)
    record = out["record"]
    problems = guard.problems()
    if problems:
        _fail("the run " + "; ".join(problems), 3)

    metrics = bench.read_metrics(cell.per_layer if args.trace else cell.end_to_end, record)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(record.peak_bytes)}
    result = {"correct": out["correct"], "attempted": len(record.steps),
              "failed": sum(1 for s in record.steps if not math.isfinite(s["loss"])),
              "metrics": metrics, "device": device}
    if args.trace and record.trace is not None:
        t = record.trace
        device["busy_s"] = t.busy_us() / 1e6
        device["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    result["checks"] = {k: {n: _number(x) for n, x in c.items()} for k, c in out["checks"].items()}
    print(f"portbench: seconds {json.dumps(record.stages)}; window {record.window_s} over "
          f"{len(record.steps)} steps", flush=True)
    print(f"portbench: step ms {[round(1e3 * s['seconds'], 2) for s in record.steps]}", flush=True)
    print(f"portbench: numbers {json.dumps(out['numbers'])}", flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
