"""The readings a cell's limits for ``correct`` are set from (on the card).

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \
        [--sides program,control,half_batch] [--out FILE]

For each seed, in one process: the program's first steps as a run takes
them (set-up and the checked steps, no window), the same with each fault
named (``half_batch``, ``unchanged``), the reference in float32, and the
control (the reference in fp8, in the program's place); then the numbers
of ``portbench.compare`` for each side against the float32 reference.  One
JSON line a seed and side, on standard output and appended to ``--out``.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, compare  # noqa: E402

FAULTS = ("half_batch", "unchanged")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    cell = bench.find_cell(args.workload, ROOT)
    train = bench.runner(cell.config["kind"])
    n = int(cell.traffic["checked_steps"])
    sides = args.sides.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        found = {}
        for side in sides:
            if side == "program" or side in FAULTS:
                t0 = time.perf_counter()
                prog = train.build(cell, seed, "cuda", None if side == "program" else side)
                found[side] = train.checked_steps(prog, n)
                train.free(prog)
                found[side]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = train.reference_readings(cell, seed, "cuda", n)
        ref_s = time.perf_counter() - t0
        if "control" in sides:
            t0 = time.perf_counter()
            found["control"] = train.reference_readings(cell, seed, "cuda", n, "fp8")
            found["control"]["seconds"] = time.perf_counter() - t0
        for side, got in found.items():
            line = {"workload": cell.name, "seed": seed, "side": side,
                    "numbers": compare.numbers(got, ref), "worst": compare.worst(got, ref),
                    "seconds": got["seconds"],
                    "reference_seconds": ref_s, "loss": got["loss"], "reference_loss": ref["loss"]}
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
