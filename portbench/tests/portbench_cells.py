"""Tiny cells for the benchmark's CPU tests: the registry's smoke models,
run through the same runner, reference and comparison as the full cells."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import bench  # noqa: E402

SMOKE_MODELS = {
    "moonshot-v1-16b-a3b": {
        "num_layers": 2, "d_model": 64, "heads": 4, "kv_heads": 4, "head_dim": 16, "d_ff": 96,
        "vocab": 128, "qk_norm": False, "rope_theta": 50000.0, "tie_embeddings": False,
        "moe": {"num_experts": 4, "top_k": 2, "d_ff": 96, "capacity_factor": 1.25,
                "aux_loss_coeff": 0.01, "num_shared_experts": 0}},
    "qwen3-8b": {
        "num_layers": 2, "d_model": 64, "heads": 4, "kv_heads": 2, "head_dim": 16, "d_ff": 128,
        "vocab": 128, "qk_norm": True, "rope_theta": 1000000.0, "tie_embeddings": False,
        "moe": None},
}

# limits for the tiny cells, from their own readings on this CPU (bf16, both
# tiny models, seeds 1-3 and 11-13): the program's largest against the fp8
# control's smallest, loss 2.58e-3 / 2.96e-3, change 5.90e-3 / 6.64e-3; at
# this width grad reads up to 1.62e-2 for the program and down to 9.7e-3 for
# the control, so it is held against gross faults only
TINY_LIMITS = {"loss": {"limit": 2.75e-3}, "grad": {"limit": 0.05}, "change": {"limit": 6.25e-3}}

TINY_TRAFFIC = {"seq_len": 64, "rows": 2, "microbatches": 2, "pool_steps": 6, "checked_steps": 3,
                "profile_steps": 2}


def config_for(registry: str, dtype: str, shared_experts: int = 0) -> dict:
    """The registry's model at the smoke sizes, as a configuration file holds
    it; an MoE model with ``shared_experts`` shared experts."""
    cfg = {"kind": "train", "reference": "decoder_lm",
           "model": copy.deepcopy(SMOKE_MODELS[registry]),
           "run": {"registry": registry, "dtype": dtype,
                   "remat": True, "attn_impl": "flash"}}
    if shared_experts:
        cfg["model"]["moe"]["num_shared_experts"] = shared_experts
    return cfg


def traffic() -> dict:
    src = bench.load_json(bench.HERE / "traffic" / "pretrain-8k.json")
    return dict(src, **TINY_TRAFFIC)


def cell(registry: str = "moonshot-v1-16b-a3b", dtype: str = "float32",
         limits: dict = None, shared_experts: int = 0) -> bench.Cell:
    return bench.Cell(name=f"tiny-{registry}", chips=1,
                      config=config_for(registry, dtype, shared_experts),
                      traffic=traffic(),
                      limits=TINY_LIMITS if limits is None else limits,
                      end_to_end=[], per_layer=[])


def write_set(bench_dir: Path, root: Path, name: str = "tiny-moe") -> None:
    """A configuration, a mix, an end-to-end and a per-layer metric, limits
    and a cell, written as new files and entries beside copies of the
    benchmark's own."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bench_dir / sub).mkdir(parents=True, exist_ok=True)
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    (bench_dir / "configs" / f"{name}.json").write_text(
        json.dumps(config_for("moonshot-v1-16b-a3b", "float32")))
    (bench_dir / "traffic" / f"{name}-mix.json").write_text(json.dumps(traffic()))
    (bench_dir / "limits" / f"{name}-cell.json").write_text(json.dumps(TINY_LIMITS))
    (bench_dir / "metrics" / "window_steps.py").write_text(
        '"""window_steps: the steps the window ran."""\n\n\n'
        "def read(record):\n    return len(record.steps)\n")
    (bench_dir / "metrics" / "window_s.py").write_text(
        '"""window_s: the seconds of the window."""\n\n\n'
        "def read(record):\n    return record.window_s\n")
    spec["configs"].append({"name": name, "source": "https://example.org/tiny",
                            "file": f"portbench/configs/{name}.json", "reduced": [],
                            "why": "a tiny test set"})
    spec["workloads"].append({"name": f"{name}-cell", "config": name, "traffic": f"{name}-mix",
                              "chips": 1, "why": "a tiny test cell"})
    spec["end_to_end"].append({"name": "window_steps", "unit": "count", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": [f"{name}-cell"]})
    spec["per_layer"].append({"name": "window_s", "unit": "s", "better": "lower",
                              "source": "host_clock", "layer": "train step",
                              "moves": "window_steps", "workloads": [f"{name}-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
