"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input shape) cell and both production meshes
(16x16 single-pod, 2x16x16 multi-pod), run the train or serve step of one
rank, rank 0, on the ``meta`` device (shapes only, nothing allocated) in a
one-process world of torch's ``"fake"`` backend (256 or 512 ranks whose
collectives move nothing), and record per rank:

  * the argument bytes (params, AdamW moments, the rank's batch rows and
    cache blocks, from the layouts) and the peak of the live bytes (the
    arguments plus what the step allocates at its peak,
    ``roofline.TraceCounter``): whether the cell fits one card's 80 GB;
  * FLOPs (``torch.utils.flop_counter``'s formulas), HBM bytes (inputs +
    outputs of each op) and collective bytes by op and axes
    (``collectives.byte_ledger``);
  * the roofline terms at H100 SXM constants (``launch/roofline.py``).

The rank runs the program it runs on a card: its rows (and, under
``seq -> "model"``, its positions: sequence parallelism), its blocks, its
collectives; prefill and decode return the rank's logits (the serve steps
gather them whole for the caller, which the reference's sharded outputs do
not).  Results land in ``results/dryrun_torch/<cell>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import DRYRUN_ARCHS, SHAPES, get_config, supports_long_context
from ..configs.base import ModelConfig, ShapeConfig
from ..models.model_zoo import get_model
from . import roofline

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch")
META = torch.device("meta")


def dryrun_model_config(cfg: ModelConfig) -> ModelConfig:
    """Deployment numerics: bf16 params+compute, remat on."""
    return dataclasses.replace(
        cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, remat=True
    )


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell (the global
    batch)."""
    B, S = shape.global_batch, shape.seq_len
    f = cfg.compute_dtype

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    if shape.kind == "train":
        batch: Dict[str, Any] = {
            "tokens": sds((B, S), torch.int32),
            "targets": sds((B, S), torch.int32),
        }
        if cfg.family == "vlm":
            batch["embeds"] = sds((B, S, cfg.d_model), f)
            batch["positions3"] = sds((3, B, S), torch.int32)
            del batch["tokens"]
        if cfg.family == "whisper":
            batch["enc_embeds"] = sds((B, S, cfg.d_model), f)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": sds((B, S), torch.int32)}
        if cfg.family == "vlm":
            batch["embeds"] = sds((B, S, cfg.d_model), f)
            batch["positions3"] = sds((3, B, S), torch.int32)
            del batch["tokens"]
        if cfg.family == "whisper":
            batch["enc_embeds"] = sds((B, S, cfg.d_model), f)
            batch["tokens"] = sds((B, S), torch.int32)
        return batch
    # decode: one new token against a cache of length S
    batch = {"tokens": sds((B, 1), torch.int32)}
    if cfg.family == "vlm":
        batch["positions3"] = sds((3, B, 1), torch.int32)
    return batch


def cell_is_skipped(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not supports_long_context(arch):
        return (
            "full-attention arch: long_500k requires sub-quadratic context "
            "(DESIGN.md §Shape-cell skips)"
        )
    return None


def fake_world(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` world of ``world`` ranks
    (again if the size changes)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    dp_mode: str = "gspmd_fsdp",
    schedule: str = "hierarchical",
    microbatches: int = 1,
    rules_overrides: Optional[Dict[str, Any]] = None,
    model_overrides: Optional[Dict[str, Any]] = None,
    tag: str = "",
    mesh=None,
    cfg: Optional[ModelConfig] = None,
    shape: Optional[ShapeConfig] = None,
) -> Dict[str, Any]:
    """One cell on the production mesh (or on ``mesh``, a mesh of the world
    the caller set up, with ``cfg`` / ``shape`` in place of the registry's
    when given)."""
    from ..parallel.sharding import attention_overrides
    from ..serve.serve_step import make_serve_step
    from ..train import optimizer as opt_lib
    from ..parallel.sharding import rank_batch
    from ..train.train_step import make_train_step
    from .mesh import make_production_mesh

    shape = shape or SHAPES[shape_name]
    mesh_name = "pod2" if multi_pod else "pod1"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        return {"cell": cell_id, "status": "SKIP", "reason": skip}

    cfg = cfg or dryrun_model_config(get_config(arch))
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    zoo = get_model(cfg)
    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    chips = 1
    for s in sizes.values():
        chips *= s
    t0 = time.perf_counter()

    batch = input_specs(cfg, shape)
    overrides = dict(attention_overrides(cfg, sizes.get("model", 1), shape.kind))
    if shape.kind == "decode" and shape.global_batch < 32:
        # long-context decode: batch unshardable; context-parallel KV instead
        overrides.setdefault("batch", None)
        overrides.setdefault("kv_seq", "data")
    overrides.update(rules_overrides or {})

    memory: Dict[str, float] = {}
    if shape.kind == "train":
        ocfg = opt_lib.AdamWConfig()
        step_fn = make_train_step(zoo, ocfg, microbatches, META, mesh=mesh, dp_mode=dp_mode,
                                  schedule=schedule, rules_overrides=overrides)
        params = step_fn.layout.shard(zoo.init(0, device=META))
        params.requires_grad_(True)
        opt = opt_lib.init(ocfg, params)
        rows = rank_batch(mesh, batch, seq=step_fn.plan.seq)
        memory["param_bytes"] = _bytes(dict(params.state_dict()))
        memory["moment_bytes"] = _bytes((opt.mu, opt.nu))
        memory["batch_bytes"] = _bytes(rows)
        args = [*params.parameters(), *_tensors((opt.mu, opt.nu)), *_tensors(batch)]
        _, stats = roofline.trace(step_fn, params, opt, batch, external=args, sizes=sizes)
        tokens = shape.global_batch * shape.seq_len
        model_flops = roofline.model_train_flops(cfg.active_param_count(), tokens)
    else:
        cache = None
        if shape.kind == "decode":
            cache = zoo.init_cache(shape.global_batch, shape.seq_len, device=META)
        arts = make_serve_step(zoo, META, mesh=mesh, batch_example=batch, cache_example=cache,
                               rules_overrides=overrides)
        params = arts.param_layout.shard(zoo.init(0, device=META))
        mine = arts.shard_batch(batch, prefill=shape.kind == "prefill")
        memory["param_bytes"] = _bytes(dict(params.state_dict()))
        memory["batch_bytes"] = _bytes(mine)
        args = [*params.parameters(), *_tensors(batch)]
        if shape.kind == "prefill":
            def fn():
                with torch.inference_mode():
                    return zoo.forward(params, mine, arts.prefill_plan())[0]
            tokens = shape.global_batch * shape.seq_len
        else:
            cache = arts.cache_layout.shard(cache)
            memory["cache_bytes"] = _bytes(cache)
            args += _tensors(cache)

            def fn():
                with torch.inference_mode():
                    return zoo.decode_step(params, cache, mine, arts.plan)[0]
            tokens = shape.global_batch
        _, stats = roofline.trace(fn, external=args, sizes=sizes)
        model_flops = roofline.model_decode_flops(cfg.active_param_count(), tokens)
    memory["argument_bytes"] = sum(memory.values())
    memory["peak_bytes"] = memory["argument_bytes"] + stats.peak_bytes
    t_trace = time.perf_counter() - t0

    extra_flops = 0.0
    if cfg.attn_impl == "flash":
        # attention FLOPs live inside the opaque kernel: 2 matmuls x
        # 2*B*H*S^2*Dh, halved for causal; train = 4x (fwd + remat + bwd).
        B, S = shape.global_batch, shape.seq_len
        H, Dh, L = cfg.heads, cfg.resolved_head_dim, cfg.num_layers
        fwd = 2 * 2 * B * H * S * S * Dh * 0.5 * L
        extra_flops = fwd * (4 if shape.kind == "train" else 1)
    report = roofline.build_report(
        arch, shape_name, mesh_name, chips, stats, memory, model_flops,
        default_trip=cfg.num_layers, extra_flops_global=extra_flops,
    )
    return {
        "cell": cell_id,
        "status": "OK",
        "dp_mode": dp_mode,
        "schedule": schedule,
        "overrides": {k: v for k, v in overrides.items()},
        "trace_s": round(t_trace, 1),
        "ops": stats.ops,
        "fits_80GB": memory["peak_bytes"] <= 80e9,
        "report": report.as_dict(),
    }


def save_result(result: Dict[str, Any], out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, result["cell"] + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dp-mode", default="gspmd_fsdp")
    ap.add_argument("--schedule", default="hierarchical")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-impl", default="ref")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = DRYRUN_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.perf_counter()
                try:
                    res = run_cell(
                        arch, shape, multi_pod=mp,
                        dp_mode=args.dp_mode, schedule=args.schedule,
                        microbatches=args.microbatches,
                        model_overrides=(
                            {"attn_impl": args.attn_impl}
                            if args.attn_impl != "ref" else None
                        ),
                        tag=args.tag,
                    )
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    res = {
                        "cell": f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                        + (f"__{args.tag}" if args.tag else ""),
                        "status": "FAIL",
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                path = save_result(res, args.out)
                status = res["status"]
                extra = ""
                if status == "OK":
                    r = res["report"]
                    m = r["memory_stats"]
                    extra = (
                        f" arg={m['argument_bytes'] / 2**30:.2f}GiB"
                        f" peak={m['peak_bytes'] / 2**30:.2f}GiB"
                        f"{'' if res['fits_80GB'] else ' (over 80 GB)'}"
                        f" dom={r['dominant']} frac={r['roofline_fraction']:.3f}"
                        f" comp={r['compute_s']*1e3:.1f}ms"
                        f" mem={r['memory_s']*1e3:.1f}ms"
                        f" coll={r['collective_s']*1e3:.1f}ms"
                    )
                elif status == "FAIL":
                    extra = " " + res["error"][:120]
                print(
                    f"[{status}] {res['cell']} ({time.perf_counter()-t0:.0f}s){extra}",
                    flush=True,
                )
    print(f"sweep: {time.perf_counter() - t_all:.0f}s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
