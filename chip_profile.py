#!/usr/bin/env python3
"""Where the time goes on the card, profiled phase by phase with
``torch.profiler``:

* serve (the ``chip_smoke.py`` serve phase): llama3.2-3b at full width in
  bf16, one wave of 4 x 1024-token prompts: prefill through the flash
  kernel, cache fill, one-token decode steps;
* train (the ``chip_smoke.py`` train phase): one llama3.2-3b AdamW step of
  4 x 1024 tokens with remat and the flash kernels, after one warm-up step,
  split into forward + backward and the optimizer;
* serve_hybrid (the ``chip_smoke.py`` serve_hybrid phase): zamba2-7b at
  full width and depth in bf16, one wave of 4 x 256-token prompts: prefill
  through the SSD kernel, the token-by-token cache fill (profiled over its
  first 32 steps), one decode step.

* train_dist (the ``chip_smoke.py`` train_dist and train_fsdp phases): the
  ``manual_hier`` gradient reduction on a world of one (NCCL, mesh
  (1, 1, 1)), on llama3.2-3b-shaped bf16 gradients: device time per schedule
  (events, and the profiler's kernels) beside the bytes it moves; then the
  one-process step, the ``gspmd_fsdp`` step and the ``manual_hier`` steps in
  turns, 4 rounds of each.

* dist_cards (needs 4 cards, one rank each, NCCL; ``--chips 4``): the
  collectives on a (2, 2) ("pod", "data") mesh, every rank against the sums,
  shards and gathers computed from all ranks' inputs (the compressed
  schedule within its int8 rounding bound); the ``manual_hier`` gradient
  reduction of llama3.2-3b-shaped bf16 grads per schedule (device time,
  the byte ledger); then llama3.2-3b at full width trained 3 steps on one
  card with the global batch of 4 x 1024 tokens and 3 steps of each of
  ``hierarchical`` and ``flat`` on the (2, 2, 1) ("pod", "data", "model")
  world, one sequence a rank, against it; then 3 ``gspmd_fsdp`` steps on
  (1, 2, 2): params and moments sharded, FSDP over "data" and tensor
  parallelism over "model", two sequences a data rank (losses against one
  card's, peak memory a card, step time, collective bytes by op and axes),
  one more step under the profiler on rank 0, and then the ``gspmd_fsdp``
  and ``manual_hier`` (``hierarchical``, (2, 2, 1)) steps in turns, 4
  rounds.

* serve_moe (the ``chip_smoke.py`` serve_moe phase): moonshot-v1-16b-a3b
  at full width and depth in bf16, 4 x 1024-token prompts: prefill, cache
  fill and decode steps, with the device time of each MoE part (routing,
  dispatch, the expert products, combine; labelled by wrapping
  ``models/moe.py``'s functions here).

* moe_cards (needs 4 cards, one NCCL rank each; ``--chips 4``):
  ``gspmd_fsdp`` with expert parallelism of moonshot-v1-16b-a3b on
  (1, 4, 1) and (1, 2, 2) ("pod", "data", "model"), global batch 4 x 1024
  tokens, depth cut to 16 layers: 8 steps each under the byte ledger
  (all-to-all bytes a rank a step beside E x C x D x 2 B x 6 a layer, held
  and peak memory, step time, losses) and one profiled step on rank 0;
  then sharded serving at full depth on (1, 4, 1): prefill, fill and 16
  decode steps; last, at 4 layers, 8 EP steps on each shape against one
  card's with as many microbatches as "data" ranks (losses within 1e-2).

And an A/B of the flash-attention kernels against another checkout:

* flash_ab DIR: ``flash_fwd`` and ``flash_fwd_lse`` at the serving prefill
  shape (B=4, H=24, Hk=8, S=1024, Dh=128, bf16, causal), and the backward
  kernels ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the same (training)
  shape, timed in the package of the checkout at DIR (say, the parent
  commit unpacked with ``git archive``) and in this one, in turns (DIR,
  this, this, DIR), each run in a fresh process that builds that
  checkout's kernels: device time (a CUDA graph of 20 launches) and 20
  back-to-back wrapper calls timed with events.

* flash_ablate: what each part of the TMA / wgmma kernels' design is worth.
  Variants of ``flash_fwd.cu`` and of ``flash_bwd.cu``, each with one part
  taken out (or, marked so, added) by a text substitution, are built beside
  the unmodified sources and timed at the serving prefill / training shape
  (device time, CUDA graph), in two rounds.  The forward variants that drop
  work (the softmax, the K/V loads) give wrong outputs: they only measure
  what that work costs.

The same for the scans:

* scan_ab DIR: ``ssd_fwd`` at zamba2-7b and ``mlstm_fwd`` at xlstm-125m
  (4 x 1024 tokens, f32), in the checkout at DIR and in this one, in turns
  (DIR, this, this, DIR), as flash_ab: device time of the whole call (all
  its kernels, a CUDA graph of 20 calls) and 20 back-to-back calls; then
  this checkout's calls under the profiler, time by CUDA kernel.

* scan_ablate: each part of the scans' design taken out in turn by a text
  substitution of ``ssd_fwd.cu`` and ``mlstm_fwd.cu`` (3xTF32 against one
  TF32 pass, the C B^T pre-pass, the split of P across blocks, the load
  ring's prefetch; and, marked "added", other tile sizes), built beside the
  unmodified sources and timed at the same shapes, two rounds, with each
  build's error against the chunked plain version.

And one look at numbers rather than time:

* xlstm_agreement: why xlstm-125m's bf16 prefill and cache fill agree less
  than llama's or zamba2's.  The ``chip_smoke.py`` serve_xlstm weights (seed
  0) and prompts walked layer by layer (``chip_smoke.xlstm_layer_walk``) in
  bf16 and, with the same weights, in f32; each as the model is (the
  recurrent form divides by max(|q.n|, 1)) and with the recurrent form
  dividing by max(|q.n|, exp(-m)), as the chunkwise form does (a control;
  the model keeps the reference's normaliser).

    python3 chip_profile.py [serve] [train] [serve_hybrid] [train_dist] [dist_cards]
                            [serve_moe] [moe_cards] [xlstm_agreement] [flash_ab DIR]
                            [flash_ablate] [scan_ab DIR] [scan_ablate]
                                                    # serve and train when none is named

For each profiled phase it prints the host time, the device time summed
over kernels, the device busy share, and the kernels that take most device
time.  Needs a CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

STEPS = 8  # one-token decode steps profiled

# the MoE layer's parts, each under a ``record_function`` label while
# ``_moe_labels`` is open (a patch of ``models/moe.py``'s functions here;
# the package itself carries no labels)
MOE_PARTS = {"_route": "moe.route", "_dispatch": "moe.dispatch", "_expert_ffn": "moe.experts",
             "_combine": "moe.combine", "all_to_all": "moe.all_to_all"}


def _device_us(prof) -> tuple:
    """(sum of kernel time, busy time of the union of kernel intervals) in us;
    the device-side spans of ``record_function`` labels are not kernels."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA" and e.name not in MOE_PARTS.values())
    total = sum(e - s for s, e in spans)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return total, busy


# the port's hand-written kernels, by a part of their device names: ssd_fwd
# runs ssd_prep_kernel and ssd_scan_kernel, mlstm_fwd the three mlstm_ ones
PORT_KERNELS = ("flash_fwd", "flash_bwd", "ssd_prep_kernel", "ssd_scan_kernel",
                "mlstm_state_kernel", "mlstm_combine_kernel", "mlstm_out_kernel")


def _report(name: str, prof, host_ms: float, per: int = 1, unit: str = "call") -> None:
    total, busy = _device_us(prof)
    print(f"profile {name}: host {host_ms / per:.3f} ms, kernels {total / 1e3 / per:.3f} ms, "
          f"device busy {busy / 1e3 / per:.3f} ms ({busy / 1e3 / host_ms:.1%}) per {unit}")
    for part in PORT_KERNELS:
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type.name == "CUDA" and part in e.name]
        if spans:
            print(f"profile {name}: port kernel {part}: {len(spans) / per:g} launches, "
                  f"{sum(spans) / 1e3 / per:.3f} ms per {unit}")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=12,
                                    max_name_column_width=70))


def _profiled(fn):
    """Run fn under the profiler; returns (prof, host ms to a synchronised end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    return prof, host_ms


def profile_train(smi: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step, to_device

    cfg = dataclasses.replace(get_config("llama3.2-3b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, remat=True, attn_impl="flash")
    zoo = get_model(cfg)
    params = zoo.init(0, device="cuda")
    params.requires_grad_(True)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    opt = opt_lib.init(ocfg, params)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=1024, global_batch=4))
    step_fn = make_train_step(zoo, ocfg, device="cuda")
    state = {"opt": opt}

    def step(i):
        _, state["opt"], m = step_fn(params, state["opt"], data.batch(i))
        m["loss"].item()

    step(0)  # warm-up of every path
    print(f"profile: {cfg.name} bf16 train step, 4 x 1024 tokens, remat, flash [{smi}]")
    prof, host_ms = _profiled(lambda: step(1))
    _report("train_step", prof, host_ms, unit="step")

    # the same step in two halves: forward + backward, then the optimizer
    batch = to_device(data.batch(2), torch.device("cuda"))
    named = dict(params.named_parameters())

    def fwd_bwd():
        for p in named.values():
            p.grad = None
        loss, _ = zoo.loss(params, batch)
        loss.backward()

    prof, host_ms = _profiled(fwd_bwd)
    _report("train_fwd_bwd", prof, host_ms, unit="step")
    grads = {n: p.grad for n, p in named.items()}
    prof, host_ms = _profiled(lambda: opt_lib.apply(ocfg, state["opt"], params, grads))
    _report("train_adamw", prof, host_ms, unit="step")


def profile_train_dist(smi: str) -> None:
    import statistics

    import torch
    import torch.distributed as dist

    from chip_smoke import _time_ms, _train_init, _train_setup
    from repro_torch.launch.mesh import free_port, make_mesh
    from repro_torch.train.train_step import _ManualHier, make_train_step

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cuda")
        cfg, zoo, ocfg, data = _train_setup()
        params, opt = _train_init(zoo, ocfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        grads = {n: torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype)
                 for n, p in params.named_parameters()}
        v = sum(g.numel() * g.element_size() for g in grads.values())
        print(f"profile: {cfg.name} manual_hier gradient reduction on a world of one (NCCL), "
              f"{len(grads)} bf16 leaves, V = {v / 1e9:.3f} GB [{smi}]")
        # read + write passes over V: hierarchical copies into the reduce-scatter's and the
        # all-gather's buffers and divides by the DP size; flat clones and divides
        passes = {"flat": 2, "hierarchical": 3}
        for sched in ("flat", "hierarchical"):
            red = _ManualHier(mesh, sched).reduce_grads
            ms = _time_ms(lambda: red(grads), iters=5, warmup=1)
            bound = 2 * passes[sched] * v / 3.35e12 * 1e3
            print(f"profile reduce_{sched}: {ms:.3f} ms device a step (events, 5 calls); "
                  f"{passes[sched]} read + write passes over V would take {bound:.3f} ms at "
                  f"3.35 TB/s ({bound / ms:.1%})")
            prof, host_ms = _profiled(lambda: red(grads))
            _report(f"reduce_{sched}", prof, host_ms, unit="step")
        del grads

        # on one rank the gspmd_fsdp blocks are the whole leaves: the same params serve
        fns = {"one process": make_train_step(zoo, ocfg, device="cuda"),
               "gspmd_fsdp": make_train_step(zoo, ocfg, device="cuda", mesh=mesh)}
        for sched in ("hierarchical", "flat"):
            fns[sched] = make_train_step(zoo, ocfg, device="cuda", mesh=mesh,
                                         dp_mode="manual_hier", schedule=sched)
        state = {"opt": opt, "i": 0}

        def step(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state["opt"], m = fn(params, state["opt"], data.batch(state["i"]))
            m["loss"].item()
            state["i"] += 1
            return (time.perf_counter() - t0) * 1e3

        for fn in fns.values():
            step(fn)  # warm-up
        times = {k: [] for k in fns}
        names = list(fns)
        for r in range(4):
            for k in (names if r % 2 == 0 else names[::-1]):
                times[k].append(step(fns[k]))
        base = statistics.median(times["one process"])
        for k, ts in times.items():
            med = statistics.median(ts)
            print(f"profile train_dist {k}: step ms {[round(t, 2) for t in ts]}, median "
                  f"{med:.2f} ({med - base:+.2f} against one process) [{smi}]")
    finally:
        dist.destroy_process_group()


# bf16 gradients summed across 4 ranks in bf16 against one f32-accumulated
# product over the whole batch, then three AdamW steps: relative, on the loss
CARDS_LOSS_REL = 1e-2
CARDS_STEPS = 3


def cards_collectives(rank: int, world: int, device: str) -> None:
    """Each schedule on a (2, world / 2) ("pod", "data") mesh against what
    every rank can compute from all ranks' inputs."""
    import torch

    from repro_torch.collectives import compression as C
    from repro_torch.collectives import schedules as S
    from repro_torch.launch.mesh import make_mesh

    P, D = 2, world // 2
    mesh = make_mesh((P, D), ("pod", "data"), device)
    X = torch.randn(world, 2 * world * 5000, generator=torch.Generator().manual_seed(0))
    x, total = X[rank].to(device), X.sum(0)
    p, d = divmod(rank, D)
    got = {
        "flat": (S.flat_all_reduce(x, mesh, ("pod", "data")), total),
        "hierarchical": (S.hierarchical_all_reduce(x, mesh, "data", "pod"), total),
        "ring2d": (S.ring_all_reduce_2d(x, mesh, ("data", "pod")), total),
        "reduce_scatter": (S.reduce_scatter_axis(x, mesh, ("pod", "data")),
                           total.chunk(world)[rank]),
        "all_gather": (S.all_gather_axis(x, mesh, ("pod", "data")), X.reshape(-1)),
        "all_to_all": (S.all_to_all_axis(x, mesh, "data", 0, 0),
                       torch.cat([X[p * D + e].chunk(D)[d] for e in range(D)])),
    }
    errs = {k: (a.cpu() - b).abs().max().item() for k, (a, b) in got.items()}
    # compressed: each pod's data-reduced shard in int8; every element within
    # half a quantum of each pod's chunk scale of the f32 sum
    comp = C.compressed_hierarchical_all_reduce(x, mesh, "data", "pod").cpu()
    bound = []
    for e in range(D):
        for part in (X[q * D:(q + 1) * D].sum(0).chunk(D)[e] for q in range(P)):
            c = C.int8_compress(part)
            bound.append(c.scale.expand(c.values.shape).reshape(-1)[: part.numel()] / 2)
    bound = torch.stack(bound).reshape(D, P, -1).sum(1).reshape(-1)
    over = ((comp - total).abs() - bound).max().item()
    errs["compressed (max |err| - int8 bound)"] = over
    exact = ("all_gather", "all_to_all")
    bad = {k: v for k, v in errs.items()
           if (v != 0 if k in exact else v > (1e-5 if k.startswith("compressed") else 1e-4))}
    if rank == 0 or bad:
        print(f"cards collectives rank {rank} on {device}, mesh (pod {P}, data {D}), "
              f"{x.numel()} f32 a rank: max |err| {errs}", flush=True)
    if bad:
        raise RuntimeError(f"rank {rank}: collectives off: {bad}")


def cards_train(rank: int, world: int, device: str, smi: str) -> None:
    """The manual_hier reduce and step across the cards, against one card."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _largest_gap, _time_ms, _train_init, _train_launches, _train_run
    from chip_smoke import _train_setup
    from repro_torch.collectives import byte_ledger
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import _ManualHier, make_train_step

    cfg, zoo, ocfg, data = _train_setup()
    one = None
    if rank == 0:
        params, opt = _train_init(zoo, ocfg)
        one = _train_run("cards one card", make_train_step(zoo, ocfg, device=device), params,
                         opt, data, CARDS_STEPS)
        del params, opt
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh((2, world // 2, 1), ("pod", "data", "model"), device)
    params, opt = _train_init(zoo, ocfg)
    gen = torch.Generator(device=device).manual_seed(1 + rank)
    grads = {n: torch.randn(p.shape, generator=gen, device=device).to(p.dtype)
             for n, p in params.named_parameters()}
    v = sum(g.numel() * g.element_size() for g in grads.values())
    for sched in ("flat", "hierarchical", "compressed"):
        red = _ManualHier(mesh, sched).reduce_grads
        dist.barrier()
        ms = _time_ms(lambda: red(grads), iters=3, warmup=1)
        with byte_ledger() as ledger:
            red(grads)
        if rank == 0:
            by = {}
            for r in ledger.records:
                key = f"{r.op}({','.join(r.axes)})"
                by[key] = by.get(key, 0) + r.nbytes
            print(f"cards reduce {sched}: {ms:.3f} ms a step on rank 0 (events, 3 calls), "
                  f"V = {v / 1e9:.3f} GB of bf16 grads in {len(grads)} leaves; result GB a "
                  f"rank {({k: round(b / 1e9, 3) for k, b in by.items()})} [{smi}]", flush=True)
    del grads, params, opt
    torch.cuda.empty_cache()
    runs = {}
    for sched in ("hierarchical", "flat"):
        params, opt = _train_init(zoo, ocfg)
        step_fn = make_train_step(zoo, ocfg, device=device, mesh=mesh, dp_mode="manual_hier",
                                  schedule=sched)
        runs[sched] = _train_run(f"cards rank {rank} {sched}", step_fn, params, opt, data,
                                 CARDS_STEPS)
        del params, opt, step_fn
        torch.cuda.empty_cache()
        want = _train_launches(cfg.num_layers, CARDS_STEPS)
        if runs[sched]["launches"] != want:
            raise RuntimeError(f"rank {rank} {sched}: launches {runs[sched]['launches']} "
                               f"differ from {want}")
    if rank == 0:
        for sched, run in runs.items():
            gap = _largest_gap(run["loss"], one["loss"])
            print(f"cards train {sched}: losses {run['loss']} against one card's "
                  f"{one['loss']}, largest relative gap {gap:.3e} (tol {CARDS_LOSS_REL:g}); "
                  f"per-step ms {[round(t, 2) for t in run['step_ms']]} against one card's "
                  f"{[round(t, 2) for t in one['step_ms']]}; max_memory_allocated "
                  f"{run['peak'] / 2**30:.2f} GiB (one card {one['peak'] / 2**30:.2f}) [{smi}]",
                  flush=True)
            if not gap <= CARDS_LOSS_REL:
                raise RuntimeError(f"cards train {sched}: loss gap {gap:.3e}")
    cards_fsdp(rank, world, device, smi, one)


def cards_fsdp(rank: int, world: int, device: str, smi: str, one) -> None:
    """The gspmd_fsdp step on (1, 2, world / 2) ("pod", "data", "model"):
    params and moments sharded (FSDP over "data", TP over "model"), two
    sequences a data rank; against one card's run with the global batch."""
    import torch

    from chip_smoke import _largest_gap, _train_init, _train_launches, _train_run
    from chip_smoke import _train_setup
    from repro_torch.collectives import byte_ledger
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train.train_step import make_train_step

    cfg, zoo, ocfg, data = _train_setup()
    mesh = make_mesh((1, 2, world // 2), ("pod", "data", "model"), device)
    layout = param_layout(zoo, mesh)
    params, opt = _train_init(zoo, ocfg, layout)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    step_fn = make_train_step(zoo, ocfg, device=device, mesh=mesh)
    with byte_ledger() as ledger:
        run = _train_run(f"cards rank {rank} gspmd_fsdp", step_fn, params, opt, data,
                         CARDS_STEPS)
    want = _train_launches(cfg.num_layers, CARDS_STEPS)
    if run["launches"] != want:
        raise RuntimeError(f"rank {rank} gspmd_fsdp: launches {run['launches']} differ from "
                           f"{want}")
    # one more step on every rank, under the profiler on rank 0
    batch = data.batch(CARDS_STEPS)
    if rank == 0:
        prof, host_ms = _profiled(lambda: step_fn(params, opt, batch)[2]["loss"].item())
        _report("cards gspmd_fsdp step (rank 0)", prof, host_ms, unit="step")
    else:
        step_fn(params, opt, batch)[2]["loss"].item()
    if rank == 0:
        by = {}
        for r in ledger.records:
            key = f"{r.op}({','.join(r.axes)})"
            by[key] = by.get(key, 0) + r.nbytes
        gap = _largest_gap(run["loss"], one["loss"])
        print(f"cards train gspmd_fsdp on {dict(zip(mesh.mesh_dim_names, mesh.shape))}: losses "
              f"{run['loss']} against one card's {one['loss']}, largest relative gap "
              f"{gap:.3e} (tol {CARDS_LOSS_REL:g}); grad_norms {run['grad_norm']} against "
              f"{one['grad_norm']}; per-step ms {[round(t, 2) for t in run['step_ms']]} "
              f"against one card's {[round(t, 2) for t in one['step_ms']]}; params + moments "
              f"held {held / 2**30:.2f} GiB a card; max_memory_allocated "
              f"{run['peak'] / 2**30:.2f} GiB (one card {one['peak'] / 2**30:.2f}); collective "
              f"results GB a rank a step "
              f"{({k: round(b / CARDS_STEPS / 1e9, 4) for k, b in by.items()})} [{smi}]",
              flush=True)
        if not gap <= CARDS_LOSS_REL:
            raise RuntimeError(f"cards train gspmd_fsdp: loss gap {gap:.3e}")
    cards_in_turns(rank, world, smi, step_fn, params, opt)


def cards_in_turns(rank: int, world: int, smi: str, fsdp_step, params, opt) -> None:
    """The gspmd_fsdp step on (1, 2, world / 2) and the manual_hier
    ``hierarchical`` step on (2, world / 2, 1), the same global batch, in
    turns: 4 rounds, each step started together on every rank."""
    import statistics

    import torch
    import torch.distributed as dist

    from chip_smoke import _train_init, _train_setup
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import make_train_step

    cfg, zoo, ocfg, data = _train_setup()
    mesh = make_mesh((2, world // 2, 1), ("pod", "data", "model"), "cuda")
    mh_params, mh_opt = _train_init(zoo, ocfg)
    steps = {"gspmd_fsdp": [fsdp_step, params, opt],
             "manual_hier": [make_train_step(zoo, ocfg, device="cuda", mesh=mesh,
                                             dp_mode="manual_hier"), mh_params, mh_opt]}
    state = {"i": 0}

    def timed(name):
        fn, p, o = steps[name]
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, steps[name][2], m = fn(p, o, data.batch(state["i"]))
        m["loss"].item()
        state["i"] += 1
        return (time.perf_counter() - t0) * 1e3

    for name in steps:
        timed(name)  # warm-up
    times = {k: [] for k in steps}
    names = list(steps)
    for r in range(4):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(timed(k))
    if rank == 0:
        for k, ts in times.items():
            print(f"cards in turns {k}: step ms {[round(t, 2) for t in ts]}, median "
                  f"{statistics.median(ts):.2f} [{smi}]", flush=True)


def _cards_rank(rank: int, world: int, port: int, smi: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        cards_collectives(rank, world, "cuda")
        cards_train(rank, world, "cuda", smi)
    finally:
        dist.destroy_process_group()


def dist_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world < 4 or world % 2:
        sys.exit(f"dist_cards needs an even number of cards >= 4, found {world}")
    print(f"dist_cards: {world} ranks, one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_cards_rank, args=(world, free_port(), smi), nprocs=world, join=True,
                       start_method="spawn")


@contextlib.contextmanager
def _moe_labels():
    from torch.profiler import record_function

    from repro_torch.models import moe

    saved = {k: getattr(moe, k) for k in MOE_PARTS}

    def labelled(fn, label):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call

    for k, label in MOE_PARTS.items():
        setattr(moe, k, labelled(saved[k], label))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(moe, k, fn)


def _moe_report(name: str, prof, host_ms: float, per: int = 1, unit: str = "call") -> None:
    """``_report``, then the device time of each MoE part (the kernels its
    forward launched; a backward's are not labelled) and of NCCL's
    kernels, each with its share of all kernel time."""
    _report(name, prof, host_ms, per, unit)
    total, _ = _device_us(prof)
    for label in (*MOE_PARTS.values(), "nccl"):
        if label == "nccl":
            evs = [e for e in prof.events() if e.device_type.name == "CUDA" and "nccl" in e.name]
            us = sum(e.time_range.end - e.time_range.start for e in evs)
        else:
            evs = [e for e in prof.events() if e.name == label and e.device_type.name == "CPU"]
            us = sum(e.device_time_total for e in evs)
        print(f"profile {name}: {label}: {len(evs) / per:g} calls, {us / 1e3 / per:.3f} ms "
              f"device per {unit} ({us / max(total, 1e-9):.1%} of kernel time)", flush=True)


def _moonshot(layers=None):
    """moonshot-v1-16b-a3b at full width in bf16 with flash (its depth cut
    to ``layers``; remat when cut, for training)."""
    import torch

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, attn_impl="flash")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers, remat=True)
    return cfg


def profile_serve_moe(smi: str) -> None:
    """The ``chip_smoke.py`` serve_moe phase: moonshot-v1-16b-a3b at full
    width and depth, one wave of 4 x 1024-token prompts: prefill, cache
    fill and decode steps, with the MoE parts' device time."""
    import numpy as np
    import torch

    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step

    cfg = _moonshot()
    zoo = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    arts = make_serve_step(zoo, device="cuda")
    tokens = torch.as_tensor(np.random.RandomState(0).randint(2, cfg.vocab, (4, 1024)),
                             device="cuda")
    state = {}

    def prefill():
        return arts.prefill_fn(params, {"tokens": tokens})[:, -1].argmax(-1)

    def fill():
        state["cache"] = zoo.init_cache(4, 1024 + STEPS + 1, device="cuda")
        logits, state["cache"] = arts.decode_fn(params, state["cache"], {"tokens": tokens})
        return logits[:, -1].argmax(-1)

    def decode():
        nxt = state["nxt"]
        for _ in range(STEPS):
            logits, state["cache"] = arts.decode_fn(params, state["cache"],
                                                    {"tokens": nxt[:, None]})
            nxt = logits[:, -1].argmax(-1)
            nxt.tolist()
        return nxt

    state["nxt"] = prefill()
    fill()  # warm-up of every path
    decode()
    print(f"profile: {cfg.name} bf16, 4 x 1024-token prompts, {STEPS} decode steps [{smi}]",
          flush=True)
    with _moe_labels():
        for name, fn in (("moe prefill", prefill), ("moe cache_fill", fill),
                         ("moe decode", decode)):
            prof, host_ms = _profiled(fn)
            if name == "moe decode":
                _moe_report(name, prof, host_ms, per=STEPS, unit="step")
            else:
                _moe_report(name, prof, host_ms)


# expert-parallel training on four cards: moonshot's depth cut to 16 layers
# (bf16 params and grads, f32 moments: ~150 GB in all, ~38 GB a card)
MOE_CARDS_LAYERS = 16
# and at train_moe's 4 layers, which one card trains too: the EP steps
# against one card's with as many microbatches as "data" ranks, each
# microbatch a data rank's rows, routed at that rank's capacity (120 on
# (1, 4, 1), 240 on (1, 2, 2), already a multiple of |model|), so the two
# compute the same function; held to CARDS_LOSS_REL
MOE_CHECK_LAYERS = 4


def _a2a_reckoning(cfg, shape, tokens: int) -> tuple:
    """(capacity, bytes of one dispatch result a rank) on ``shape``
    (pod, data, model): a data rank's tokens, capacity rounded up to
    |model|."""
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import _moe_cfg

    tp = shape[2]
    cap = capacity(_moe_cfg(cfg), tokens // (shape[0] * shape[1]))
    cap = -(-cap // tp) * tp
    return cap, cfg.moe.num_experts * cap * cfg.d_model * 2


def _moe_cards_check(rank: int, world: int, device: str, smi: str) -> None:
    """MOE_CHECK_LAYERS-layer EP steps on (1, world, 1) and (1, 2,
    world / 2) against one card's microbatched steps: the losses within
    CARDS_LOSS_REL, and falling."""
    import torch

    from chip_smoke import TRAIN_B, TRAIN_S, TRAIN_STEPS, _largest_gap, _train_init, _train_run
    from chip_smoke import _train_launches
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    cfg = _moonshot(MOE_CHECK_LAYERS)
    zoo = get_model(cfg)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=TRAIN_S, global_batch=TRAIN_B))
    for shape in ((1, world, 1), (1, 2, world // 2)):
        one = None
        if rank == 0:
            params, opt = _train_init(zoo, ocfg)
            step_fn = make_train_step(zoo, ocfg, microbatches=shape[1], device=device)
            one = _train_run(f"moe_cards check one card, {shape[1]} microbatches", step_fn,
                             params, opt, data, TRAIN_STEPS)
            del params, opt, step_fn
            torch.cuda.empty_cache()
        mesh = make_mesh(shape, ("pod", "data", "model"), device)
        params, opt = _train_init(zoo, ocfg, param_layout(zoo, mesh))
        step_fn = make_train_step(zoo, ocfg, device=device, mesh=mesh)
        run = _train_run(f"moe_cards check {shape} rank {rank}", step_fn, params, opt, data,
                         TRAIN_STEPS)
        del params, opt, step_fn
        torch.cuda.empty_cache()
        want = _train_launches(cfg.num_layers, TRAIN_STEPS)
        if run["launches"] != want:
            raise RuntimeError(f"moe_cards check {shape}: launches {run['launches']} differ "
                               f"from {want}")
        if rank == 0:
            gap = _largest_gap(run["loss"], one["loss"])
            print(f"moe_cards check {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
                  f"{cfg.num_layers} layers: losses {run['loss']} against one card's with "
                  f"{shape[1]} microbatches {one['loss']}, largest relative gap {gap:.3e} (tol "
                  f"{CARDS_LOSS_REL:g}); grad_norms {run['grad_norm']} against "
                  f"{one['grad_norm']}; aux {run['aux']} [{smi}]", flush=True)
            if not (gap <= CARDS_LOSS_REL and run["loss"][-1] < run["loss"][0]):
                raise RuntimeError(f"moe_cards check {shape}: loss gap {gap:.3e} or the loss "
                                   f"did not fall: {run['loss']}")


def moe_cards_train(rank: int, world: int, device: str, smi: str) -> None:
    """gspmd_fsdp with EP of moonshot-v1-16b-a3b (16 layers) on
    (1, world, 1) (64 / world experts a card) and on (1, 2, world / 2)
    (F split over "model" too), the global batch of 4 x 1024 tokens:
    8 steps each under the byte ledger (all-to-all bytes a rank a step
    beside the reckoning, peak memory, step time, losses), then one more
    step profiled on rank 0."""
    import torch

    from chip_smoke import TRAIN_B, TRAIN_S, TRAIN_STEPS, _train_init, _train_launches
    from chip_smoke import _train_run
    from repro_torch.collectives import byte_ledger
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    cfg = _moonshot(MOE_CARDS_LAYERS)
    zoo = get_model(cfg)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=TRAIN_S, global_batch=TRAIN_B))
    for shape in ((1, world, 1), (1, 2, world // 2)):
        mesh = make_mesh(shape, ("pod", "data", "model"), device)
        layout = param_layout(zoo, mesh)
        torch.cuda.reset_peak_memory_stats()
        params, opt = _train_init(zoo, ocfg, layout)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        step_fn = make_train_step(zoo, ocfg, device=device, mesh=mesh)
        tag = f"moe_cards train {shape} rank {rank}"
        with byte_ledger() as ledger:
            run = _train_run(tag, step_fn, params, opt, data, TRAIN_STEPS)
        want = _train_launches(cfg.num_layers, TRAIN_STEPS)
        if run["launches"] != want:
            raise RuntimeError(f"{tag}: launches {run['launches']} differ from {want}")
        batch = data.batch(TRAIN_STEPS)
        if rank == 0:
            with _moe_labels():
                prof, host_ms = _profiled(lambda: step_fn(params, opt, batch)[2]["loss"].item())
            _moe_report(f"moe_cards train {shape} step (rank 0)", prof, host_ms, unit="step")
        else:
            step_fn(params, opt, batch)[2]["loss"].item()
        if rank == 0:
            by = {}
            for r in ledger.records:
                key = f"{r.op}({','.join(r.axes)})"
                by[key] = by.get(key, 0) + r.nbytes
            cap, one = _a2a_reckoning(cfg, shape, TRAIN_B * TRAIN_S)
            a2a = ledger.bytes("all_to_all") / TRAIN_STEPS
            reckoned = 6 * cfg.num_layers * one
            print(f"moe_cards train {dict(zip(mesh.mesh_dim_names, mesh.shape))}: losses "
                  f"{run['loss']}, aux {run['aux']}, grad_norms {run['grad_norm']}; per-step ms "
                  f"{[round(t, 2) for t in run['step_ms']]}, steady {run['mean_ms']:.2f} ms; "
                  f"all_to_all {a2a / 1e9:.4f} GB a rank a step against the reckoning "
                  f"{reckoned / 1e9:.4f} (6 a layer x {cfg.num_layers} layers x "
                  f"{cfg.moe.num_experts} x {cap} x {cfg.d_model} x 2 B = {one / 1e6:.2f} MB); "
                  f"params + moments held {held / 2**30:.2f} GiB a card; max_memory_allocated "
                  f"{run['peak'] / 2**30:.2f} GiB; collective results GB a rank a step "
                  f"{({k: round(b / TRAIN_STEPS / 1e9, 4) for k, b in by.items()})} [{smi}]",
                  flush=True)
        del params, opt, step_fn, run
        torch.cuda.empty_cache()


def moe_cards_serve(rank: int, world: int, device: str, smi: str) -> None:
    """Sharded serving of moonshot-v1-16b-a3b at full depth on
    (1, world, 1): EP over "data" (one slot a card), a 1024-token prompt
    each, prefill, the one-call cache fill, then 16 decode steps: step
    latency and memory a card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step

    slots, prompt, steps = 4, 1024, 16
    cfg = _moonshot()
    zoo = get_model(cfg)
    mesh = make_mesh((1, world, 1), ("pod", "data", "model"), device)
    L, Hk, Dh = cfg.num_layers, cfg.kv_heads, cfg.resolved_head_dim
    cache_shape = (L, slots, prompt + steps, Hk, Dh)
    arts = make_serve_step(zoo, device, mesh=mesh,
                           batch_example={"tokens": np.zeros((slots, 1), np.int64)},
                           cache_example={"k": cache_shape, "v": cache_shape, "index": 0})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params = arts.param_layout.shard(zoo.init(gen, device=device))
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cache = arts.cache_layout.shard(zoo.init_cache(slots, prompt + steps, device=device))
    tokens = torch.as_tensor(np.random.RandomState(0).randint(2, cfg.vocab, (slots, prompt)),
                             device=device)

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    pre, pre_ms = timed(lambda: arts.prefill_fn(params, {"tokens": tokens}))
    (fill, cache), fill_ms = timed(lambda: arts.decode_fn(params, cache, {"tokens": tokens}))
    agree = (pre.argmax(-1) == fill.argmax(-1)).float().mean().item()
    nxt = pre[:, -1].argmax(-1)
    del pre, fill
    step_ms = []
    for _ in range(steps):
        (logits, cache), ms = timed(lambda: arts.decode_fn(params, cache,
                                                           {"tokens": nxt[:, None]}))
        nxt = logits[:, -1].argmax(-1)
        nxt.tolist()
        step_ms.append(ms)
    if rank == 0:
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        print(f"moe_cards serve {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {cfg.name} full "
              f"depth, {slots} slots (one a card), {prompt}-token prompts: prefill "
              f"{pre_ms:.2f} ms, cache fill {fill_ms:.2f} ms, prefill-vs-fill argmax agreement "
              f"{agree:.4f}; decode step ms {[round(t, 2) for t in step_ms]}, median of 2-"
              f"{steps} {steady:.2f} ms ({slots * 1e3 / steady:.1f} tokens/s); params held "
              f"{held / 2**30:.2f} GiB a card, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the whole init included) "
              f"[{smi}]", flush=True)
    if not agree > 0.7:
        raise RuntimeError(f"moe_cards serve rank {rank}: prefill and fill agree on {agree}")


def _moe_cards_rank(rank: int, world: int, port: int, smi: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        moe_cards_train(rank, world, "cuda", smi)
        torch.cuda.empty_cache()
        moe_cards_serve(rank, world, "cuda", smi)
        torch.cuda.empty_cache()
        _moe_cards_check(rank, world, "cuda", smi)
    finally:
        dist.destroy_process_group()


def moe_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world != 4:
        sys.exit(f"moe_cards needs 4 cards, found {world}")
    print(f"moe_cards: {world} ranks, one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_moe_cards_rank, args=(world, free_port(), smi), nprocs=world, join=True,
                       start_method="spawn")


def profile_serve(smi: str) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step

    cfg = dataclasses.replace(get_config("llama3.2-3b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, attn_impl="flash")
    zoo = get_model(cfg)
    params = zoo.init(0, device="cuda")
    arts = make_serve_step(zoo, device="cuda")
    tokens = torch.as_tensor(np.random.RandomState(0).randint(2, cfg.vocab, (4, 1024)), device="cuda")

    def prefill():
        return arts.prefill_fn(params, {"tokens": tokens})[:, -1].argmax(-1)

    state = {}

    def fill():
        state["cache"] = zoo.init_cache(4, 1024 + STEPS + 1, device="cuda")
        logits, state["cache"] = arts.decode_fn(params, state["cache"], {"tokens": tokens})
        return logits[:, -1].argmax(-1)

    def decode():
        nxt = state["nxt"]
        for _ in range(STEPS):
            logits, state["cache"] = arts.decode_fn(params, state["cache"], {"tokens": nxt[:, None]})
            nxt = logits[:, -1].argmax(-1)
            nxt.tolist()  # the scheduler reads every step's tokens on the host
        return nxt

    state["nxt"] = prefill()
    fill()  # warm-up of every path
    decode()
    print(f"profile: {cfg.name} bf16, 4 x 1024-token prompts, {STEPS} decode steps [{smi}]")
    for name, fn in (("prefill", prefill), ("cache_fill", fill), ("decode", decode)):
        prof, host_ms = _profiled(fn)
        if name == "decode":
            _report(name, prof, host_ms, per=STEPS, unit="step")
        else:
            _report(name, prof, host_ms)


FILL_STEPS = 32  # token-by-token fill steps profiled (of 256)


def profile_serve_hybrid(smi: str) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step

    cfg = dataclasses.replace(get_config("zamba2-7b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    zoo = get_model(cfg)
    params = zoo.init(0, device="cuda")
    arts = make_serve_step(zoo, device="cuda")
    prompt = 256
    tokens = torch.as_tensor(np.random.RandomState(0).randint(2, cfg.vocab, (4, prompt)),
                             device="cuda")
    state = {"cache": zoo.init_cache(4, prompt + 16, device="cuda")}

    def prefill():
        return arts.prefill_fn(params, {"tokens": tokens})[:, -1].argmax(-1)

    def fill(lo, hi):
        for t in range(lo, hi):
            logits, state["cache"] = arts.decode_fn(params, state["cache"],
                                                    {"tokens": tokens[:, t:t + 1]})
        return logits[:, -1].argmax(-1)

    def decode():
        logits, state["cache"] = arts.decode_fn(params, state["cache"], {"tokens": state["nxt"][:, None]})
        state["nxt"] = logits[:, -1].argmax(-1)
        state["nxt"].tolist()  # the scheduler reads every step's tokens on the host

    prefill()  # warm-up of every path
    fill(0, 2)
    state["cache"] = zoo.init_cache(4, prompt + 16, device="cuda")
    print(f"profile: {cfg.name} bf16, 4 x {prompt}-token prompts [{smi}]")
    prof, host_ms = _profiled(prefill)
    _report("hybrid_prefill", prof, host_ms)
    prof, host_ms = _profiled(lambda: fill(0, FILL_STEPS))
    _report("hybrid_fill", prof, host_ms, per=FILL_STEPS, unit="fill step")
    t0 = time.perf_counter()
    state["nxt"] = fill(FILL_STEPS, prompt)
    torch.cuda.synchronize()
    print(f"profile hybrid_fill: the other {prompt - FILL_STEPS} fill steps unprofiled: "
          f"{(time.perf_counter() - t0) * 1e3 / (prompt - FILL_STEPS):.3f} ms per step")
    prof, host_ms = _profiled(decode)
    _report("hybrid_decode", prof, host_ms, unit="step")


def xlstm_agreement(smi: str) -> None:
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from chip_smoke import _rel, xlstm_layer_walk
    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm.ref import mlstm_step
    from repro_torch.models import ssm
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model

    bf16 = dataclasses.replace(get_config("xlstm-125m"), param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = get_model(bf16).init(gen, device="cuda")
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(np.stack([rng.randint(2, bf16.vocab, 1024) for _ in range(4)]),
                             device="cuda")
    f32 = dataclasses.replace(bf16, param_dtype=torch.float32, compute_dtype=torch.float32)
    p32 = ParamTree.from_state_dict({k: v.float() for k, v in params.state_dict().items()})
    floors = {
        "max(|q.n|, 1) as the model": contextlib.nullcontext,
        "max(|q.n|, exp(-m)) control": lambda: mock.patch.object(
            ssm, "mlstm_step", lambda *a, floor=None: mlstm_step(*a)),
    }
    print(f"xlstm_agreement: {bf16.name}, seed 0, 4 x 1024-token prompts [{smi}]")
    for dname, cfg, p in (("bf16", bf16, params), ("f32", f32, p32)):
        for fname, patch in floors.items():
            with patch():
                rows, a, b = xlstm_layer_walk(get_model(cfg), p, tokens)
            tag = f"xlstm_agreement {dname}, fill divides by {fname}"
            for i, kind, local, stream in rows:
                print(f"{tag}: layer {i:2d} {kind}: local rms/std {local[0]:.3e} max/std "
                      f"{local[1]:.3e}; stream rms/std {stream[0]:.3e}")
            rms, mx = _rel(a, b)
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            print(f"{tag}: last logits rms/std {rms:.4f} max/std {mx:.4f} argmax agreement "
                  f"{agree:.2f}", flush=True)


# Times the flash kernels of the package under ``src/`` of the current
# directory (any checkout of the port that has the backward kernels);
# prints one line of JSON.
_FLASH_TIMING = r"""
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.flash_attention import flash_attention as fa

def graph_ms(fn, iters=20, replays=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return events_ms(graph.replay, replays) / iters

def events_ms(fn, n=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n

g = torch.Generator(device="cuda")
g.manual_seed(0)
q, do = (torch.randn(4, 24, 1024, 128, generator=g, device="cuda").bfloat16() for _ in range(2))
k, v = (torch.randn(4, 8, 1024, 128, generator=g, device="cuda").bfloat16() for _ in range(2))
o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
delta = (o.float() * do.float()).sum(-1).contiguous()
bkw = dict(causal=True, window=None, scale=128 ** -0.5, q_offset=0)
calls = {"flash_fwd": lambda: fa.flash_attention_fwd(q, k, v, causal=True),
         "flash_fwd_lse": lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True),
         "flash_bwd_dq": lambda: fa.bwd_dq(q, k, v, do, lse, delta, **bkw),
         "flash_bwd_dkv": lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **bkw)}
out = {name: {"device_ms": graph_ms(call), "back_to_back_ms": events_ms(call)}
       for name, call in calls.items()}
print(json.dumps(out))
"""


# Times the scans of the package under ``src/`` of the current directory at
# their main paths' shapes (zamba2-7b and xlstm-125m, 4 x 1024 tokens, f32);
# prints one line of JSON.  Uses only the wrappers' public calls.
_SCAN_TIMING = _FLASH_TIMING[:_FLASH_TIMING.index("g = torch.Generator")].replace(
    "from repro_torch.kernels.flash_attention import flash_attention as fa",
    "from repro_torch.kernels.mlstm.mlstm import mlstm_fwd\n"
    "from repro_torch.kernels.ssd.ssd import ssd_fwd") + r"""
g = torch.Generator(device="cuda")
g.manual_seed(0)
r = lambda *s: torch.randn(s, generator=g, device="cuda")
B, S = 4, 1024
ssd_x = (r(B, S, 112, 64), r(B, S, 112).abs() * 0.1 + 0.01, r(B, S, 64), r(B, S, 64),
         -(r(112).abs() + 0.5))
ml_x = (r(B, S, 4, 192) / 192 ** 0.5, r(B, S, 4, 192), r(B, S, 4, 192), r(B, S, 4),
        torch.nn.functional.logsigmoid(r(B, S, 4) + 2))
calls = {"ssd_fwd": lambda: ssd_fwd(*ssd_x, chunk=64), "mlstm_fwd": lambda: mlstm_fwd(*ml_x, chunk=64)}
out = {name: {"device_ms": graph_ms(call), "back_to_back_ms": events_ms(call)}
       for name, call in calls.items()}
print(json.dumps(out))
"""


def _ab(smi: str, other: str, tag: str, what: str, script: str) -> None:
    here = Path(__file__).resolve().parent
    there = (here / other).resolve()
    print(f"{tag}: {what}, {there} against {here} [{smi}]", flush=True)
    for label, path in (("other", there), ("this", here), ("this", here), ("other", there)):
        res = subprocess.run([sys.executable, "-c", script], cwd=path,
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{tag}: the run in {path} failed:\n{res.stderr[-3000:]}")
        print(f"{tag} {label} ({path}): {res.stdout.strip().splitlines()[-1]}", flush=True)


def scan_ab(smi: str, other: str) -> None:
    """The A/B, then this checkout's calls split into their CUDA kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _mlstm_inputs, _ssd_inputs
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.ssd import ssd

    _ab(smi, other, "scan_ab", "ssd_fwd at zamba2-7b (B=4 S=1024 H=112 P=N=64 chunk 64) and "
        "mlstm_fwd at xlstm-125m (B=4 S=1024 H=4 D=192 chunk 64), f32", _SCAN_TIMING)
    xs, xm = _ssd_inputs(4, 1024, 112, 64, 64, seed=0), _mlstm_inputs(4, 1024, 4, 192, seed=0)
    for name, fn in (("ssd_fwd", lambda: ssd.ssd_fwd(*xs, chunk=64)),
                     ("mlstm_fwd", lambda: mlstm.mlstm_fwd(*xm, chunk=64))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for part in PORT_KERNELS:
            spans = [e.time_range.end - e.time_range.start for e in prof.events()
                     if e.device_type.name == "CUDA" and part in e.name]
            if spans:
                print(f"scan_ab this: {name} kernel {part}: {sum(spans) / len(spans):.2f} us a "
                      f"launch (profiler), {len(spans) / 10:g} launches a call", flush=True)


def flash_ab(smi: str, other: str) -> None:
    _ab(smi, other, "flash_ab", "flash_fwd / flash_fwd_lse / flash_bwd_dq / flash_bwd_dkv at "
        "B=4 H=24 Hk=8 S=1024 Dh=128 bf16 causal", _FLASH_TIMING)


# variant name -> (what it takes out, [(pattern, replacement)] applied with
# re.subn to flash_fwd.cu; each pattern must match)
FLASH_ABLATIONS = {
    "no_pingpong": ("the consumers' turns (named barriers) around their products", [
        (r"named_barrier_sync\(my_turn, 256\);", ""),
        (r"if \(c == 1\) named_barrier_arrive\(1, 256\);", ""),
        (r"if \(c == 0 \|\| !last_item\) named_barrier_arrive\(other_turn, 256\);", ""),
        (r"named_barrier_arrive\(other_turn, 256\);", "")]),
    "k_released_with_v": ("K's early release: a stage's K is freed with its V", [
        (r"mbar_arrive\(&k_empty\[st\]\);[^\n]*\n", "\n"),
        (r"if \(lane == 0\) mbar_arrive\(&v_empty\[pst\]\);",
         "if (lane == 0) { mbar_arrive(&v_empty[pst]); mbar_arrive(&k_empty[pst]); }")]),
    "non_persistent": ("the persistent schedule: one block per work item", [
        (r"<<<min\(total, sms\),", "<<<total,")]),
    "branchy_mask": ("the branch-free mask of edge tiles", [
        (r"const bool masked = [^;]*;\s*return [^;]*;",
         "if (key >= p.Skv) return -INFINITY; if (p.causal && key > qpos) return kMasked; "
         "if (p.has_window && key <= qpos - p.window) return kMasked; return s;")]),
    "no_softmax": ("(wrong output) the softmax, P = S", [
        (r"softmax_tile\(p, s,[^;]*;", "alpha[0] = alpha[1] = 1.f;")]),
    "no_kv_loads": ("(wrong output) the K/V loads after the ring's first fill", [
        (r"mbar_arrive_expect_tx\(&(k|v)_full\[st\], L::kKV\);",
         r"mbar_arrive_expect_tx(&\1_full[st], kv < kWgStages ? L::kKV : 0);"),
        (r"for \(int s = 0; s < L::kSlabs; \+\+s\)(\s*tma_load_4d\(s[KV])",
         r"for (int s = 0; s < (kv < kWgStages ? L::kSlabs : 0); ++s)\1")]),
}


# the same for flash_bwd.cu (both kernels live in it)
FLASH_BWD_ABLATIONS = {
    "non_persistent": ("the persistent schedule: one block per work item, in both kernels", [
        (r"<<<min\(total, sms\),", "<<<total,")]),
    "kv_released_together": ("dq's early release of V: a stage's V is freed with its K", [
        (r"mbar_arrive\(&v_empty\[st\]\);[^\n]*\n", "\n"),
        (r"if \(lane == 0\) mbar_arrive\(&k_empty\[st\]\);",
         "if (lane == 0) { mbar_arrive(&v_empty[st]); mbar_arrive(&k_empty[st]); }")]),
    "single_stage": ("every stage of the rings but one (dq's K/V ring, dk/dv's Q/dO ring)", [
        (r"(constexpr int kD(?:q|kv)Stages) = \d;", r"\1 = 1;")]),
    "dkv_two_stages": ("the third stage of dk/dv's ring (dq's ring has two: a third "
                       "would not fit in shared memory)", [
        (r"(constexpr int kDkvStages) = 3;", r"\1 = 2;")]),
}


# the same for the scans: ssd_fwd.cu, then mlstm_fwd.cu
_ONE_PASS = ("(output past the tolerance) 3xTF32: one TF32 pass per product instead of three",
             [(r"\A", "#define TF32_PASSES 1\n")])
_RNA_SPLIT = ("(added) both halves of each operand rounded to nearest (cvt.rna.tf32.f32) "
              "instead of truncated", [(r"\A", "#define TF32_RNA_SPLIT 1\n")])
SSD_ABLATIONS = {
    "one_tf32_pass": _ONE_PASS,
    "rna_split": _RNA_SPLIT,
    "no_g_prepass": ("the C B^T pre-pass: each block forms G itself, once per tile", [
        (r"constexpr bool kGPre = true;", "constexpr bool kGPre = false;")]),
    "p_split_blocks": ("64 columns of P a block (a warp each 16): 32 a block, 896 blocks", [
        (r"constexpr int kWarps = 4;", "constexpr int kWarps = 2;")]),
    "no_prefetch": ("the ring's second stage: tile c + 1's C and B load after tile c", [
        (r"constexpr int kStages = 2;", "constexpr int kStages = 1;")]),
}
MLSTM_ABLATIONS = {
    "one_tf32_pass": _ONE_PASS,
    "rna_split": _RNA_SPLIT,
    "fused_state": ("(added) the chunk states in one serial walk per (64 x 64) slice of the "
                    "state instead of in parallel and then combined", [
        (r"constexpr bool kFuseState = false;", "constexpr bool kFuseState = true;")]),
    "two_stages": ("(added) a second ring stage in the output kernel (each step's loads in "
                   "flight during the one before), at two blocks an SM instead of three", [
        (r"constexpr int kStages = 1;", "constexpr int kStages = 2;")]),
    "dk_64": ("(added) head-dimension steps of 64 instead of 32 in the output kernel", [
        (r"constexpr int kDK = 32;", "constexpr int kDK = 64;")]),
}


def _ablate(smi: str, source: str, ablations: dict, calls: dict, what: str,
            checks: dict = None) -> None:
    """Build ``source`` unmodified and with each of ``ablations``, then time
    each of ``calls`` ({name: fn}) with each build installed, two rounds.
    ``checks`` ({name: fn giving an error}) are read once per build."""
    import ctypes
    import re

    import torch

    from chip_smoke import _graph_ms
    from repro_torch.kernels import build

    tag = "flash_ablate" if "flash" in source else "scan_ablate"
    src = build.KERNELS_DIR / source
    text = src.read_text()
    out_dir = build.BUILD_DIR.parent / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = {"unmodified": text}
    for name, (_, subs) in ablations.items():
        t = text
        for pattern, repl in subs:
            t, n = re.subn(pattern, repl, t)
            if n == 0:
                sys.exit(f"{tag}: {name}: no match for {pattern!r}")
        variants[name] = t
    procs = {}
    for name, t in variants.items():
        stem = f"{src.stem}_{name}"
        (out_dir / f"{stem}.cu").write_text(t)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-I",
               str(build.COMMON_DIR), "-o",
               str(out_dir / f"{stem}.so"), str(out_dir / f"{stem}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{tag}: {name} does not build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{src.stem}_{name}.so"))
    print(f"{tag}: {what}, device ms (CUDA graph of 20 launches), two rounds [{smi}]",
          flush=True)
    times = {(name, c): [] for name in libs for c in calls}
    errs = {}
    try:
        for name, lib in libs.items():
            build._LIBS[source] = lib
            for c, fn in (checks or {}).items():
                errs[name, c] = fn()
        for _ in range(2):
            for name, lib in libs.items():
                build._LIBS[source] = lib  # the wrappers launch this build
                for c, fn in calls.items():
                    times[name, c].append(_graph_ms(fn))
                torch.cuda.synchronize()
    finally:
        build._LIBS.pop(source, None)
    for (name, c), ts in times.items():
        base = sum(times["unmodified", c]) / 2
        what_ = ablations[name][0] if name in ablations else "the kernel as committed"
        err = f", rel err {errs[name, c]:.2e}" if (name, c) in errs else ""
        print(f"{tag} {c} {name}: {ts[0]:.4f} / {ts[1]:.4f} ms, {sum(ts) / 2 / base:.3f}x "
              f"of unmodified{err}; takes out {what_}", flush=True)


def flash_ablate(smi: str) -> None:
    from chip_smoke import _flash_inputs
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v = _flash_inputs(4, 24, 8, 1024, 1024, 128, "bfloat16", seed=0)
    do = _flash_inputs(4, 24, 8, 1024, 1024, 128, "bfloat16", seed=1)[0]
    shape = "B=4 H=24 Hk=8 S=1024 Dh=128 bf16 causal"
    _ablate(smi, fa.SOURCE, FLASH_ABLATIONS,
            {"flash_fwd": lambda: fa.flash_attention_fwd(q, k, v)}, f"flash_fwd at {shape}")
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    delta = (o.float() * do.float()).sum(-1).contiguous()
    bkw = dict(causal=True, window=None, scale=128 ** -0.5, q_offset=0)
    _ablate(smi, fa.BWD_SOURCE, FLASH_BWD_ABLATIONS,
            {"flash_bwd_dq": lambda: fa.bwd_dq(q, k, v, do, lse, delta, **bkw),
             "flash_bwd_dkv": lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **bkw)},
            f"flash_bwd_dq and flash_bwd_dkv at {shape}")


def scan_ablate(smi: str) -> None:
    import torch

    from chip_smoke import _mlstm_inputs, _ssd_inputs
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.mlstm.ref import mlstm_chunked_ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    x = _ssd_inputs(4, 1024, 112, 64, 64, seed=0)
    want = ssd_chunked_ref(*x, 64)[0]
    torch.cuda.synchronize()
    _ablate(smi, ssd.SOURCE, SSD_ABLATIONS, {"ssd_fwd": lambda: ssd.ssd_fwd(*x, chunk=64)},
            "ssd_fwd at zamba2-7b (B=4 S=1024 H=112 P=N=64 chunk 64, f32)",
            {"ssd_fwd": lambda: rel(ssd.ssd_fwd(*x, chunk=64), want)})
    del want
    x = _mlstm_inputs(4, 1024, 4, 192, seed=0)
    want = mlstm_chunked_ref(*x, 64)
    _ablate(smi, mlstm.SOURCE, MLSTM_ABLATIONS,
            {"mlstm_fwd": lambda: mlstm.mlstm_fwd(*x, chunk=64)},
            "mlstm_fwd at xlstm-125m (B=4 S=1024 H=4 D=192 chunk 64, f32)",
            {"mlstm_fwd": lambda: rel(mlstm.mlstm_fwd(*x, chunk=64), want)})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smi = "; ".join(smi.splitlines())  # one line a card
    args = sys.argv[1:] or ["serve", "train"]
    while args:
        name = args.pop(0)
        if name in ("flash_ab", "scan_ab"):
            {"flash_ab": flash_ab, "scan_ab": scan_ab}[name](smi, args.pop(0))
            continue
        {"serve": profile_serve, "train": profile_train, "serve_hybrid": profile_serve_hybrid,
         "train_dist": profile_train_dist, "dist_cards": dist_cards,
         "serve_moe": profile_serve_moe, "moe_cards": moe_cards,
         "xlstm_agreement": xlstm_agreement, "flash_ablate": flash_ablate,
         "scan_ablate": scan_ablate}[name](smi)


if __name__ == "__main__":
    main()
