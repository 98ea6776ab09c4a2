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

* serve_gemma3, serve_vlm, serve_whisper (the ``chip_smoke.py`` phases of
  the same names): gemma3-4b (4 x 2048 tokens, Dh 320), qwen2-vl-2b (4 x
  1024 embeddings at grid positions3) and whisper-large-v3 (4 x 1500
  frames, 4 x 224 tokens) at full size in bf16: prefill, whisper's encode,
  the one-call cache fill and decode steps.

* train_e2e (the ``chip_smoke.py`` train_e2e phase): one railx-100m f32
  step through ``gspmd_fsdp`` on a world of one (2 microbatches, the f32
  flash kernels) after three warm-up steps, then the one-process step split
  as the train target's is.

* train_gemma3 (the ``chip_smoke.py`` train_gemma3 phase): one gemma3-4b
  AdamW step of 2 x 2048 tokens with remat and the flash kernels at Dh 320
  (the backward's mma.sync kernels), after one warm-up step, split as the
  train target's is.

* moe_cards (needs 4 cards, one NCCL rank each; ``--chips 4``):
  ``gspmd_fsdp`` with expert parallelism of moonshot-v1-16b-a3b on
  (1, 4, 1) and (1, 2, 2) ("pod", "data", "model"), global batch 4 x 1024
  tokens, depth cut to 16 layers: 8 steps each under the byte ledger
  (all-to-all bytes a rank a step beside E x C x D x 2 B x 6 a layer, held
  and peak memory, step time, losses) and one profiled step on rank 0;
  then sharded serving at full depth on (1, 4, 1): prefill, fill and 16
  decode steps; last, at 4 layers, 8 EP steps on each shape against one
  card's with as many microbatches as "data" ranks (losses within 1e-2).

* elastic_cards (needs 4 cards, one NCCL rank each; ``--chips 4``): the
  fault drill of ``examples/torch/fault_tolerant_training.py`` (llama3.2-3b
  smoke, ``gspmd_fsdp``) with phase 1 on a (2, 2) ("data", "model") world of
  four cards, then a fresh world of two cards on (1, 2) that restores the
  latest checkpoint with resharding and trains on: the data axis really
  shrinks.  Each step's loss against the same drill on one card (worlds of
  one on (1, 1)), within CARDS_LOSS_REL; the restored step; each phase's
  step times.

* family_cards (needs 4 cards, one NCCL rank each; ``--chips 4``):
  zamba2-7b at all 81 layers in f32 (6.66 B params: params, grads and
  AdamW moments take 106.6 GB, more than a card) under ``gspmd_fsdp`` on
  (1, 4, 1), 4 x 256 tokens a step, 3 steps; its first loss against the
  unsharded forward of the same weights in a one-card process before the
  world starts (rel 1e-4), params + moments held and the peak a card,
  step times, MFU on the leaves.  Then xlstm-125m, whisper-large-v3 and
  qwen2-vl-2b (``chip_smoke.py``'s train cells) tensor-parallel on (1, 2, 2)
  ("pod", "data", "model"), 3 steps each against one card's.

* tp_cards (needs 4 cards, one NCCL rank each; ``--chips 4``): qwen3-8b at
  full size (36 layers, 8.19 B params) in bf16 with remat and the flash
  kernels, ``manual_hier`` with tensor parallelism on "model" on (1, 2, 2)
  ("pod", "data", "model"), ``hierarchical`` then ``flat``, then
  ``gspmd_fsdp`` on the same mesh, 4 x 1024 tokens and 4 steps each: the
  first loss against one card's bf16 forward of the same weights and batch
  (a one-card process before the world starts, rel 1e-2), params + moments
  held and the peak a card beside the dry run's figures for the same cell
  (``launch/dryrun.py`` on a fake world of 4, here, before the world),
  step times, collective bytes by op and axes, the flash kernels' launches
  a step.

* moe_axes_cards (needs 4 cards; ``--chips 4``): moonshot-v1-16b-a3b in
  bf16 with its experts split over "model" (``moe_ep_axis="model"``) on
  (1, 2, 2) at 16 layers, and on a (2, 2) ("pod", "model") mesh without
  "data" (dense over the global batch) at 4 layers; losses, aux, step times
  and all-to-all bytes, and at 4 layers each against one card's steps with
  the same routing (2 microbatches for the EP case), rel 1e-2.

* sp_cards (needs 4 cards; ``--chips 4``): llama3.2-3b uncut (28 layers) in
  bf16 with remat and the flash kernels under sequence parallelism over
  "model" on (1, 1, 4) (``rules_overrides={"heads": None, "kv_heads": None,
  "seq": "model"}``): ``gspmd_fsdp``, then ``manual_hier``, then
  ``gspmd_fsdp`` on the same mesh with the sequence whole (the heads whole
  too), 4 x 1024 tokens and 4 steps each, each card 256 of the 1024
  positions under sequence parallelism; then the two ``gspmd_fsdp`` runs
  again with the plain attention (the reference's default, f32 scores): the
  first loss against one card's bf16 forward (rel 1e-3), the losses across
  the two modes, params + moments held and the peak a card beside the dry
  run's figures for each cell (a fake world of 4, before the world; every
  run's peak within 15 %), each run's peak before its first optimizer step
  and its gradient's bytes, each pair's peaks with whether the cut's is
  lower (required of the plain attention's pair; the flash pair's is
  printed), step times, collective bytes by op and axes, the flash
  launches a step; then sp_family_cards.

* sp_family_cards (needs 4 cards; ``--chips 4``; the second half of
  sp_cards): the hybrid, xLSTM and MoE families under the same overrides
  on (1, 1, 4), each against the same mesh with the sequence whole
  (``{"heads": None, "kv_heads": None}``), 3 steps a run, bf16, remat:
  zamba2-7b at full width and 12 layers, 4 x 1024, both modes (its Mamba2
  layers split over "model", 28 of the 112 heads a card; its shared
  block's attention plain, head dim 112); xlstm-125m uncut, 4 x 256, both
  modes (its blocks whole on every card); moonshot-v1-16b-a3b at 4 layers,
  4 x 1024, ``gspmd_fsdp``, its experts over "model" (16 a card) and flash
  attention.  The first loss of each cut run against the whole run's (rel
  1e-3), step times, params + moments held and the peak a card both ways,
  the kernels' launches a step, bytes by op and axes.  Then zamba2-7b at
  81 layers, bf16: the sharded prefill of one row of 8,192 tokens cut and
  whole (the logits' rms difference over the whole's rms, <= 0.05; argmax
  agreement), and of 16,384 cut (the whole's plain f32 scores would need 3
  x 34 GB), held and peak GiB, ms, ``ssd_fwd`` launches a prefill; then
  ``ssd_fwd`` and ``mlstm_fwd`` timed at a card's shapes.

* flow (the ``chip_smoke.py`` flow phase's reach): the network core's
  exact all-to-all sweep of RailX 64 m 2 (16,384 chips, batches of 1,024
  sources) and its symmetry sweep of RailX 160 m 2 (102,400 chips), each
  after a warm-up: host time, kernel time, the device's busy share and the
  four flow kernels' launches and time (``kernels/flow/csrc/flow.cu``).

* pipe_cards (needs 4 cards; ``--chips 4``): ``parallel/pipeline.py`` on a
  (4,) "pipe" ring of NCCL ranks: the reference's test (4 stages x 6
  microbatches, x * 24 within 1e-4), then a llama3.2-3b layer a stage over
  6 microbatches of 1 x 1024 tokens against the layers in turn on one card.

And an A/B of the flash-attention kernels against another checkout:

* flash_ab DIR: ``flash_fwd`` and ``flash_fwd_lse`` at the serving prefill
  shape (B=4, H=24, Hk=8, S=1024, Dh=128, bf16, causal), and the backward
  kernels ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the same (training)
  shape; then gemma3-4b's Dh-320 shapes in the model's layout (H=8, Hk=4,
  S=2048, global and local layers): ``flash_fwd`` at the prefill's B=4,
  ``flash_fwd_lse`` and the backward kernels at the training shape's B=2;
  in f32 (the 3xTF32 kernels), all four at Dh 320 at a small shape and at
  gemma3-4b's head geometry (B=1, S=2048), and the forward with lse and the
  backward at llama3.2-3b's training shape.  Timed in the package of
  the checkout at DIR (say, the parent commit unpacked with ``git
  archive``) and in this one, in turns (DIR, this, this, DIR), each run in
  a fresh process that builds that checkout's kernels: device time (a CUDA
  graph of 20 launches) and 20 back-to-back wrapper calls timed with
  events; last, each call's two device times on each side and DIR / this.

* flash_ablate: what each part of the TMA / wgmma kernels' design, and of
  the f32 (3xTF32) kernels', is worth.  Variants of ``flash_fwd.cu`` and of
  ``flash_bwd.cu``, each with one part taken out (or, marked so, added) by a
  text substitution, are built beside the unmodified sources and timed at
  the serving prefill / training shape and at gemma3-4b's Dh-320 ones, the
  f32 forward at two Dh-320 shapes and the f32 backward at those and at
  llama3.2-3b's training shape (device time, CUDA graph), in two rounds,
  each build's error at a ragged Dh-320 case printed beside.  The
  forward variants that drop work (the softmax, the K/V loads) give wrong
  outputs, and one TF32 pass an f32 output past its tolerance: they only
  measure what that work costs.

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

The same for the flow kernels:

* flow_ab DIR: the network core's flow path in the checkout at DIR and in
  this one, each run a fresh process, in turns (DIR, this, this, DIR, DIR,
  this): the 16,384-chip exact sweep (RailX 64 m 2, batches of 1,024) timed
  on the host, then under the profiler (kernel ms, busy share, the flow
  kernels' ms and the rest, "glue"; host syncs a level from the CUDA
  runtime's synchronize calls; peak memory above the network's), the
  102,400-chip symmetry sweep (RailX 160 m 2) on the host and its orbit
  kernel's ms under the profiler, the ``orbit_gather`` and ``ordered_fold``
  wrappers alone in a CUDA graph of 20 calls on the inputs the sweep and
  RailX 8's ECMP pass give them (each tree its own kernels), and one
  goodput miss at max_flow_nodes 512 (wall ms, BFS levels, forests); the
  medians of the three runs a side
  and DIR / this.  The counts, the symmetry counts and the goodput must
  agree across all runs.

* dadd_chain: the latency of one dependent f64 add (``__dadd_rn``) on the
  card, from a one-thread chain kernel timed at two lengths (the difference
  over the difference of adds, so the launch cancels): the serial floor of
  ``flow_ordered_fold``, whose runs are such chains (``chip_smoke.py``
  keeps it as ``DADD_NS`` and multiplies it by the longest run).

* flow_ablate DIR: the subtree fold over every call of the scale-32 exact
  sweep in batches of 256 (chip_smoke.py's timed shape) in one CUDA graph:
  PR 29's scatter fold of DIR's ``flow.cu`` as it is and with its K[e]
  atomics, its cnt[parent] atomics or both made plain read-modify-writes
  (called through its own C signature), then this checkout's level-ordered
  fold as it is and with its one atomic made plain; with each level's
  sibling runs and each build's error against the plain fold.

And the optimizer:

* adamw: ``kernels/adamw`` at the benchmark cells' tables (moonshot-v1-16b-a3b
  at 4 layers, portbench/configs: 16 leaves, 3.02 B bf16 params, f32
  moments; bf16 gradients as in moe-train-1k, f32 ones as in moe-train-8k):
  ``optimizer.apply`` on the card (the norm, its root, the update), each
  kernel alone, and the plain chunked code on the same tensors, timed with
  CUDA events, beside the byte bound (each byte of g read twice, of p, mu
  and nu read and written once, at 3.35 TB/s); then ``apply`` under
  ``portbench/trace.py``'s label and profiler (the label's device time
  against the kernels'); last, as a library yardstick the port never
  calls, ``torch.optim.AdamW(fused=True)`` with ``clip_grad_norm_(foreach=
  True)`` on as many f32 params (it takes one dtype for params, gradients
  and moments).

And one look at numbers rather than time:

* xlstm_agreement: why xlstm-125m's bf16 prefill and cache fill agree less
  than llama's or zamba2's.  The ``chip_smoke.py`` serve_xlstm weights (seed
  0) and prompts walked layer by layer (``chip_smoke.xlstm_layer_walk``) in
  bf16 and, with the same weights, in f32; each as the model is (the
  recurrent form divides by max(|q.n|, 1)) and with the recurrent form
  dividing by max(|q.n|, exp(-m)), as the chunkwise form does (a control;
  the model keeps the reference's normaliser).

    python3 chip_profile.py [serve] [train] [serve_hybrid] [train_dist] [dist_cards]
                            [serve_moe] [moe_cards] [elastic_cards] [family_cards]
                            [pipe_cards] [tp_cards] [moe_axes_cards] [sp_cards]
                            [sp_family_cards]
                            [serve_gemma3] [serve_vlm]
                            [serve_whisper] [train_gemma3] [train_e2e]
                            [xlstm_agreement] [flash_ab DIR]
                            [flash_ablate] [scan_ab DIR] [scan_ablate]
                            [flow] [flow_ab DIR] [flow_ablate DIR] [dadd_chain]
                            [adamw]
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
                "mlstm_state_kernel", "mlstm_combine_kernel", "mlstm_out_kernel",
                "bfs_top_down_kernel", "bfs_claim_kernel", "bfs_claim_dense_kernel",
                "bfs_bottom_up_kernel", "bfs_tile_sums_kernel", "bfs_scan_tiles_kernel",
                "bfs_emit_kernel", "subtree_sum_kernel", "orbit_kernel", "fold_kernel")


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


def profile_flow(smi: str) -> None:
    import torch

    from repro_torch.core import compiled_flow as cf
    from repro_torch.kernels.flow import flow

    cn = cf.build_compiled_railx_hyperx(64, 2, 2.0)
    cf.alltoall_edge_counts(cn, cn.chips()[:1024])  # builds the kernels and reverse tables
    flow.reset_launch_counts()
    prof, host_ms = _profiled(lambda: cf.alltoall_edge_counts(cn))
    print(f"profile flow exact: RailX 64 m 2, {cn.num_vertices} chips, {cn.num_edges} edges, "
          f"launches {flow.launch_counts()} [{smi}]", flush=True)
    _report("flow exact (16,384 chips)", prof, host_ms, unit="sweep")
    del cn
    torch.cuda.empty_cache()
    cn = cf.build_compiled_railx_hyperx(160, 2, 2.0)
    cf.symmetric_alltoall_counts(cn)
    flow.reset_launch_counts()
    prof, host_ms = _profiled(lambda: cf.symmetric_alltoall_counts(cn))
    print(f"profile flow symmetry: RailX 160 m 2, {cn.num_vertices} chips, {cn.num_edges} "
          f"edges, launches {flow.launch_counts()} [{smi}]", flush=True)
    _report("flow symmetry (102,400 chips)", prof, host_ms, unit="sweep")


def profile_train(smi: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_config("llama3.2-3b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, remat=True, attn_impl="flash")
    zoo = get_model(cfg)
    params = zoo.init(0, device="cuda")
    params.requires_grad_(True)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=1024, global_batch=4))
    print(f"profile: {cfg.name} bf16 train step, 4 x 1024 tokens, remat, flash [{smi}]")
    _profile_train_step(zoo, ocfg, params, opt_lib.init(ocfg, params), data.batches(0))


def profile_train_gemma3(smi: str) -> None:
    """The ``chip_smoke.py`` train_gemma3 step: gemma3-4b at full size, 2 x
    2048 tokens, remat, the flash kernels at Dh 320."""
    from chip_smoke import _train_init, family_train_setup

    cfg, zoo, ocfg, data, micro = family_train_setup("gemma3-4b")
    params, opt = _train_init(zoo, ocfg)
    print(f"profile: {cfg.name} bf16 train step, {data.B} x {data.S} tokens, remat, flash "
          f"[{smi}]")
    _profile_train_step(zoo, ocfg, params, opt, data.batches(0), micro)


def profile_train_e2e(smi: str) -> None:
    """The ``chip_smoke.py`` train_e2e step: railx-100m in f32 with the
    flash kernels, ``gspmd_fsdp`` with 2 microbatches on a world of one,
    16 x 128 tokens (drawn from a 4096-token corpus: the table of the
    model's 16384 takes a minute to build, and a step's work does not depend
    on the ids); one step after three warm-up steps, then the one-process
    step's halves (``_profile_train_step``)."""
    import torch

    from chip_smoke import _world_of_one, example
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(example("train_end_to_end").railx_config(), attn_impl="flash")
    zoo = get_model(cfg)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=300, weight_decay=0.01)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=128, global_batch=16))
    print(f"profile: {cfg.name} f32 train step, 16 x 128 tokens in 2 microbatches, flash, "
          f"gspmd_fsdp on a world of one [{smi}]", flush=True)
    with _world_of_one() as mesh:
        layout = param_layout(zoo, mesh)
        params = layout.shard(zoo.init(0, device="cuda"))
        params.requires_grad_(True)
        step_fn = make_train_step(zoo, ocfg, microbatches=2, device="cuda", mesh=mesh,
                                  dp_mode="gspmd_fsdp")
        state = {"opt": opt_lib.init(ocfg, params)}
        batches = data.batches(0)

        def step():
            _, state["opt"], m = step_fn(params, state["opt"], next(batches))
            m["loss"].item()

        for _ in range(3):
            step()
        prof, host_ms = _profiled(step)
        _report("train_e2e step (gspmd_fsdp)", prof, host_ms, unit="step")
    params = zoo.init(0, device="cuda")
    params.requires_grad_(True)
    _profile_train_step(zoo, ocfg, params, opt_lib.init(ocfg, params), data.batches(0), 2)
    torch.cuda.empty_cache()


def _profile_train_step(zoo, ocfg, params, opt, batches, microbatches: int = 1) -> None:
    """One AdamW step after one warm-up step, then the same step in two
    halves: forward + backward, then the optimizer."""
    import torch

    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step, to_device

    step_fn = make_train_step(zoo, ocfg, microbatches=microbatches, device="cuda")
    state = {"opt": opt}

    def step():
        _, state["opt"], m = step_fn(params, state["opt"], next(batches))
        m["loss"].item()

    step()  # warm-up of every path
    prof, host_ms = _profiled(step)
    _report("train_step", prof, host_ms, unit="step")

    batch = to_device(next(batches), torch.device("cuda"))
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


def _elastic_rank(rank: int, world: int, port: int, ckpt_dir: str, phase: str, shape: tuple,
                  tag: str) -> None:
    """One rank of a drill phase on ``shape`` ("data", "model"), one card a
    rank; rank 0 writes the phase's per-step losses and step times."""
    import datetime
    import json

    import torch
    import torch.distributed as dist

    from chip_smoke import example
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        ft = example("fault_tolerant_training")
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        log = (lambda line: print(f"elastic_cards {tag} phase {phase}: {line}", flush=True)) \
            if rank == 0 else (lambda line: None)
        if phase == "1":
            start, res = 0, ft.phase1(mesh, "cuda", ckpt_dir, log_fn=log, log_every=1)
        else:
            start, res = ft.phase2(mesh, "cuda", ckpt_dir, log_fn=log, log_every=1)
        if rank == 0:
            with open(f"{ckpt_dir}/elastic_{phase}.json", "w") as f:
                json.dump({"start": start, "loss": [h["loss"] for h in res.history],
                           "step_ms": [1e3 * h["step_time_s"] for h in res.history]}, f)
    finally:
        dist.destroy_process_group()


def elastic_cards(smi: str) -> None:
    import json
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world < 4:
        sys.exit(f"elastic_cards needs 4 cards, found {world}")
    print(f"elastic_cards: the drill on (2, 2) over 4 cards, then (1, 2) over 2; against "
          f"(1, 1) on one card [{smi}]", flush=True)
    runs = {}
    for tag, shapes in (("one card", ((1, 1), (1, 1))), ("cards", ((2, 2), (1, 2)))):
        with tempfile.TemporaryDirectory() as ckpt:
            for phase, shape in zip(("1", "2"), shapes):
                n = shape[0] * shape[1]
                mp.start_processes(_elastic_rank, args=(n, free_port(), ckpt, phase, shape, tag),
                                   nprocs=n, join=True, start_method="spawn")
                with open(f"{ckpt}/elastic_{phase}.json") as f:
                    runs[tag, phase] = json.load(f)
    for phase, shape in (("1", (2, 2)), ("2", (1, 2))):
        got, want = runs["cards", phase], runs["one card", phase]
        gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
        print(f"elastic_cards phase {phase} on {shape} ({shape[0] * shape[1]} cards), restored "
              f"step {got['start']} (one card {want['start']}): losses {got['loss']} against "
              f"one card's {want['loss']}, largest relative gap {gap:.3e} (tol "
              f"{CARDS_LOSS_REL:g}); step ms {[round(t, 2) for t in got['step_ms']]} against "
              f"one card's {[round(t, 2) for t in want['step_ms']]} [{smi}]", flush=True)
        if not (gap <= CARDS_LOSS_REL and got["start"] == want["start"]
                and len(got["loss"]) == len(want["loss"])):
            raise RuntimeError(f"elastic_cards phase {phase}: loss gap {gap:.3e} or the restored "
                               f"step differs")


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


# gemma3-4b, qwen2-vl-2b and whisper-large-v3 at chip_smoke.py's serve
# shapes: prompt length, and whisper's encoder frames
FAMILY_PROMPTS = {"gemma3-4b": 2048, "qwen2-vl-2b": 1024, "whisper-large-v3": 224}
WHISPER_FRAMES = 1500


def profile_serve_family(smi: str, arch: str) -> None:
    """Where the time of one wave of 4 goes for gemma3-4b, qwen2-vl-2b or
    whisper-large-v3 at full size, bf16, flash: the prefill, whisper's
    encode, the one-call cache fill and STEPS decode steps, each profiled
    after a warm-up of every path.  vlm prompts are embeddings at a 32 x 32
    patch grid's positions3, decoded tokens at 32 + step."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step

    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, attn_impl="flash")
    zoo = get_model(cfg)
    params = zoo.init(0, device="cuda")
    arts = make_serve_step(zoo, device="cuda")
    P, B = FAMILY_PROMPTS[arch], 4
    rng = np.random.RandomState(0)
    prompt = {"tokens": torch.as_tensor(rng.randint(2, cfg.vocab, (B, P)), device="cuda")}
    extra = {}
    if cfg.family == "vlm":
        i = torch.arange(P, device="cuda")
        grid = torch.stack([torch.zeros_like(i), i // 32, i % 32])
        prompt = {"embeds": torch.randn((B, P, cfg.d_model), device="cuda"),
                  "positions3": grid[:, None].expand(3, B, P).contiguous()}
    if cfg.family == "whisper":
        extra = {"enc_embeds": torch.randn((B, WHISPER_FRAMES, cfg.d_model), device="cuda")}
    state = {}

    def step_inputs(s: int) -> dict:
        if cfg.family != "vlm":
            return {}
        return {"positions3": torch.full((3, B, 1), 32 + s, dtype=torch.long, device="cuda")}

    def prefill():
        return arts.prefill_fn(params, {**prompt, **extra})[:, -1].argmax(-1)

    def encode():
        state["enc_out"] = arts.encode_fn(params, extra["enc_embeds"])

    def fill():
        state["cache"] = zoo.init_cache(B, P + STEPS + 1, device="cuda")
        if "enc_out" in state:
            state["cache"]["enc_out"] = state["enc_out"]
        logits, state["cache"] = arts.decode_fn(params, state["cache"], prompt)
        return logits[:, -1].argmax(-1)

    def decode():
        nxt = state["nxt"]
        for s in range(STEPS):
            logits, state["cache"] = arts.decode_fn(
                params, state["cache"], {"tokens": nxt[:, None], **step_inputs(s)})
            nxt = logits[:, -1].argmax(-1)
            nxt.tolist()  # the scheduler reads every step's tokens on the host
        return nxt

    parts = [("prefill", prefill)] + ([("encode", encode)] if extra else []) + [
        ("cache_fill", fill), ("decode", decode)]
    state["nxt"] = prefill()
    for _, fn in parts[1:]:  # warm-up of every path
        fn()
    print(f"profile: {cfg.name} bf16, 4 x {P}-position prompts"
          f"{f', {WHISPER_FRAMES} encoder frames' if extra else ''}, {STEPS} decode steps "
          f"[{smi}]")
    for name, fn in parts:
        prof, host_ms = _profiled(fn)
        if name == "decode":
            _report(f"{arch} {name}", prof, host_ms, per=STEPS, unit="step")
        else:
            _report(f"{arch} {name}", prof, host_ms)


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

def inputs(B, H, Hk, S, Dh, dtype=torch.bfloat16, layout="kernel", seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    def randn(h):
        if layout == "model":  # transposed views of (B, S, H, Dh)
            return torch.randn(B, S, h, Dh, generator=g, device="cuda").to(dtype).transpose(1, 2)
        return torch.randn(B, h, S, Dh, generator=g, device="cuda").to(dtype)
    return randn(H), randn(Hk), randn(Hk), randn(H)

calls = {}
def add(tag, B, H, Hk, S, Dh, window, names, dtype=torch.bfloat16, layout="kernel"):
    q, k, v, do = inputs(B, H, Hk, S, Dh, dtype, layout)
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1).contiguous()
    bkw = dict(causal=True, window=window, scale=Dh ** -0.5, q_offset=0)
    fns = {"flash_fwd": lambda: fa.flash_attention_fwd(q, k, v, **kw),
           "flash_fwd_lse": lambda: fa.flash_attention_fwd_lse(q, k, v, **kw),
           "flash_bwd_dq": lambda: fa.bwd_dq(q, k, v, do, lse, delta, **bkw),
           "flash_bwd_dkv": lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **bkw)}
    for name in names:
        calls[name + tag] = fns[name]

ALL = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
add("", 4, 24, 8, 1024, 128, None, ALL)
for tag, window in (("global", None), ("local", 1024)):
    add("_d320_prefill_" + tag, 4, 8, 4, 2048, 320, window, ALL[:1], layout="model")
    add("_d320_train_" + tag, 2, 8, 4, 2048, 320, window, ALL[1:], layout="model")
add("_d320_f32", 1, 4, 2, 333, 320, None, ALL, dtype=torch.float32)
add("_d320_f32_2048", 1, 8, 4, 2048, 320, None, ALL, dtype=torch.float32)
add("_llama_f32", 4, 24, 8, 1024, 128, None, ALL[1:], dtype=torch.float32, layout="model")
out = {name: {"device_ms": graph_ms(call), "back_to_back_ms": events_ms(call)}
       for name, call in calls.items()}
print(json.dumps(out))
"""


# Times the scans of the package under ``src/`` of the current directory at
# their main paths' shapes (zamba2-7b and xlstm-125m, 4 x 1024 tokens, f32);
# prints one line of JSON.  Uses only the wrappers' public calls.
_SCAN_TIMING = _FLASH_TIMING[:_FLASH_TIMING.index("def inputs(")].replace(
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
    """Run ``script`` in the checkout at ``other`` and in this one in turns
    (other, this, this, other), then print each call's device times and
    other / this, the speedup of this checkout."""
    import json

    here = Path(__file__).resolve().parent
    there = (here / other).resolve()
    print(f"{tag}: {what}, {there} against {here} [{smi}]", flush=True)
    runs = {"other": [], "this": []}
    for label, path in (("other", there), ("this", here), ("this", here), ("other", there)):
        res = subprocess.run([sys.executable, "-c", script], cwd=path,
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{tag}: the run in {path} failed:\n{res.stderr[-3000:]}")
        line = res.stdout.strip().splitlines()[-1]
        print(f"{tag} {label} ({path}): {line}", flush=True)
        runs[label].append(json.loads(line))
    for name in runs["this"][0]:
        o, t = ([r[name]["device_ms"] for r in runs[k]] for k in ("other", "this"))
        print(f"{tag} {name}: other {o[0]:.4f} / {o[1]:.4f} ms, this {t[0]:.4f} / {t[1]:.4f} ms "
              f"device, other/this {sum(o) / sum(t):.3f}", flush=True)


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
        "B=4 H=24 Hk=8 S=1024 Dh=128 bf16 causal; gemma3-4b at Dh 320 (H=8 Hk=4 S=2048 bf16 "
        "causal, model layout, global and local = window 1024): flash_fwd at the prefill's "
        "B=4 (_d320_prefill_*), flash_fwd_lse, flash_bwd_dq and flash_bwd_dkv at the training "
        "shape's B=2 (_d320_train_*); f32: the four at Dh=320, B=1 H=4 Hk=2 S=333 (_d320_f32) "
        "and B=1 H=8 Hk=4 S=2048 (_d320_f32_2048), flash_fwd_lse, flash_bwd_dq and "
        "flash_bwd_dkv at llama3.2-3b's training shape (B=4 H=24 Hk=8 S=1024 Dh=128, model "
        "layout, _llama_f32)",
        _FLASH_TIMING)


# the f32 kernels' precision ablation (flash_fwd.cu, ssd_fwd.cu, mlstm_fwd.cu)
_ONE_PASS = ("(output past the tolerance) 3xTF32: one TF32 pass per product instead of three",
             [(r"\A", "#define TF32_PASSES 1\n")])


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
        (r"softmax_tile<BN>\(p, s,[^;]*;", "alpha[0] = alpha[1] = 1.f;")]),
    "no_kv_loads": ("(wrong output) the K/V loads after the ring's first fill", [
        (r"mbar_arrive_expect_tx\(&(k|v)_full\[st\], L::kKV\);",
         r"mbar_arrive_expect_tx(&\1_full[st], kv < kWgStages ? L::kKV : 0);"),
        (r"for \(int s = 0; s < L::kSlabs; \+\+s\)(\s*tma_load_4d\(s[KV])",
         r"for (int s = 0; s < (kv < kWgStages ? L::kSlabs : 0); ++s)\1")]),
    # Dh 320 only (the Dh-64/128 instantiations are unchanged by it)
    "d320_rescale_skip": ("(added) at Dh 320, O's rescale skipped by a warp whose rows' "
                          "maxima all stayed put", [
        (r"(void rescale_o\(float \(&acc\)\[D / 2\], const float \(&alpha\)\[2\]\) \{)",
         r"\1\n  if (D > 128 && !__any_sync(0xffffffffu, (alpha[0] != 1.f) | (alpha[1] != 1.f))) "
         r"return;")]),
    # f32 only
    "one_tf32_pass": _ONE_PASS,
    "f32_one_split": ("the f32 kernel's key split: a block walks all its keys, no combine", [
        (r"p\.chunk = chunk;", "p.chunk = chunk > 0 ? (Skv + kTfChunk - 1) / kTfChunk * kTfChunk : 0;")]),
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
    "dq_one_consumer": ("dq's split of an item's key tiles at Dh 320: consumer 0 walks them "
                        "all, consumer 1 passes zeros", [
        (r"\(g & 1\) == c;", "c == 0;")]),
    # f32 only
    "one_tf32_pass": _ONE_PASS,
    "f32_one_split": ("the f32 kernels' splits across blocks: dq's blocks walk all their keys, "
                      "dk/dv's all their rows and heads, no combine", [
        (r"p\.chunk = chunk;",
         "p.chunk = chunk > 0 ? (split_extent + kTfChunk - 1) / kTfChunk * kTfChunk : 0;"),
        (r"p\.head_splits = head_splits;", "p.head_splits = 1;")]),
    "f32_exact_exp2": ("the f32 kernels' ex2.approx for P: exp2f, which also handles "
                       "subnormal results", [
        (r"hopper::exp2_approx\(fmaf\(s\[t\]\[e\], sl2, nl2", "exp2f(fmaf(s[t][e], sl2, nl2"),
        (r"\? hopper::exp2_approx\(nl2\)", "? exp2f(nl2)")]),
    "f32_kstep_sums": ("(added) the f32 kernels' products into dQ, dK and dV summed one "
                       "8-key (8-row) k step at a time in the tensor cores, not one step's", [
        (r"  tf32::AFrag a\[NT\];\n#pragma unroll\n  for \(int t = 0; t < NT; \+\+t\) "
         r"a\[t\] = tf32::a_frag\(f\[t\]\[0\], f\[t\]\[2\], f\[t\]\[1\], f\[t\]\[3\]\);\n"
         r"#pragma unroll\n  for \(int n = 0; n < NN; \+\+n\) \{\n    float d\[4\] = "
         r"\{0.f, 0.f, 0.f, 0.f\};\n#pragma unroll\n    for \(int t = 0; t < NT; \+\+t\) \{",
         "#pragma unroll\n  for (int t = 0; t < NT; ++t) {\n    const tf32::AFrag at = "
         "tf32::a_frag(f[t][0], f[t][2], f[t][1], f[t][3]);\n#pragma unroll\n    for (int n = 0; "
         "n < NN; ++n) {\n      float d[4] = {0.f, 0.f, 0.f, 0.f};"),
        (r"      tf32::mma\(d, a\[t\], tf32::b_frag\(zb\[0\], zb\[4 \* LD\]\)\);\n    \}\n"
         r"#pragma unroll\n    for \(int e = 0; e < 4; \+\+e\) acc\[n\]\[e\] \+= d\[e\];\n  \}",
         "      tf32::mma(d, at, tf32::b_frag(zb[0], zb[4 * LD]));\n#pragma unroll\n      "
         "for (int e = 0; e < 4; ++e) acc[n][e] += d[e];\n    }\n  }")]),
    "d320_dkv_one_warp_an_output": ("f32 dk/dv's column split at Dh 320: one warp holds all "
                                    "320 columns of dV (or of dK) of its 16 keys, 4 warps a "
                                    "block of 32 keys", [
        (r"static constexpr int kCols = D > 128 \? 2 : 1;", "static constexpr int kCols = 1;")]),
}


# the same for the scans: ssd_fwd.cu, then mlstm_fwd.cu
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


# PR 29's subtree fold (``subtree_kernel`` of the flow.cu in the checkout at
# DIR: one thread a key, one int64 atomicAdd into its parent edge's total K[e]
# and one into its parent's count) with its atomics made plain read-modify-
# writes (racy: the counts go wrong, the time is what the atomics cost)
_K_PLAIN = (r"atomicAdd\(&K\[e\], w\);", "K[e] += w;")
SCATTER_ABLATIONS = {
    "K_plain": ("the K[e] atomics (plain read-modify-writes)", [_K_PLAIN]),
    "cnt_plain": ("the cnt[parent] atomics (plain read-modify-writes)", [
        (r"atomicAdd\(&cnt\[key - key % n \+ edge_src\[e\]\], w\);",
         "cnt[key - key % n + edge_src[e]] += w;")]),
}
SCATTER_ABLATIONS["both_plain"] = (
    "both atomics (plain read-modify-writes)",
    SCATTER_ABLATIONS["K_plain"][1] + SCATTER_ABLATIONS["cnt_plain"][1])


def _ablate(smi: str, source: str, ablations: dict, calls: dict, what: str,
            checks: dict = None) -> None:
    """Build ``source`` unmodified and with each of ``ablations``, then time
    each of ``calls`` ({name: fn}) with each build installed, two rounds.
    ``checks`` ({name: fn giving an error}) are read once per build."""
    import ctypes
    import hashlib
    import re

    import torch

    from chip_smoke import _graph_ms
    from repro_torch.kernels import build

    tag = ("flash_ablate" if "flash" in source else "flow_ablate" if "flow" in source
           else "scan_ablate")
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
    where = hashlib.sha1(str(src).encode()).hexdigest()[:8]  # two checkouts' sources apart
    for name, t in variants.items():
        stem = f"{src.stem}_{where}_{name}"
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
        libs[name] = ctypes.CDLL(str(out_dir / f"{src.stem}_{where}_{name}.so"))
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
    for (name, c), err in errs.items():
        if c not in calls:  # a check of a case that is not timed
            print(f"{tag} {c} {name}: rel err {err:.2e}", flush=True)


def flash_ablate(smi: str) -> None:
    """The ablations at the serving prefill / training shape (Dh 128) and at
    gemma3-4b's Dh-320 prefill (B 4) and training (B 2) shapes, global and
    local layers, and of the f32 kernels: the forward at its two Dh-320
    shapes, the backward at those and at llama3.2-3b's training shape; with
    each build's error against the plain version at a ragged Dh-320 case, in
    bf16 and in f32 (the variants marked "wrong output" aside)."""
    from chip_smoke import _flash_inputs
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    def rel(got, want):
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    def bwd_inputs(B, H, Hk, S, Dh, window, layout, dtype="bfloat16"):
        q, k, v = _flash_inputs(B, H, Hk, S, S, Dh, dtype, seed=0, layout=layout)
        do = _flash_inputs(B, H, Hk, S, S, Dh, dtype, seed=1, layout=layout)[0]
        o, lse = fa.flash_attention_fwd_lse(q, k, v, window=window)
        return q, k, v, do, o, lse, (o.float() * do.float()).sum(-1).contiguous()

    q, k, v = _flash_inputs(4, 24, 8, 1024, 1024, 128, "bfloat16", seed=0)
    pre = {w: _flash_inputs(4, 8, 4, 2048, 2048, 320, "bfloat16", seed=0, layout="model")
           for w in ("global", "local")}
    win = {"global": None, "local": 1024}
    qr, kr, vr = _flash_inputs(2, 4, 2, 333, 333, 320, "bfloat16", seed=2)
    # the f32 forward (3xTF32) at a ragged shape and at gemma3-4b's head geometry
    f32 = {"": _flash_inputs(1, 4, 2, 333, 333, 320, "float32", seed=3),
           "_2048": _flash_inputs(1, 8, 4, 2048, 2048, 320, "float32", seed=3)}
    f32_ref = attention_ref(*f32[""])
    shape = "B=4 H=24 Hk=8 S=1024 Dh=128 bf16 causal; gemma3-4b Dh 320 (model layout)"
    _ablate(smi, fa.SOURCE, FLASH_ABLATIONS,
            {"flash_fwd": lambda: fa.flash_attention_fwd(q, k, v),
             **{f"flash_fwd_d320_prefill_{w}": (lambda w=w: fa.flash_attention_fwd(
                 *pre[w], window=win[w])) for w in pre},
             **{f"flash_fwd_d320_f32{t}": (lambda t=t: fa.flash_attention_fwd(*f32[t]))
                for t in f32}},
            f"flash_fwd at {shape} B=4 S=2048; f32 at Dh 320 B=1 H=4 Hk=2 S=333 and B=1 H=8 "
            f"Hk=4 S=2048 (rel err of the f32 output: F32_TOL is 1e-4 abs)",
            {"d320_ragged": lambda: rel(fa.flash_attention_fwd(qr, kr, vr),
                                        attention_ref(qr, kr, vr)),
             "d320_ragged_f32": lambda: rel(fa.flash_attention_fwd(*f32[""]), f32_ref)})
    calls = {}
    for tag, B, H, Hk, S, Dh, window, layout in (
            ("", 4, 24, 8, 1024, 128, None, "kernel"),
            ("_d320_train_global", 2, 8, 4, 2048, 320, None, "model"),
            ("_d320_train_local", 2, 8, 4, 2048, 320, 1024, "model")):
        q_, k_, v_, do, _, lse, delta = bwd_inputs(B, H, Hk, S, Dh, window, layout)
        a = (q_, k_, v_, do, lse, delta)
        bkw = dict(causal=True, window=window, scale=Dh ** -0.5, q_offset=0)
        calls[f"flash_bwd_dq{tag}"] = lambda a=a, kw=bkw: fa.bwd_dq(*a, **kw)
        calls[f"flash_bwd_dkv{tag}"] = lambda a=a, kw=bkw: fa.bwd_dkv(*a, **kw)
    # the f32 backward (3xTF32) at d320_ragged_f32, gemma3_global_f32 and
    # llama_train_f32
    for tag, B, H, Hk, S, Dh, layout in (("_d320_f32", 1, 4, 2, 333, 320, "kernel"),
                                         ("_d320_f32_2048", 1, 8, 4, 2048, 320, "kernel"),
                                         ("_llama_f32", 4, 24, 8, 1024, 128, "model")):
        q_, k_, v_, do, _, lse, delta = bwd_inputs(B, H, Hk, S, Dh, None, layout, "float32")
        a = (q_, k_, v_, do, lse, delta)
        bkw = dict(causal=True, window=None, scale=Dh ** -0.5, q_offset=0)
        calls[f"flash_bwd_dq{tag}"] = lambda a=a, kw=bkw: fa.bwd_dq(*a, **kw)
        calls[f"flash_bwd_dkv{tag}"] = lambda a=a, kw=bkw: fa.bwd_dkv(*a, **kw)
    checks = {}
    for tag, dtype in (("d320_ragged", "bfloat16"), ("d320_ragged_f32", "float32")):
        r = bwd_inputs(2, 4, 2, 333, 320, None, "kernel", dtype)
        want = attention_bwd_ref(*r[:3], r[4], r[5], r[3])
        rkw = dict(causal=True, window=None, scale=320 ** -0.5, q_offset=0)
        a = (*r[:4], r[5], r[6])
        checks[f"{tag}_dq_dk_dv"] = lambda a=a, want=want, rkw=rkw: max(
            rel(g, w) for g, w in zip((fa.bwd_dq(*a, **rkw), *fa.bwd_dkv(*a, **rkw)), want))
    _ablate(smi, fa.BWD_SOURCE, FLASH_BWD_ABLATIONS, calls,
            f"flash_bwd_dq and flash_bwd_dkv at {shape} B=2 S=2048; f32 at Dh 320 B=1 H=4 Hk=2 "
            f"S=333 and B=1 H=8 Hk=4 S=2048, and at B=4 H=24 Hk=8 S=1024 Dh=128 (model layout; "
            f"rel err of the f32 gradients: GRAD_REL_TOL is 1e-4)", checks)


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


FLOW_ABLATE_SCALE, FLOW_ABLATE_BATCH = 32, 256  # chip_smoke.py's timed exact sweep


def _scatter_calls(cn, batch: int) -> list:
    """The exact sweep's folds as PR 29's fold takes them: each batch of
    ``batch`` sources, each level from the deepest: (keys, epos, cnt just
    before the call); with each level's mean and longest run of siblings
    (adjacent keys of one parent)."""
    import torch

    from repro_torch.core import compiled_flow as cf

    n = cn.num_vertices
    chips = cn.chips()
    dest = torch.zeros(n, dtype=torch.int64, device=cn.device)
    dest[chips] = 1
    calls, runs = [], {}
    for lo in range(0, chips.numel(), batch):
        srcs = chips[lo:lo + batch]
        f = cf._bfs_levels(cn, srcs)  # each level in the main path's order
        levels = [(f.queue[a:b], f.epos[a:b]) for a, b in zip(f.bounds[1:-1], f.bounds[2:])]
        cnt = dest.repeat(srcs.numel())
        cnt[torch.arange(srcs.numel(), device=cn.device) * n + srcs] = 0
        for d in range(len(levels), 0, -1):
            keys, epos = levels[d - 1]
            parent = keys - keys % n + cn.edge_src[epos].long()
            starts = torch.ones_like(parent, dtype=torch.bool)
            starts[1:] = parent[1:] != parent[:-1]
            bounds = torch.nonzero(torch.cat([starts, starts.new_ones(1)])).flatten()
            lens = torch.diff(bounds)
            r = runs.setdefault(d, [0, 0, 0])
            r[0] += keys.numel()
            r[1] += lens.numel()
            r[2] = max(r[2], int(lens.max()))
            calls.append((keys, epos, cnt.clone()))
            cnt.index_add_(0, parent, cnt[keys])
    return calls, {d: (r[0] / r[1], r[2]) for d, r in sorted(runs.items())}


# the level-ordered fold of this checkout (subtree_sum_kernel) with its one
# atomic made a plain read-modify-write (racy across the batch's sources)
FOLD_ABLATIONS = {"K_plain": ("the K[epos] atomic (a plain read-modify-write)", [
    (r"atomicAdd\(&K\[qepos\[q\]\], static_cast<unsigned long long>\(c\)\);",
     "K[qepos[q]] += c;")])}


def flow_ablate(smi: str, other: str) -> None:
    """The subtree fold at the main path's timed shape (the scale-32 RailX
    exact sweep, batches of 256 sources: every call of it in one CUDA
    graph): PR 29's scatter fold, in the checkout at ``other``, as it is and
    with its K[e] atomics, its cnt[parent] atomics or both made plain; then
    this checkout's level-ordered fold, as it is and with its K atomic
    made plain."""
    import ctypes

    import torch

    from repro_torch.core import compiled_flow as cf
    from repro_torch.kernels import build
    from repro_torch.kernels.flow import flow

    cn = cf.build_compiled_railx_hyperx(FLOW_ABLATE_SCALE, 2, 2.0)
    n, E = cn.num_vertices, cn.num_edges
    calls, runs = _scatter_calls(cn, FLOW_ABLATE_BATCH)
    print(f"flow_ablate: RailX {FLOW_ABLATE_SCALE} m 2 exact sweep, batches of "
          f"{FLOW_ABLATE_BATCH}: {len(calls)} fold calls; siblings by depth (mean run, longest): "
          + ", ".join(f"{d}: {m:.2f}, {x}" for d, (m, x) in runs.items()) + f" [{smi}]",
          flush=True)
    want = torch.zeros(E, dtype=torch.int64, device=cn.device)
    for keys, epos, cnt in calls:
        want.index_add_(0, epos, cnt[keys])
    source = str((Path(other).resolve() / "src/repro_torch/kernels/flow/csrc/flow.cu"))
    work = [(k, e, c.clone()) for k, e, c in calls]
    K = torch.zeros(E, dtype=torch.int64, device=cn.device)

    def scatter():
        fn = build._LIBS[source].flow_subtree_accumulate
        if fn.argtypes is None:
            p, ll = ctypes.c_void_p, ctypes.c_longlong
            fn.argtypes, fn.restype = [p, p, ll, p, p, p, ll, p], ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        for keys, epos, cnt in work:
            if fn(keys.data_ptr(), epos.data_ptr(), keys.numel(), cn.edge_src.data_ptr(),
                  cnt.data_ptr(), K.data_ptr(), n, stream):
                raise RuntimeError("flow_subtree_accumulate launch failed")

    def rel_err(fn):
        K.zero_()
        fn()
        torch.cuda.synchronize()
        return ((K - want).abs().max() / want.abs().max()).item()

    _ablate(smi, source, SCATTER_ABLATIONS, {"scatter_fold_sweep": scatter},
            f"PR 29's flow_subtree_accumulate ({other}), all {len(calls)} calls of the "
            f"sweep's folds a graph node set; ms per sweep (/ {len(calls)} a call)",
            {"scatter_fold_sweep": lambda: rel_err(scatter)})
    del work, calls
    chips = cn.chips()
    forests = [cf._bfs_levels(cn, chips[lo:lo + FLOW_ABLATE_BATCH])
               for lo in range(0, chips.numel(), FLOW_ABLATE_BATCH)]
    dest = torch.ones(n, dtype=torch.int64, device=cn.device)
    cnts = [torch.empty(f.bounds[-1], dtype=torch.int64, device=cn.device) for f in forests]
    levels = sum(len(f.bounds) - 2 for f in forests)

    def fold():
        for f, cnt in zip(forests, cnts):
            for d in range(len(f.bounds) - 2, 0, -1):
                qs, L = f.level(d)
                flow.subtree_accumulate(f.queue, f.epos, f.child, qs, L, dest, cnt, K, n)

    _ablate(smi, flow.SOURCE, FOLD_ABLATIONS, {"level_fold_sweep": fold},
            f"this checkout's flow_subtree_accumulate, all {levels} calls of the sweep's folds; "
            f"ms per sweep (/ {levels} a call)", {"level_fold_sweep": lambda: rel_err(fold)})


# One thread adds x to 0.0 n times, each add waiting on the one before
# (__dadd_rn: no contraction), as flow_ordered_fold chains a run.
_DADD_CHAIN = r"""
#include <cuda_runtime.h>
__global__ void dadd_chain_kernel(double* out, double x, long long n) {
  double acc = 0.0;
#pragma unroll 16
  for (long long i = 0; i < n; ++i) acc = __dadd_rn(acc, x);
  out[0] = acc;
}
extern "C" int dadd_chain(void* out, double x, long long n, void* stream) {
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), x, n);
  return static_cast<int>(cudaGetLastError());
}
"""
DADD_CHAIN_ADDS = (1 << 20, 1 << 22)  # two chain lengths; their difference cancels the launch


def dadd_chain(smi: str) -> None:
    """ns of one dependent f64 add on the current card: the chain kernel
    (built with the port's nvcc flags into ``build/probe/``) timed with CUDA
    events at two lengths, median of 5 each; (t2 - t1) / (n2 - n1)."""
    import ctypes
    import statistics

    import torch

    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "dadd_chain.cu", out_dir / "dadd_chain.so"
    src.write_text(_DADD_CHAIN)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"dadd_chain does not build:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(lib)).dadd_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for n in DADD_CHAIN_ADDS:
        runs = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if fn(out.data_ptr(), 0.5, n, stream):
                raise RuntimeError("dadd_chain launch failed")
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        ms[n] = statistics.median(runs[1:])
        if out.item() != 0.5 * n:
            raise RuntimeError(f"dadd_chain summed {out.item()!r}, not {0.5 * n!r}")
    (n1, t1), (n2, t2) = sorted(ms.items())
    ns = (t2 - t1) / (n2 - n1) * 1e6
    print(f"dadd_chain: one dependent f64 add (__dadd_rn) takes {ns:.4f} ns on the card "
          f"({DADD_CHAIN_ADDS[0]} and {DADD_CHAIN_ADDS[1]} adds, one thread, the difference of "
          f"their CUDA-event times over the difference of adds) [{smi}]", flush=True)


# Runs in the checkout of the current directory: the exact sweep at 16,384
# chips (RailX 64 m 2, batches of 1,024) once timed on the host and once
# under the profiler, the symmetry sweep at 102,400 chips (RailX 160 m 2)
# the same way, then one goodput miss at max_flow_nodes 512; prints one line
# of JSON.  Uses only calls that the port has had since its cluster twin.
_FLOW_AB = r"""
import json, sys, time, torch
sys.path.insert(0, "src")
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import compiled_flow as cf
from repro_torch.kernels.flow import flow
FLOW = ("bfs_", "subtree_", "fill_kernel", "orbit_kernel", "fold_kernel")
cn = cf.build_compiled_railx_hyperx(64, 2, 2.0)
cf.alltoall_edge_counts(cn, cn.chips()[:1024])  # the build, the reverse tables, the allocator
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
flow.reset_launch_counts()
t0 = time.perf_counter()
K = cf.alltoall_edge_counts(cn)
torch.cuda.synchronize()
host_ms = (time.perf_counter() - t0) * 1e3
peak = torch.cuda.max_memory_allocated() - base
levels = flow.launch_counts()["flow_bfs_level"]
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    K2 = cf.alltoall_edge_counts(cn)
    torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
ev = prof.events()
spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in ev
               if e.device_type.name == "CUDA")
kern = sum(b - a for a, b, _ in spans) / 1e3
flow_ms = sum(b - a for a, b, name in spans if any(f in name for f in FLOW)) / 1e3
busy, cs, ce = 0.0, None, None
for a, b, _ in spans:
    if ce is None or a > ce:
        busy += 0 if ce is None else ce - cs
        cs, ce = a, b
    else:
        ce = max(ce, b)
busy = (busy + (ce - cs if ce is not None else 0)) / 1e3
syncs = sum(1 for e in ev if e.device_type.name == "CPU" and "Synchronize" in e.name)
pos = torch.arange(K.numel(), device=K.device)
finger = int(((K * (pos % 1000003)) % 1000000007).sum())
assert torch.equal(K, K2)
del cn
torch.cuda.empty_cache()
cn = cf.build_compiled_railx_hyperx(160, 2, 2.0)
re, Ks = cf.symmetric_alltoall_counts(cn)  # warm: the allocator, the reverse tables
torch.cuda.synchronize()
t0 = time.perf_counter()
re, Ks = cf.symmetric_alltoall_counts(cn)
torch.cuda.synchronize()
sym_ms = (time.perf_counter() - t0) * 1e3
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    cf.symmetric_alltoall_counts(cn)
    torch.cuda.synchronize()
orbit_ms = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type.name == "CUDA" and "orbit_kernel" in e.name) / 1e3
sym_finger = int(((Ks * (re % 1000003)) % 1000000007).sum())
grab = {}
orbit_gather, ordered_fold = flow.orbit_gather, flow.ordered_fold
flow.orbit_gather = lambda *a: (grab.setdefault("orbit", a), orbit_gather(*a))[1]
flow.ordered_fold = lambda *a: (grab.setdefault("fold", a), ordered_fold(*a))[1]
cf.symmetric_alltoall_counts(cn)
from repro_torch.arch import get
from repro_torch.core.simulator import alltoall_throughput
fb = get("railx-hyperx").flow_fig14(8, 2, 2.0, 8.0)
alltoall_throughput(fb.net, fb.chips, 8.0, num_paths=2)
flow.orbit_gather, flow.ordered_fold = orbit_gather, ordered_fold

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
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / iters

orbit_graph_ms = graph_ms(lambda: flow.orbit_gather(*grab["orbit"]))
fold_graph_ms = graph_ms(lambda: flow.ordered_fold(*grab["fold"]))
del cn, grab
torch.cuda.empty_cache()
from repro_torch.cluster import estimate_goodput, make_job, plan_job_mapping
from repro_torch.core.availability import JobAllocation
from repro_torch.core.mapping import ParallelismPlan
from repro_torch.core.topology import RailXConfig
cfg = RailXConfig(m=4, n=4, R=64)
job = make_job(0, "qwen3-8b", plan=ParallelismPlan(tp=16, cp=1, ep=1, dp=32, pp=32))
jm = plan_job_mapping(cfg, job)
alloc = JobAllocation(tuple(range(jm.rows_req)), tuple(range(jm.cols_req)))
forests = getattr(cf, "route_forest_counts", None)  # a tree that routes in forests
if forests:
    cf.reset_route_forest_counts()
flow.reset_launch_counts()
torch.cuda.synchronize()
t0 = time.perf_counter()
g = estimate_goodput(cfg, job, jm.mapping, alloc)
torch.cuda.synchronize()
miss_ms = (time.perf_counter() - t0) * 1e3
print(json.dumps({"sweep_host_ms": host_ms, "sweep_profiled_host_ms": prof_ms,
                  "kernel_ms": kern, "busy_ms": busy, "busy_share": busy / prof_ms,
                  "flow_kernel_ms": flow_ms, "glue_ms": kern - flow_ms, "levels": levels,
                  "syncs": syncs, "syncs_per_level": syncs / levels,
                  "device_ms_per_level": kern / levels, "peak_gib": peak / 2 ** 30,
                  "sym_host_ms": sym_ms, "orbit_kernel_ms": orbit_ms,
                  "orbit_graph_ms": orbit_graph_ms, "fold_graph_ms": fold_graph_ms,
                  "miss_ms": miss_ms, "miss_levels": flow.launch_counts()["flow_bfs_level"],
                  **({"miss_forests": forests()["forests"]} if forests else {}), "goodput": g, "counts_fingerprint": finger,
                  "sym_fingerprint": sym_finger}))
"""

FLOW_AB_RUNS = 3  # runs a side; the medians are printed


def flow_ab(smi: str, other: str) -> None:
    """The flow path of the checkout at ``other`` against this one's, each
    run a fresh process that builds its checkout's kernels, in turns
    (other, this, this, other, other, this): the 16,384-chip exact sweep's
    host ms, kernel ms, busy share, torch glue ms (device time outside the
    flow kernels), host syncs a level and peak memory, and one goodput miss
    at max_flow_nodes 512; then each metric's median of the runs on each
    side and other / this.  The counts and the goodput must agree."""
    import json
    import statistics

    here = Path(__file__).resolve().parent
    there = (here / other).resolve()
    print(f"flow_ab: RailX 64 m 2 exact sweep (16,384 chips, batches of 1,024), RailX 160 m 2 "
          f"symmetry sweep (102,400 chips) and a goodput miss at 512 nodes, {there} against "
          f"{here}, {FLOW_AB_RUNS} runs a side [{smi}]",
          flush=True)
    runs = {"other": [], "this": []}
    order = ["other", "this", "this", "other"] + ["other", "this"] * (FLOW_AB_RUNS - 2)
    for label in order:
        path = there if label == "other" else here
        res = subprocess.run([sys.executable, "-c", _FLOW_AB], cwd=path, capture_output=True,
                             text=True)
        if res.returncode != 0:
            sys.exit(f"flow_ab: the run in {path} failed:\n{res.stderr[-3000:]}")
        line = res.stdout.strip().splitlines()[-1]
        print(f"flow_ab {label} ({path}): {line}", flush=True)
        runs[label].append(json.loads(line))
    for key in ("goodput", "counts_fingerprint", "sym_fingerprint"):
        got = {r[key] for side in runs.values() for r in side}
        if len(got) != 1:
            sys.exit(f"flow_ab: {key} differs between the runs: {got}")
    for key in runs["this"][0]:
        if key in ("goodput", "counts_fingerprint", "sym_fingerprint"):
            continue
        if key not in runs["other"][0]:  # a count the other tree does not keep
            t = statistics.median(r[key] for r in runs["this"])
            print(f"flow_ab {key}: this {t:.6g} (median of {FLOW_AB_RUNS}), other not counted",
                  flush=True)
            continue
        o, t = (statistics.median(r[key] for r in runs[side]) for side in ("other", "this"))
        print(f"flow_ab {key}: other {o:.6g}, this {t:.6g} (median of {FLOW_AB_RUNS}), "
              f"other/this {o / t if t else float('nan'):.3f}", flush=True)


# family_cards: zamba2-7b at all 81 layers in f32 (the registry's dtypes)
# under gspmd_fsdp on (1, 4, 1), 4 x 256 tokens a step (a row a card), its
# first loss against the unsharded forward of the same weights on one card;
# then xlstm-125m, whisper-large-v3 and qwen2-vl-2b (chip_smoke.py's train
# cells) tensor-parallel on (1, 2, 2) against one card
HYBRID_CARDS_B, HYBRID_CARDS_S, HYBRID_CARDS_STEPS = 4, 256, 3
HYBRID_CARDS_REL = 1e-4
TP_CARDS_ARCHS = ("xlstm-125m", "whisper-large-v3", "qwen2-vl-2b")


def _hybrid_cards_setup():
    """zamba2-7b whole in f32 with remat (the reference's group remat), its
    AdamW config and batches."""
    from chip_smoke import TRAIN_STEPS
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_config("zamba2-7b"), remat=True)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=HYBRID_CARDS_S, global_batch=HYBRID_CARDS_B))
    return cfg, get_model(cfg), ocfg, data


def _hybrid_one_card(out) -> None:
    """The unsharded forward loss of the 4-card run's weights (seed 0) on
    its first batch, on one card, without gradients."""
    import torch

    cfg, zoo, ocfg, data = _hybrid_cards_setup()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        loss, _ = zoo.loss(params, batch)
    out.put((float(loss), time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
             sum(p.numel() for p in params.parameters())))


def family_cards_hybrid(rank: int, world: int, smi: str, want: float) -> None:
    """zamba2-7b at 81 layers under gspmd_fsdp on (1, 4, 1): params and
    AdamW moments sharded over "data", 3 steps; the first loss against the
    one-card forward's ``want`` (rel 1e-4), the params + moments held and
    the peak a card, step times; ssd_fwd launches."""
    import torch

    from chip_smoke import _train_init, _train_run, scan_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train.train_step import make_train_step

    cfg, zoo, ocfg, data = _hybrid_cards_setup()
    mesh = make_mesh((1, world, 1), ("pod", "data", "model"), "cuda")
    layout = param_layout(zoo, mesh)
    params, opt = _train_init(zoo, ocfg, layout)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    step_fn = make_train_step(zoo, ocfg, device="cuda", mesh=mesh)
    run = _train_run(f"family_cards zamba2 rank {rank}", step_fn, params, opt, data,
                     HYBRID_CARDS_STEPS)
    per_step = scan_launches(cfg, True)["ssd_fwd"]
    if run["launches"]["ssd_fwd"] != per_step * HYBRID_CARDS_STEPS:
        raise RuntimeError(f"rank {rank}: launches {run['launches']}, want {per_step} ssd_fwd "
                           "a step")
    if rank == 0:
        gap = abs(run["loss"][0] - want) / abs(want)
        n = sum(int(torch.tensor(s).prod()) for s in layout.shapes.values())
        tokens = HYBRID_CARDS_B * HYBRID_CARDS_S
        mean_s = sum(run["step_ms"][1:]) / (len(run["step_ms"]) - 1) / 1e3
        mfu = 6.0 * n * tokens / mean_s / (world * 67e12)
        print(f"family_cards zamba2-7b L={cfg.num_layers} f32 gspmd_fsdp on "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: losses {run['loss']}, grad_norms "
              f"{run['grad_norm']}; first loss against one card's unsharded forward {want:.7f}: "
              f"rel {gap:.3e} (tol {HYBRID_CARDS_REL:g}); per-step ms "
              f"{[round(t, 2) for t in run['step_ms']]}, {tokens / mean_s:.1f} tokens/s, MFU "
              f"{mfu:.3%} on {n} leaves (6 N tokens / step time / (4 x 67 TFLOP/s f32)); "
              f"params + moments held {held / 2**30:.2f} GiB a card, max_memory_allocated "
              f"{run['peak'] / 2**30:.2f} GiB; ssd_fwd launches {per_step} a step a card [{smi}]",
              flush=True)
        if not gap <= HYBRID_CARDS_REL:
            raise RuntimeError(f"family_cards zamba2: first loss off by {gap:.3e}")


def _tp_setup(arch: str):
    from chip_smoke import family_train_setup, recurrent_train_setup

    if arch == "xlstm-125m":
        cfg, zoo, ocfg, data = recurrent_train_setup(arch)
        return cfg, zoo, ocfg, data, 1
    return family_train_setup(arch)


def family_cards_tp(rank: int, world: int, smi: str) -> None:
    """xlstm-125m, whisper-large-v3 and qwen2-vl-2b under gspmd_fsdp on
    (1, 2, 2): FSDP over "data", the heads (and whisper's vocab) over
    "model"; 3 steps each against one card's (rank 0, the one-process
    step), losses within CARDS_LOSS_REL; launches a card."""
    import torch
    import torch.distributed as dist

    from chip_smoke import (
        _largest_gap, _train_init, _train_launches, _train_run, n_attentions, scan_launches,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train.train_step import make_train_step

    mesh = make_mesh((1, 2, world // 2), ("pod", "data", "model"), "cuda")
    for arch in TP_CARDS_ARCHS:
        cfg, zoo, ocfg, data, micro = _tp_setup(arch)
        one = None
        if rank == 0:
            params, opt = _train_init(zoo, ocfg)
            one = _train_run(f"family_cards {arch} one card", make_train_step(
                zoo, ocfg, microbatches=micro, device="cuda"), params, opt, data, CARDS_STEPS)
            del params, opt
            torch.cuda.empty_cache()
        dist.barrier()
        layout = param_layout(zoo, mesh)
        plan = zoo.shard_plan(layout)
        params, opt = _train_init(zoo, ocfg, layout)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        step_fn = make_train_step(zoo, ocfg, microbatches=micro, device="cuda", mesh=mesh)
        run = _train_run(f"family_cards {arch} rank {rank}", step_fn, params, opt, data,
                         CARDS_STEPS)
        del params, opt, step_fn
        torch.cuda.empty_cache()
        if cfg.family == "xlstm":
            want = {**_train_launches(0, CARDS_STEPS),
                    **{k: v * CARDS_STEPS for k, v in scan_launches(cfg, True).items()}}
        else:
            want = _train_launches(n_attentions(cfg) * micro, CARDS_STEPS)
        if run["launches"] != want:
            raise RuntimeError(f"rank {rank} {arch}: launches {run['launches']}, want {want}")
        if rank == 0:
            gap = _largest_gap(run["loss"], one["loss"])
            print(f"family_cards {arch} gspmd_fsdp on {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  f" (heads split {plan.heads or plan.ssm}, vocab split {plan.head_vocab}): losses "
                  f"{run['loss']} against one card's {one['loss']}, largest relative gap "
                  f"{gap:.3e} (tol {CARDS_LOSS_REL:g}); grad_norms {run['grad_norm']} against "
                  f"{one['grad_norm']}; per-step ms {[round(t, 2) for t in run['step_ms']]} "
                  f"against one card's {[round(t, 2) for t in one['step_ms']]}; held "
                  f"{held / 2**30:.2f} GiB a card, max_memory_allocated "
                  f"{run['peak'] / 2**30:.2f} GiB (one card {one['peak'] / 2**30:.2f}); "
                  f"launches a card {run['launches']} [{smi}]", flush=True)
            if not gap <= CARDS_LOSS_REL:
                raise RuntimeError(f"family_cards {arch}: loss gap {gap:.3e}")


def _family_cards_rank(rank: int, world: int, port: int, smi: str, want: float) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        family_cards_hybrid(rank, world, smi, want)
        torch.cuda.empty_cache()
        family_cards_tp(rank, world, smi)
    finally:
        dist.destroy_process_group()


def family_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world != 4:
        sys.exit(f"family_cards needs 4 cards, found {world}")
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    proc = ctx.Process(target=_hybrid_one_card, args=(q,))
    proc.start()
    want, secs, peak, n = q.get()
    proc.join()
    print(f"family_cards: zamba2-7b L=81 f32 unsharded forward on one card ({n} params): loss "
          f"{want:.7f} in {secs:.2f} s (first call), max_memory_allocated {peak / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)
    print(f"family_cards: {world} ranks, one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_family_cards_rank, args=(world, free_port(), smi, want), nprocs=world,
                       join=True, start_method="spawn")


# tp_cards: qwen3-8b at full size (36 layers, 8.19 B params) in bf16 with
# remat and flash, manual_hier with TP on (1, 2, 2) ("pod", "data",
# "model"), then gspmd_fsdp on the same mesh; the global batch of 4 x 1024
# tokens, two sequences a data rank
TP_CARDS_STEPS = 4
TP_CARDS_SHAPE = (1, 2, 2)


def _qwen3_setup():
    """qwen3-8b at full size in bf16 with remat and flash, its AdamW config
    and the train phase's data (4 x 1024 tokens of a 4096-token corpus)."""
    import torch

    from chip_smoke import TRAIN_B, TRAIN_S
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_config("qwen3-8b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, remat=True, attn_impl="flash")
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TP_CARDS_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=TRAIN_S, global_batch=TRAIN_B))
    return cfg, get_model(cfg), ocfg, data


def _one_card_loss(out, setup) -> None:
    """One card's bf16 forward loss of the weights (seed 0) and first batch
    of a four-card run (``setup()`` -> cfg, zoo, ocfg, data), without
    gradients."""
    import torch

    cfg, zoo, ocfg, data = setup()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch(0).items()}
    with torch.inference_mode():
        loss, _ = zoo.loss(params, batch)
    out.put((float(loss), torch.cuda.max_memory_allocated(),
             sum(p.numel() for p in params.parameters())))


def _cards_dryrun(arch: str, cfg, mesh_shape: tuple, dp_mode: str, tag: str,
                  overrides=None) -> dict:
    """The dry run of a four-card cell (``cfg``, 4 x 1024 tokens on
    ``mesh_shape``) on a fake world of 4 (meta tensors, this process):
    argument and peak bytes a rank, the roofline terms."""
    import torch.distributed as dist

    from chip_smoke import TRAIN_B, TRAIN_S
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    dryrun.fake_world(4)
    try:
        mesh = make_mesh(mesh_shape, ("pod", "data", "model"), "cpu")
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_S, global_batch=TRAIN_B)
        res = dryrun.run_cell(arch, "train_4k", dp_mode=dp_mode, mesh=mesh, cfg=cfg,
                              shape=shape, rules_overrides=overrides, tag=tag)
    finally:
        dist.destroy_process_group()
    return res["report"]


def _tp_cards_run(rank: int, tag: str, zoo, ocfg, data, mesh, dp_mode: str,
                  schedule: str, device: str, rules_overrides=None,
                  steps: int = TP_CARDS_STEPS) -> dict:
    """``steps`` steps of ``dp_mode`` on ``mesh`` from seed 0 under the
    byte ledger (with ``rules_overrides``): the run, the params + moments
    held a card and the bytes by op and axes."""
    import torch

    from chip_smoke import _train_init, _train_run
    from repro_torch.collectives import byte_ledger
    from repro_torch.train.train_step import make_train_step

    step_fn = make_train_step(zoo, ocfg, device=device, mesh=mesh, dp_mode=dp_mode,
                              schedule=schedule, rules_overrides=rules_overrides)
    torch.cuda.reset_peak_memory_stats()
    params, opt = _train_init(zoo, ocfg, step_fn.layout)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    with byte_ledger() as ledger:
        run = _train_run(f"{tag} rank {rank}", step_fn, params, opt, data, steps)
    by = {}
    for r in ledger.records:
        key = f"{r.op}({','.join(r.axes)})"
        by[key] = by.get(key, 0) + r.nbytes
    run.update(held=held, bytes={k: round(b / steps / 1e9, 4) for k, b in by.items()},
               blocks=sum(p.numel() for p in params.parameters()))
    del params, opt, step_fn
    torch.cuda.empty_cache()
    return run


def tp_cards_rank(rank: int, world: int, smi: str, want: float, dry: dict,
                  device: str = "cuda") -> None:
    """qwen3-8b's manual_hier (hierarchical, then flat) and gspmd_fsdp on
    (1, 2, 2): the first loss against one card's forward ``want`` (rel
    CARDS_LOSS_REL), held and peak memory a card against the dry run's
    ``dry`` figures, step times, bytes by op and axes, the flash launches a
    step."""
    from chip_smoke import _train_launches
    from repro_torch.launch.mesh import make_mesh

    cfg, zoo, ocfg, data = _qwen3_setup()
    mesh = make_mesh(TP_CARDS_SHAPE, ("pod", "data", "model"), device)
    want_launches = _train_launches(cfg.num_layers, TP_CARDS_STEPS)
    for dp_mode, schedule in (("manual_hier", "hierarchical"), ("manual_hier", "flat"),
                              ("gspmd_fsdp", "hierarchical")):
        tag = f"tp_cards {dp_mode}" + (f" {schedule}" if dp_mode == "manual_hier" else "")
        run = _tp_cards_run(rank, tag, zoo, ocfg, data, mesh, dp_mode, schedule, device)
        if run["launches"] != want_launches:
            raise RuntimeError(f"{tag} rank {rank}: launches {run['launches']}, want "
                               f"{want_launches}")
        if rank != 0:
            continue
        gap = abs(run["loss"][0] - want) / abs(want)
        d = dry[dp_mode]
        m = d["memory_stats"]
        tokens = 4 * 1024
        print(f"{tag} on {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {cfg.name} "
              f"L={cfg.num_layers} bf16, remat, flash, {run['blocks'] / 1e9:.3f} B params a card; "
              f"losses {run['loss']}, grad_norms {run['grad_norm']}; first loss against one "
              f"card's bf16 forward {want:.6f}: rel {gap:.3e} (tol {CARDS_LOSS_REL:g}); per-step "
              f"ms {[round(t, 2) for t in run['step_ms']]}, steady {run['mean_ms']:.2f} ms, "
              f"{tokens / run['mean_ms'] * 1e3:.1f} tokens/s; params + moments held "
              f"{run['held'] / 2**30:.3f} GiB a card (dry run's arguments "
              f"{(m['param_bytes'] + m['moment_bytes']) / 2**30:.3f}); max_memory_allocated "
              f"{run['peak'] / 2**30:.3f} GiB (dry run's peak {m['peak_bytes'] / 2**30:.3f}); "
              f"dry run's terms: compute {d['compute_s'] * 1e3:.1f} ms, memory "
              f"{d['memory_s'] * 1e3:.1f} ms, collective {d['collective_s'] * 1e3:.1f} ms; "
              f"collective results GB a rank a step {run['bytes']} (dry run's "
              f"{({k: round(v / 1e9, 4) for k, v in d['collectives'].items()})}); flash launches "
              f"a step at the rank's shape (B 2, H 16, Hk 4, S 1024, Dh 128): "
              f"{({k: v // TP_CARDS_STEPS for k, v in run['launches'].items() if v})} [{smi}]",
              flush=True)
        if not gap <= CARDS_LOSS_REL:
            raise RuntimeError(f"{tag}: first loss off by {gap:.3e}")


def _nccl_rank(rank: int, world: int, port: int, body, *args) -> None:
    """``body(rank, world, *args)`` on card ``rank`` of a NCCL world."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        body(rank, world, *args)
    finally:
        dist.destroy_process_group()


def tp_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world != 4:
        sys.exit(f"tp_cards needs 4 cards, found {world}")
    t0 = time.perf_counter()
    cfg, *_ = _qwen3_setup()
    dry = {mode: _cards_dryrun("qwen3-8b", cfg, TP_CARDS_SHAPE, mode, f"tp_cards_{mode}")
           for mode in ("manual_hier", "gspmd_fsdp")}
    print(f"tp_cards: dry runs of the cell on a fake world of 4 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    proc = ctx.Process(target=_one_card_loss, args=(q, _qwen3_setup))
    proc.start()
    want, peak, n = q.get()
    proc.join()
    print(f"tp_cards: qwen3-8b bf16 forward on one card ({n} params): loss {want:.6f}, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB [{smi}]", flush=True)
    print(f"tp_cards: {world} ranks, one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_nccl_rank, args=(world, free_port(), tp_cards_rank, smi, want, dry),
                       nprocs=world, join=True, start_method="spawn")


# sp_cards: llama3.2-3b uncut under sequence parallelism over "model" on
# (1, 1, 4): each card takes 256 of the 1024 positions of the 4 rows
SP_CARDS_SHAPE = (1, 1, 4)
SP_CARDS_OVERRIDES = {"heads": None, "kv_heads": None, "seq": "model"}
SP_CARDS_LOSS_REL = 1e-3
# the dry run's reckoned peak against max_memory_allocated
SP_CARDS_PEAK_REL = 0.15


def _sp_setup(attn_impl: str = "flash"):
    """llama3.2-3b at full width and depth in bf16 with remat and flash (the
    train phase's setup) or the plain attention, with TP_CARDS_STEPS steps."""
    from chip_smoke import _train_setup
    from repro_torch.models.model_zoo import get_model

    cfg, zoo, ocfg, data = _train_setup()
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    return cfg, get_model(cfg), dataclasses.replace(ocfg, total_steps=TP_CARDS_STEPS), data


# (tag, dp_mode, overrides, attention): the positions cut, then the same
# mesh with the sequence whole, with the flash kernels and with the plain
# attention (the reference's default, whose f32 scores grow with S^2)
SP_WHOLE = {"heads": None, "kv_heads": None}
SP_CARDS_RUNS = (("sp gspmd_fsdp", "gspmd_fsdp", SP_CARDS_OVERRIDES, "flash"),
                 ("sp manual_hier", "manual_hier", SP_CARDS_OVERRIDES, "flash"),
                 ("whole gspmd_fsdp", "gspmd_fsdp", SP_WHOLE, "flash"),
                 ("sp gspmd_fsdp ref", "gspmd_fsdp", SP_CARDS_OVERRIDES, "ref"),
                 ("whole gspmd_fsdp ref", "gspmd_fsdp", SP_WHOLE, "ref"))


def sp_cards_rank(rank: int, world: int, smi: str, want: float, dry: dict,
                  device: str = "cuda") -> None:
    """``SP_CARDS_RUNS`` on (1, 1, 4): llama3.2-3b's gspmd_fsdp and
    manual_hier (hierarchical) steps with the positions cut over "model",
    then gspmd_fsdp on the same mesh with the sequence whole on every rank
    (the heads whole as well: the path before sequence parallelism), with
    the flash kernels and then with the plain attention: the first loss
    against one card's forward ``want`` (rel SP_CARDS_LOSS_REL), the losses
    across the modes, held and peak memory a card against the dry run's
    ``dry`` figures, step times, bytes by op and axes, the flash launches a
    step."""
    import torch

    from chip_smoke import _train_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as opt_lib

    # the peak before the first optimizer step (the forward and backward and
    # the gradient's reduction) and the gradient's bytes then: where the
    # step's peak is set
    real_apply, before_opt = opt_lib.apply, []

    def apply(cfg, state, params, grads, *args, **kw):
        if not before_opt:
            before_opt.append((torch.cuda.max_memory_allocated(),
                               sum(g.numel() * g.element_size() for g in grads.values())))
        return real_apply(cfg, state, params, grads, *args, **kw)

    mesh = make_mesh(SP_CARDS_SHAPE, ("pod", "data", "model"), device)
    runs = {}
    for tag, dp_mode, overrides, attn in SP_CARDS_RUNS:
        cfg, zoo, ocfg, data = _sp_setup(attn)
        before_opt.clear()
        opt_lib.apply = apply
        try:
            run = _tp_cards_run(rank, f"sp_cards {tag}", zoo, ocfg, data, mesh, dp_mode,
                                "hierarchical", device, overrides)
        finally:
            opt_lib.apply = real_apply
        run["before_opt"], run["grad_bytes"] = before_opt[0]
        want_launches = _train_launches(cfg.num_layers if attn == "flash" else 0,
                                        TP_CARDS_STEPS)
        if run["launches"] != want_launches:
            raise RuntimeError(f"sp_cards {tag} rank {rank}: launches {run['launches']}, want "
                               f"{want_launches}")
        runs[tag] = run
        if rank != 0:
            continue
        gap = abs(run["loss"][0] - want) / abs(want)
        d = dry[tag]
        m = d["memory_stats"]
        peak_gap = abs(m["peak_bytes"] - run["peak"]) / run["peak"]
        tokens = 4 * 1024
        print(f"sp_cards {tag} on {dict(zip(mesh.mesh_dim_names, mesh.shape))}, overrides "
              f"{overrides}: {cfg.name} L={cfg.num_layers} bf16, remat, {attn} attention, "
              f"{run['blocks'] / 1e9:.3f} B params a card; losses {run['loss']}, grad_norms "
              f"{run['grad_norm']}; first loss against one card's bf16 forward {want:.6f}: rel "
              f"{gap:.3e} (tol {SP_CARDS_LOSS_REL:g}); per-step ms "
              f"{[round(t, 2) for t in run['step_ms']]}, steady {run['mean_ms']:.2f} ms, "
              f"{tokens / run['mean_ms'] * 1e3:.1f} tokens/s; params + moments held "
              f"{run['held'] / 2**30:.3f} GiB a card (dry run's arguments "
              f"{(m['param_bytes'] + m['moment_bytes']) / 2**30:.3f}); max_memory_allocated "
              f"{run['peak'] / 2**30:.3f} GiB (dry run's peak {m['peak_bytes'] / 2**30:.3f}, "
              f"off by {peak_gap:.1%}); before the first optimizer step "
              f"{run['before_opt'] / 2**30:.3f} GiB with a gradient of "
              f"{run['grad_bytes'] / 2**30:.3f} GiB; dry run's terms: compute "
              f"{d['compute_s'] * 1e3:.1f} ms, "
              f"memory {d['memory_s'] * 1e3:.1f} ms, collective {d['collective_s'] * 1e3:.1f} "
              f"ms; collective results GB a rank a step {run['bytes']} (dry run's "
              f"{({k: round(v / 1e9, 4) for k, v in d['collectives'].items()})}); flash launches "
              f"a step: {({k: v // TP_CARDS_STEPS for k, v in run['launches'].items() if v})} "
              f"[{smi}]", flush=True)
        if not gap <= SP_CARDS_LOSS_REL:
            raise RuntimeError(f"sp_cards {tag}: first loss off by {gap:.3e}")
        if not peak_gap <= SP_CARDS_PEAK_REL:
            raise RuntimeError(f"sp_cards {tag}: the dry run's peak is off by {peak_gap:.1%}")
    if rank == 0:
        sp, other, whole, sp_ref, whole_ref = (runs[t] for t, *_ in SP_CARDS_RUNS)
        modes = max(abs(a - b) / abs(b) for a, b in zip(sp["loss"], other["loss"]))
        print(f"sp_cards: losses gspmd_fsdp against manual_hier, largest rel gap {modes:.3e}",
              flush=True)
        for what, a, b in (("flash", sp, whole), ("ref", sp_ref, whole_ref)):
            verdict = "lower: met" if a["peak"] < b["peak"] else "NOT lower: not met"
            print(f"sp_cards {what}: peak a card with the positions cut {a['peak'] / 2**30:.3f} "
                  f"GiB, with the sequence whole {b['peak'] / 2**30:.3f} GiB "
                  f"({a['peak'] / b['peak']:.4f}x; the cut's peak {verdict}); before the "
                  f"first optimizer step {a['before_opt'] / 2**30:.3f} against "
                  f"{b['before_opt'] / 2**30:.3f} GiB; steady step {a['mean_ms']:.2f} against "
                  f"{b['mean_ms']:.2f} ms [{smi}]", flush=True)
        if not modes <= SP_CARDS_LOSS_REL:
            raise RuntimeError(f"sp_cards: the two modes' losses differ by {modes:.3e}")
        if not sp_ref["peak"] < whole_ref["peak"]:
            raise RuntimeError("sp_cards: cutting the positions did not lower the peak of the "
                               "plain attention's step")
    torch.cuda.synchronize()


def sp_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world != 4:
        sys.exit(f"sp_cards needs 4 cards, found {world}")
    t0 = time.perf_counter()
    dry = {tag: _cards_dryrun("llama3.2-3b", _sp_setup(attn)[0], SP_CARDS_SHAPE, mode,
                              f"sp_cards_{mode}_{attn}", ov)
           for tag, mode, ov, attn in SP_CARDS_RUNS}
    print(f"sp_cards: dry runs of the cells on a fake world of 4 in "
          f"{time.perf_counter() - t0:.1f} s: peaks "
          f"{({t: round(d['memory_stats']['peak_bytes'] / 2**30, 3) for t, d in dry.items()})} "
          "GiB a rank", flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    proc = ctx.Process(target=_one_card_loss, args=(q, _sp_setup))
    proc.start()
    want, peak, _ = q.get()
    proc.join()
    print(f"sp_cards: llama3.2-3b bf16 forward on one card: loss {want:.6f}, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB [{smi}]", flush=True)
    print(f"sp_cards: {world} ranks, one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_nccl_rank, args=(world, free_port(), sp_cards_rank, smi, want, dry),
                       nprocs=world, join=True, start_method="spawn")
    sp_family_cards(smi)


# sp_family_cards: the hybrid, xLSTM and MoE families under sequence
# parallelism over "model" on SP_CARDS_SHAPE, each run against the same mesh
# with the sequence whole: (tag, arch, layers or None for all, B, S, dp
# modes, config fields)
SP_FAMILY_STEPS = 3
SP_FAMILY_CELLS = (
    ("zamba2-7b L12", "zamba2-7b", 12, 4, 1024, ("gspmd_fsdp", "manual_hier"), {}),
    ("xlstm-125m", "xlstm-125m", None, 4, 256, ("gspmd_fsdp", "manual_hier"), {}),
    ("moonshot-v1-16b-a3b L4", "moonshot-v1-16b-a3b", 4, 4, 1024, ("gspmd_fsdp",),
     {"moe_ep_axis": "model", "attn_impl": "flash"}),
)
# zamba2-7b's 81-layer prefill of one row: cut and whole at the first length,
# cut alone at the second (the whole's plain attention scores do not fit)
SP_PREFILL_S = (8192, 16384)
SP_PREFILL_RMS = 0.05  # the logits' rms difference over the whole prefill's rms
# the scans at a card's shapes: zamba2-7b's 28 of 112 heads over the gathered
# 4 x 1024; xlstm-125m's 4 heads (its cells keep the blocks whole) and 1 (a
# quarter, were they split) over 4 x 256
SP_SCANS_TIMED = (
    ("ssd_fwd", "zamba2-7b sp_family_cards, a card of (1, 1, 4)", (4, 1024, 28, 64, 64, 64)),
    ("mlstm_fwd", "xlstm-125m sp_family_cards, a card (blocks whole)", (4, 256, 4, 192, 64)),
    ("mlstm_fwd", "xlstm-125m, a quarter of the heads", (4, 256, 1, 192, 64)),
)


def _sp_family_setup(arch: str, layers, B: int, S: int, fields: dict):
    """``arch`` in bf16 with remat (at ``layers``, with ``fields``), an
    AdamW config for SP_FAMILY_STEPS and B x S batches of the 4096-token
    corpus."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, remat=True, **fields)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=SP_FAMILY_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=S, global_batch=B))
    return cfg, get_model(cfg), ocfg, data


def _family_launches(cfg, steps: int) -> dict:
    """The kernels' launches in ``steps`` steps of ``cfg`` with remat."""
    from chip_smoke import _train_launches, n_attentions, scan_launches

    if cfg.family in ("hybrid", "xlstm"):
        return {**_train_launches(0, steps),
                **{k: v * steps for k, v in scan_launches(cfg, True).items()}}
    return _train_launches(n_attentions(cfg), steps)


def _gib(n: float) -> str:
    return f"{n / 2**30:.3f}"


def _sp_family_train(rank: int, mesh, smi: str, device: str, failed: list) -> None:
    """SP_FAMILY_CELLS: each dp mode cut, then whole; the launches held to
    ``_family_launches``, the first losses to SP_CARDS_LOSS_REL (a miss
    appended to ``failed``, so that the other cells still run)."""
    for tag, arch, layers, B, S, modes, fields in SP_FAMILY_CELLS:
        cfg, zoo, ocfg, data = _sp_family_setup(arch, layers, B, S, fields)
        want = _family_launches(cfg, SP_FAMILY_STEPS)
        for mode in modes:
            runs = {}
            for cut, overrides in (("cut", SP_CARDS_OVERRIDES), ("whole", SP_WHOLE)):
                run = _tp_cards_run(rank, f"sp_family_cards {tag} {mode} {cut}", zoo, ocfg, data,
                                    mesh, mode, "hierarchical", device, overrides,
                                    SP_FAMILY_STEPS)
                if run["launches"] != want:
                    raise RuntimeError(f"sp_family_cards {tag} {mode} {cut} rank {rank}: "
                                       f"launches {run['launches']}, want {want}")
                runs[cut] = run
            if rank != 0:
                continue
            a, b = runs["cut"], runs["whole"]
            gap = abs(a["loss"][0] - b["loss"][0]) / abs(b["loss"][0])
            verdict = "lower" if a["peak"] < b["peak"] else "NOT lower"
            print(f"sp_family_cards {tag} {mode} on {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
                  f"{B} x {S}, bf16, remat, {run['blocks'] / 1e9:.3f} B params a card cut "
                  f"({b['blocks'] / 1e9:.3f} whole): losses cut {a['loss']} whole {b['loss']}, "
                  f"first loss rel {gap:.3e} (tol {SP_CARDS_LOSS_REL:g}); grad_norms cut "
                  f"{a['grad_norm']} whole {b['grad_norm']}; aux cut {a['aux']} whole "
                  f"{b['aux']}; steady step ms cut {a['mean_ms']:.2f} whole {b['mean_ms']:.2f} "
                  f"(per step {[round(t, 2) for t in a['step_ms']]} / "
                  f"{[round(t, 2) for t in b['step_ms']]}); params + moments held GiB a card "
                  f"cut {_gib(a['held'])} whole {_gib(b['held'])}; max_memory_allocated GiB cut "
                  f"{_gib(a['peak'])} whole {_gib(b['peak'])} (the cut's {verdict}, "
                  f"{a['peak'] / b['peak']:.4f}x); launches a step "
                  f"{({k: v // SP_FAMILY_STEPS for k, v in a['launches'].items() if v})}; "
                  f"collective results GB a rank a step cut {a['bytes']} whole {b['bytes']} "
                  f"[{smi}]", flush=True)
            if not gap <= SP_CARDS_LOSS_REL:
                failed.append(f"sp_family_cards {tag} {mode}: first loss off by {gap:.3e}")


def _sp_family_prefill(rank: int, mesh, smi: str, device: str, failed: list) -> None:
    """zamba2-7b at 81 layers, bf16: one row's prefill at each of
    SP_PREFILL_S, cut and (at the first) whole; a warm-up call, then a timed
    one with the launch counts and the peak reset before it; the cut's
    logits against the whole's (a miss appended to ``failed``)."""
    import torch

    from chip_smoke import launch_counts, reset_launch_counts
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step

    cfg = dataclasses.replace(get_config("zamba2-7b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    zoo = get_model(cfg)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = None
    for i, S in enumerate(SP_PREFILL_S):
        tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen)
        out = {}
        for cut, overrides in (("cut", SP_CARDS_OVERRIDES), ("whole", SP_WHOLE))[:2 - i]:
            arts = make_serve_step(zoo, device, mesh=mesh, batch_example={"tokens": tokens},
                                   rules_overrides=overrides)
            if params is None:  # the same blocks under both overrides
                g = torch.Generator(device=device)
                g.manual_seed(0)
                params = arts.param_layout.shard(zoo.init(g, device=device))
                torch.cuda.empty_cache()
            arts.prefill_fn(params, {"tokens": tokens})
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            logits = arts.prefill_fn(params, {"tokens": tokens})
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = {k: v for k, v in launch_counts().items() if v}
            if launches != {"ssd_fwd": cfg.num_layers}:
                raise RuntimeError(f"sp_family_cards prefill {S} {cut} rank {rank}: launches "
                                   f"{launches}, want ssd_fwd {cfg.num_layers}")
            peak = torch.cuda.max_memory_allocated()
            finite = bool(torch.isfinite(logits).all())
            out[cut] = logits.float()
            if rank == 0:
                print(f"sp_family_cards prefill zamba2-7b L={cfg.num_layers} bf16 1 x {S} {cut} on "
                      f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: {ms:.2f} ms (second call), "
                      f"{S / ms * 1e3:.1f} tokens/s; held {_gib(held)} GiB a card, "
                      f"max_memory_allocated {_gib(peak)} GiB; logits {tuple(logits.shape)} "
                      f"finite {finite}; launches {launches} [{smi}]", flush=True)
            if not finite:
                failed.append(f"sp_family_cards prefill {S} {cut}: non-finite logits")
            del logits
            torch.cuda.empty_cache()
        if "whole" in out:
            a, b = out["cut"], out["whole"]
            rms = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            if rank == 0:
                print(f"sp_family_cards prefill 1 x {S}: cut against whole, rms of the difference "
                      f"over the whole's rms {rms:.3e} (tol {SP_PREFILL_RMS:g}), argmax agreement "
                      f"{agree:.4f} [{smi}]", flush=True)
            if not rms <= SP_PREFILL_RMS:
                failed.append(f"sp_family_cards prefill {S}: cut and whole differ, rms {rms:.3e}")
        del out


def sp_family_cards_rank(rank: int, world: int, smi: str, device: str = "cuda") -> None:
    """SP_FAMILY_CELLS' training runs, zamba2-7b's prefill and, on rank 0,
    the scans timed at a card's shapes (SP_SCANS_TIMED)."""
    import torch
    import torch.distributed as dist

    from chip_smoke import time_scan
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(SP_CARDS_SHAPE, ("pod", "data", "model"), device)
    failed = []
    _sp_family_train(rank, mesh, smi, device, failed)
    torch.cuda.empty_cache()
    _sp_family_prefill(rank, mesh, smi, device, failed)
    if rank == 0:
        for kname, where, shape in SP_SCANS_TIMED:
            time_scan(kname, where, shape)
        print(f"sp_family_cards: scans timed [{smi}]", flush=True)
    dist.barrier()
    if failed:
        raise RuntimeError("; ".join(failed))


def sp_family_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.ssd import ssd

    world = torch.cuda.device_count()
    if world != 4:
        sys.exit(f"sp_family_cards needs 4 cards, found {world}")
    t0 = time.perf_counter()
    build.build_all([fa.SOURCE, fa.BWD_SOURCE, ssd.SOURCE, mlstm.SOURCE])  # once, not a rank each
    print(f"sp_family_cards: kernels built in {time.perf_counter() - t0:.1f} s; {world} ranks, "
          f"one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_nccl_rank, args=(world, free_port(), sp_family_cards_rank, smi),
                       nprocs=world, join=True, start_method="spawn")


# moe_axes_cards: moonshot-v1-16b-a3b's experts split over "model" on
# (1, 2, 2) at MOE_CARDS_LAYERS, and its MoE layers dense over the global
# batch on (2, 2) ("pod", "model"), a mesh without "data", at
# MOE_CHECK_LAYERS; each against one card's steps with the same routing
MOE_AXES_CASES = (
    ("ep_model", (1, 2, 2), ("pod", "data", "model"), {"moe_ep_axis": "model"}),
    ("no_data", (2, 2), ("pod", "model"), {}),
)


def moe_axes_cards_rank(rank: int, world: int, smi: str, device: str = "cuda") -> None:
    """Each of MOE_AXES_CASES: TRAIN_STEPS gspmd_fsdp steps under the byte
    ledger (losses, aux, step ms, all-to-all bytes a rank a step, peak), at
    MOE_CARDS_LAYERS for the EP case; then at MOE_CHECK_LAYERS each case's
    losses against one card's steps (rank 0) with as many microbatches as
    the EP groups of a pod (the tokens a "model" rank routes), within
    CARDS_LOSS_REL."""
    import torch
    import torch.distributed as dist

    from chip_smoke import TRAIN_B, TRAIN_S, TRAIN_STEPS, _largest_gap, _train_init
    from chip_smoke import _train_launches, _train_run
    from repro_torch.collectives import byte_ledger
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=TRAIN_S, global_batch=TRAIN_B))
    for name, shape, axes, fields in MOE_AXES_CASES:
        mesh = make_mesh(shape, axes, device)
        sizes = dict(zip(axes, shape))
        micro = sizes.get("model", 1) if name == "ep_model" else 1
        for layers in ((MOE_CARDS_LAYERS, MOE_CHECK_LAYERS) if name == "ep_model"
                       else (MOE_CHECK_LAYERS,)):
            cfg = dataclasses.replace(_moonshot(layers), **fields)
            zoo = get_model(cfg)
            one = None
            if rank == 0 and layers == MOE_CHECK_LAYERS:
                params, opt = _train_init(zoo, ocfg)
                one = _train_run(f"moe_axes_cards {name} one card, {micro} microbatches",
                                 make_train_step(zoo, ocfg, microbatches=micro, device=device),
                                 params, opt, data, TRAIN_STEPS)
                del params, opt
                torch.cuda.empty_cache()
            dist.barrier()
            step_fn = make_train_step(zoo, ocfg, device=device, mesh=mesh)
            params, opt = _train_init(zoo, ocfg, step_fn.layout)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            tag = f"moe_axes_cards {name} {layers} layers"
            with byte_ledger() as ledger:
                run = _train_run(f"{tag} rank {rank}", step_fn, params, opt, data, TRAIN_STEPS)
            del params, opt, step_fn
            torch.cuda.empty_cache()
            want = _train_launches(cfg.num_layers, TRAIN_STEPS)
            if run["launches"] != want:
                raise RuntimeError(f"{tag} rank {rank}: launches {run['launches']}, want {want}")
            if rank != 0:
                continue
            a2a = ledger.bytes("all_to_all") / TRAIN_STEPS
            line = (f"{tag} on {sizes}: losses {run['loss']}, aux {run['aux']}, grad_norms "
                    f"{run['grad_norm']}; per-step ms {[round(t, 2) for t in run['step_ms']]}, "
                    f"steady {run['mean_ms']:.2f} ms; all_to_all {a2a / 1e9:.4f} GB a rank a "
                    f"step; held {held / 2**30:.2f} GiB a card, max_memory_allocated "
                    f"{run['peak'] / 2**30:.2f} GiB")
            if one is not None:
                gap = _largest_gap(run["loss"], one["loss"])
                line += (f"; against one card's steps with {micro} microbatches: losses "
                         f"{one['loss']}, aux {one['aux']}, largest relative gap {gap:.3e} "
                         f"(tol {CARDS_LOSS_REL:g}), one card's steady {one['mean_ms']:.2f} ms")
                if not (gap <= CARDS_LOSS_REL and run["loss"][-1] < run["loss"][0]):
                    raise RuntimeError(f"{tag}: loss gap {gap:.3e} or the loss did not fall: "
                                       f"{run['loss']}")
            print(f"{line} [{smi}]", flush=True)


def _moe_axes_cards_rank(rank: int, world: int, port: int, smi: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        moe_axes_cards_rank(rank, world, smi)
    finally:
        dist.destroy_process_group()


def moe_axes_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world != 4:
        sys.exit(f"moe_axes_cards needs 4 cards, found {world}")
    print(f"moe_axes_cards: {world} ranks, one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_moe_axes_cards_rank, args=(world, free_port(), smi), nprocs=world,
                       join=True, start_method="spawn")


# pipe_cards: the reference's pipeline test and a llama3.2-3b layer a stage
PIPE_STAGES, PIPE_MICRO, PIPE_S = 4, 6, 1024


def pipe_cards_rank(rank: int, world: int, smi: str) -> None:
    """``make_pipelined_apply`` on a (4,) "pipe" ring of NCCL ranks: the
    reference's test (x @ (eye x (s + 1)), 6 microbatches, x * 24 within
    1e-4), then a llama3.2-3b decoder layer at full width in bf16 (flash)
    a stage over 6 microbatches of 1 x 1024 tokens, against the 4 layers
    applied in turn to each microbatch on one card (rel 1e-3 of the
    largest output); the pipelined call's time beside the unpipelined
    one's."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _time_ms
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.common import DTypes, layer_slice
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.pipeline import make_pipelined_apply

    mesh = make_mesh((world,), ("pipe",), "cuda")
    ws = torch.stack([torch.eye(8, device="cuda") * (i + 1) for i in range(world)])
    xs = torch.randn((PIPE_MICRO, 3, 8), generator=torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    toy = make_pipelined_apply(mesh, lambda w, x: x @ w, PIPE_MICRO)(ws, xs)
    toy_err = (toy - xs * 24).abs().max().item()

    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=world,
                              param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                              attn_impl="flash")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    layers = get_model(cfg).init(gen, device="cuda")["layers"]
    dt = DTypes(param=cfg.param_dtype, compute=cfg.compute_dtype)
    positions = torch.arange(PIPE_S, device="cuda")[None]

    def stage(lp, x):
        return transformer._layer_fwd(lp, cfg, x, positions, None, True, dt)[0]

    x = torch.randn((PIPE_MICRO, 1, PIPE_S, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    apply = make_pipelined_apply(mesh, stage, PIPE_MICRO)

    def unpiped():
        outs = []
        for m in x:
            for i in range(world):
                m = stage(layer_slice(layers, i), m)
            outs.append(m)
        return torch.stack(outs)

    with torch.inference_mode():
        got = apply(layers, x)
        want = unpiped()
        dist.barrier()
        piped_ms = _time_ms(lambda: apply(layers, x), iters=5, warmup=1)
        one_ms = _time_ms(unpiped, iters=5, warmup=1) if rank == 0 else 0.0
    rel = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    if rank == 0 or toy_err >= 1e-4 or rel > 1e-3:
        print(f"pipe_cards rank {rank}: the reference's test, {world} stages x {PIPE_MICRO} "
              f"microbatches: max |err| against x * 24 {toy_err:.3e} (tol 1e-4); a "
              f"{cfg.name} layer a stage, {PIPE_MICRO} microbatches of 1 x {PIPE_S} tokens: "
              f"max |err| against the layers in turn on one card {rel:.3e} of the largest "
              f"output (tol 1e-3); pipelined {piped_ms:.2f} ms a call ({PIPE_MICRO + world - 1} "
              f"ticks), one card {one_ms:.2f} ms [{smi}]", flush=True)
    if toy_err >= 1e-4 or rel > 1e-3:
        raise RuntimeError(f"pipe_cards rank {rank}: toy {toy_err}, layers {rel}")


def _pipe_cards_rank(rank: int, world: int, port: int, smi: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        pipe_cards_rank(rank, world, smi)
    finally:
        dist.destroy_process_group()


def pipe_cards(smi: str) -> None:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = torch.cuda.device_count()
    if world != PIPE_STAGES:
        sys.exit(f"pipe_cards needs {PIPE_STAGES} cards, found {world}")
    print(f"pipe_cards: {world} ranks, one a card, NCCL [{smi}]", flush=True)
    mp.start_processes(_pipe_cards_rank, args=(world, free_port(), smi), nprocs=world,
                       join=True, start_method="spawn")


HBM_BYTES_S = 3.35e12


def _adamw_shapes() -> dict:
    """The benchmark cells' leaves, from the port's model as portbench
    configures it."""
    from portbench import bench
    from portbench.runners import train
    from repro_torch.models.model_zoo import get_model

    return get_model(train.program_config(bench.find_cell("moe-train-1k"))).param_shapes()


def _events_ms(fn, n: int, warmup: int = 2) -> list:
    """CUDA events round each of ``n`` calls after ``warmup``: ms a call."""
    import torch

    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def profile_adamw(smi: str) -> None:
    import math

    import torch

    from portbench import trace
    from repro_torch.kernels.adamw import adamw as fused
    from repro_torch.models.common import ParamTree
    from repro_torch.train import optimizer as opt_lib

    shapes = _adamw_shapes()
    n = sum(math.prod(s) for s in shapes.values())
    cfg = opt_lib.AdamWConfig(lr=3e-4, b2=0.95, weight_decay=0.1, grad_clip=1.0, warmup_steps=2,
                              total_steps=2000)
    print(f"adamw: {len(shapes)} leaves, {n} params (bf16), f32 moments [{smi}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cell, g_dtype in (("moe-train-1k", torch.bfloat16), ("moe-train-8k", torch.float32)):
        g_size = torch.empty((), dtype=g_dtype).element_size()
        bound_ms = n * (2 * g_size + 2 + 2 + 16) / HBM_BYTES_S * 1e3
        params = ParamTree.from_state_dict({
            k: (0.02 * torch.randn(s, generator=gen, device="cuda")).bfloat16()
            for k, s in shapes.items()})
        grads = {k: torch.randn(s, generator=gen, device="cuda").to(g_dtype)
                 for k, s in shapes.items()}
        state = opt_lib.init(cfg, params)
        for k in shapes:
            state.mu[k].normal_(0, 1e-3, generator=gen)
            state.nu[k].normal_(0, 1e-3, generator=gen).square_()
        named = {k: p.detach() for k, p in params.named_parameters()}
        leaves = [fused.Leaf(p, grads[k], state.mu[k], state.nu[k], p.dim() >= 2)
                  for k, p in named.items()]
        lr, b1c, b2c = opt_lib.step_scalars(cfg, 5)
        hyper = opt_lib.kernel_scalars(cfg, lr, b1c, b2c)
        norm = fused.sum_sq(list(grads.values()), root=True)
        fused.reset_launch_counts()
        step = _events_ms(lambda: opt_lib.apply(cfg, state, params, grads), 10)
        launches = fused.launch_counts()
        norm_ms = _events_ms(lambda: fused.sum_sq(list(grads.values()), root=True), 10)
        upd_ms = _events_ms(lambda: fused.update(leaves, norm, hyper), 10)

        def plain():
            gn = opt_lib._sum_sq_plain(grads.values(), root=True)
            opt_lib._update_plain(cfg, named, grads, state.mu, state.nu, gn, lr, b1c, b2c)

        plain_ms = _events_ms(plain, 3, warmup=1)
        best = min(step)
        print(f"adamw {cell}: apply {best:.3f} ms (median {sorted(step)[len(step) // 2]:.3f}, "
              f"launches {launches} over 12 calls), norm+root {min(norm_ms):.3f} ms, update "
              f"{min(upd_ms):.3f} ms; bound {bound_ms:.3f} ms ({n * (2 * g_size + 20) / 1e9:.2f} "
              f"GB at 3.35 TB/s): {100 * bound_ms / best:.1f} % of it; plain "
              f"{min(plain_ms):.3f} ms ({min(plain_ms) / best:.2f}x)", flush=True)
        t = trace.profiled(lambda: (opt_lib.apply(cfg, state, params, grads),
                                    torch.cuda.synchronize()), 3)
        kern = {}
        for name, s0, e0 in t.kernels():
            kern[name] = kern.get(name, 0.0) + (e0 - s0) / 1e3 / t.steps
        ours = sum(v for k, v in kern.items() if "adamw_" in k)
        print(f"adamw {cell} traced: label optimizer.apply {t.label_us.get('optimizer.apply', 0) / 1e3 / t.steps:.3f} "
              f"ms a call, the adamw kernels {ours:.3f} ms, all kernels {sum(kern.values()):.3f} "
              f"ms: {sorted(kern.items(), key=lambda kv: -kv[1])[:5]}", flush=True)
        del params, grads, state, named, leaves, norm, t
        torch.cuda.empty_cache()
    # the library yardstick, all f32 (its fused step takes one dtype)
    ps = [torch.nn.Parameter(0.02 * torch.randn(s, generator=gen, device="cuda"))
          for s in shapes.values()]
    for p in ps:
        p.grad = torch.randn(p.shape, generator=gen, device="cuda")
    opt = torch.optim.AdamW(ps, lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                            fused=True)
    lib_step = _events_ms(opt.step, 5)

    def lib_clip_step():
        torch.nn.utils.clip_grad_norm_(ps, 1.0, foreach=True)
        opt.step()

    lib_both = _events_ms(lib_clip_step, 5)
    lib_bytes = n * 28 + n * 12  # the step: g 4, p, mu, nu 8 each; the clip: read g, scale it
    print(f"adamw library: torch.optim.AdamW(fused=True) f32 {min(lib_step):.3f} ms, with "
          f"clip_grad_norm_(foreach) {min(lib_both):.3f} ms ({lib_bytes / 1e9:.1f} GB: "
          f"{100 * lib_bytes / HBM_BYTES_S * 1e3 / min(lib_both):.1f} % of 3.35 TB/s)",
          flush=True)


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
        if name in ("flash_ab", "scan_ab", "flow_ab", "flow_ablate"):
            {"flash_ab": flash_ab, "scan_ab": scan_ab, "flow_ab": flow_ab,
             "flow_ablate": flow_ablate}[name](smi, args.pop(0))
            continue
        {"serve": profile_serve, "train": profile_train, "serve_hybrid": profile_serve_hybrid,
         "train_dist": profile_train_dist, "dist_cards": dist_cards,
         "serve_moe": profile_serve_moe, "moe_cards": moe_cards,
         "elastic_cards": elastic_cards, "train_e2e": profile_train_e2e,
         "xlstm_agreement": xlstm_agreement, "flash_ablate": flash_ablate,
         "scan_ablate": scan_ablate,
         "serve_gemma3": lambda smi: profile_serve_family(smi, "gemma3-4b"),
         "serve_vlm": lambda smi: profile_serve_family(smi, "qwen2-vl-2b"),
         "serve_whisper": lambda smi: profile_serve_family(smi, "whisper-large-v3"),
         "train_gemma3": profile_train_gemma3, "family_cards": family_cards,
         "pipe_cards": pipe_cards, "tp_cards": tp_cards,
         "moe_axes_cards": moe_axes_cards, "sp_cards": sp_cards,
         "sp_family_cards": sp_family_cards, "flow": profile_flow,
         "dadd_chain": dadd_chain, "adamw": profile_adamw}[name](smi)


if __name__ == "__main__":
    main()
