#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. env     torch/CUDA versions, the card, its power limit; TF32 off.
2. build   nvcc builds every kernel source of the main paths (in parallel),
           with the -Xptxas -v register / shared-memory lines (the flow
           kernels' source included).
3. kernel  each kernel against its plain PyTorch version on the card, case
           by case (flash_fwd; flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv;
           ssd_fwd; mlstm_fwd), then timed at its main path's shape
           (serving prefill for flash_fwd, the training step for the other
           flash kernels, zamba2-7b and xlstm-125m at 4 x 1024 tokens for
           the scans) beside its bound and, where one exists, the library
           call that computes the same function.  flash_fwd is also timed
           at gemma3-4b's prefill (Dh 320, local and global layers),
           whisper-large-v3's encoder and cross-attention and qwen2-vl-2b's
           prefill, and the f32 forward at a ragged Dh-320 shape and at
           gemma3-4b's head geometry (FAMILY_TIMED); flash_fwd_lse,
           flash_bwd_dq and flash_bwd_dkv at gemma3-4b's training shape (Dh
           320, 2 x 2048 tokens, local and global layers) and in f32 (the
           3xTF32 kernels) at the ragged Dh-320 shape, at gemma3-4b's head
           geometry and at llama3.2-3b's training shape (BWD_TIMED), the f32
           lines beside both bounds (3xTF32 and f32 SIMT) and each backward
           pair beside aten's whole backward.  Every case's backward runs
           twice and must give the same bits.  ssd_fwd and mlstm_fwd are
           also timed at the hybrid and xLSTM training shapes
           (``SCAN_TRAIN_TIMED``: zamba2-7b's 4 x 256 tokens and a rank's
           row of them, xlstm-125m's 4 x 256 and a rank's half of the rows
           and heads).  AdamW's three kernels (``kernels/adamw``) at the
           train phase's table (llama3.2-3b's leaves, bf16 params and
           gradients, f32 moments): the norm the same bits in two runs and
           within rel 1e-5 of the plain f32 sum's, each leaf's moments within
           4 f32 ulps and its params within 1 bf16 ulp of the plain update
           from the same state and norm; each kernel timed beside its plain
           version, its byte bound and PyTorch's own (``_foreach_norm``,
           ``torch.optim.AdamW(fused=True)``).
3b. flow  the network core (``core/compiled_flow.py``, the four kernels of
           ``kernels/flow``): every kernel call of the exact and symmetry
           sweeps on RailX and torus 16 (m 2, 1,024 chips) and of an ECMP
           pass (num_paths 2, ``edge_ok``-masked levels) held against its
           plain version on the card, call by call (every tensor a BFS level
           writes, the queue, edges, child offsets, depths, ranks, ``win``
           and the sizes, equal, its scratch left zero; counts equal, loads
           the same bits), and the whole results against the CPU's;
           each kernel timed call by call beside its plain version at the
           main path's shapes (the 4,096-chip exact sweep in batches of
           256 sources, the 102,400-chip orbit gather beside the column
           sum ``C.view(G, R).sum(0)``, the ECMP fold beside
           ``torch.bincount``), bound by its bytes at 3.35 TB/s, the fold
           also by its serial floor (its longest run of dependent f64 adds
           at the latency ``chip_profile.py dadd_chain`` measured,
           ``DADD_NS``).  Then
           the main path, launch
           counts set to 0 before and read after: the Fig. 14 exact points
           from the registry's dict networks (RailX and torus 32, 4,096
           chips) and the symmetry points from its canonical builders
           (160, 102,400 chips), each ``==`` the reference's float recorded
           in BENCH_simulator.json; the ECMP all-to-all on RailX 8's dict
           network, equal to the same call on the CPU; the exact sweep at
           16,384 chips (RailX 64), whose counts must equal the symmetry
           sweep's on every representative edge.  Each sweep's wall time
           is printed beside the card.
3c. cluster  the MLaaS cluster twin (``repro_torch.cluster``), whose one
           piece of array work, each placement's flow-model goodput, routes
           on the card through ``flow_bfs_level`` and ``flow_ordered_fold``:
           bench_cluster's 128 x 128 day in full mode (flow goodput, circuit
           validation; flow launch counts set to 0 just before and read just
           after, both kernels launched), its summary equal to
           BENCH_cluster.json's recorded row and, with every job record and
           unrounded goodput, to the same day on the CPU; its wall time,
           events/s, each goodput miss's wall ms and launches.  Then a
           qwen3-8b job at its default plan on each of the four fabrics with
           a ``job_network`` (card == CPU), one goodput miss at
           ``max_flow_nodes`` 512 (its goodput ``==`` the reference's float,
           timed, its forests and launches counted), the MLaaS twin's two acts
           (``examples/torch/mlaas_allocation.py``; its asserts, its lines
           equal to the CPU run's) and bench_serving's mixed day on
           railx-hyperx, fixed and autoscale, 16 x 16, 24 h, at the H100
           service model (card fingerprint == CPU's; SLO attainments
           printed).
4. model   a small llama-shaped f32 model on the card (flash kernels)
           against the same weights on the CPU (plain path): a forward, two
           train steps (remat on the card), and a checkpoint round trip;
           then the zamba2 and xlstm smoke models the same way (SSD and
           mLSTM kernels): a forward and 3 decode steps; then moonshot-smoke
           (MoE, 4 experts top-2): a forward (logits, aux), two train steps
           (loss, aux, grad_norm) and 3 decode steps, with the share of
           token -> expert choices that agree between card and CPU (all
           must agree); then gemma3-smoke (2 x 100 tokens, past its window
           of 8), qwen2-vl-smoke (embeddings at patch-grid positions3) and
           whisper-smoke (40 encoder frames): a forward, a one-call fill and
           3 decode steps, within 1e-3 (``family_agreement``); then the
           same three and gemma3-smoke widened to Dh 320: two train steps
           (remat, flash kernels) against the CPU at the small llama's
           tolerances (``family_train_agreement``); then zamba2-smoke (SSD
           kernel, remat) two train steps the same way and xlstm-smoke's two
           steps' gradients from the CPU's params, leaf by leaf
           (``recurrent_train_agreement``).
5. serve   llama3.2-3b at full width in bf16, random weights from a seed:
           8 requests of 1024-token prompts, 32 new tokens each, in two
           waves of 4 slots; counts the kernel launches of that run.
6. serve_hybrid  zamba2-7b at full width and depth in bf16 (81 Mamba2
           layers, 112 SSD heads): 4 requests of 256-token prompts, 16 new
           tokens each, one wave; the cache is filled token by token; 81
           ssd_fwd launches per prefill and no flash launch.
7. serve_xlstm   xlstm-125m at full size in bf16: 4 requests of 1024-token
           prompts, 32 new tokens each, one wave; 9 mlstm_fwd launches per
           prefill; then each mLSTM layer's kernel form against its
           recurrent form on the prompts, and the same weights in f32.
8. serve_moe  moonshot-v1-16b-a3b at full width and depth in bf16 (48
           layers, 64 experts top-6, 28.06 B params): the init's peak
           memory (< 60 GiB), then 4 requests of 1024-token prompts, 32 new
           tokens each, one wave; 48 flash_fwd launches per prefill; the
           prefill against the one-call cache fill over every prompt
           position, argmax agreement above the reference's MoE bound (0.7)
           and the rms of the difference within 0.1 of the logits' std.
   serve_gemma3, serve_vlm, serve_whisper  gemma3-4b (4.01 B params,
           Dh 320, 4 x 2048-token prompts: the window of 1024 binds on its
           29 local layers), qwen2-vl-2b (4 x 1024 positions as embeddings
           at a 32 x 32 patch grid's positions3, the decoded tokens at 32 +
           step) and whisper-large-v3 (4 x 1500 encoder frames, 4 x
           224-token prompts) at full size in bf16, 32 new tokens, one wave
           of 4: all answered, one flash_fwd an attention layer of the
           prefill (gemma3: 34, 29 of them windowed, recorded by
           ``flash_windows``; vlm: 28; whisper: 96, plus 32 in the encode
           that fills the cache's enc_out), prefill against the one-call
           fill within the dense bounds.
9. train   llama3.2-3b at full width and depth in bf16 (f32 moments),
           remat, flash attention: 8 AdamW steps of 4 x 1024 tokens through
           ``train_loop``; the loss must fall, and the launches of that run
           must be 2L flash_fwd_lse, L flash_bwd_dq and L flash_bwd_dkv per
           step and no flash_fwd, and one each of adamw_sum_sq,
           adamw_norm_finalize and adamw_update per step.
9b. dryrun_check  the dry run of phase 9's cell (``launch/roofline.py``:
           the same step traced on the meta device): its argument bytes
           must equal phase 9's parameters plus moments, and its reckoned
           peak be within 15 % of phase 9's ``max_memory_allocated``;
           prints its compute and memory terms beside the measured step.
10. train_moe  moonshot-v1-16b-a3b at full width, depth cut to 4 layers,
           the same way: the loss must fall, aux be > 0 every step, and the
           launches be the train phase's per layer.
11. train_dist  the same model, seed and data through the distributed
           ``manual_hier`` step on a world of one (NCCL, mesh (1, 1, 1)
           ("pod", "data", "model"); its params the blocks of its layout,
           which on one rank are the whole leaves, the loss through
           ``zoo.shard_plan``): 8 steps of the ``hierarchical``
           schedule, whose per-step loss and grad_norm must equal phase 9's
           within rel 1e-5 and whose launches must equal phase 9's, then 3
           steps of ``flat`` against them; the ``compressed`` schedule is
           refused there (no pod axis of size > 1).  Prints each schedule's
           steady step time beside phase 9's.
12. train_fsdp  the same model, seed and data through the sharded
           ``gspmd_fsdp`` step (the default dp_mode with a mesh) on the same
           world of one: params and AdamW moments stored as the rank's blocks
           of the reference's layout (``param_layout``; on one rank the
           blocks are the whole leaves), each layer's leaves gathered inside
           its rematerialised function, the global loss and grad norm.  8
           steps whose losses and grad_norms must equal phase 9's within rel
           1e-5 and whose launches must equal phase 9's; prints its steady
           step time and peak memory beside phase 9's.
13. train_moe_fsdp  phase 10's model, seed and data through ``gspmd_fsdp``
           on that world of one: the MoE layers expert-parallel (an
           all-to-all over a "data" axis of one); losses, aux and grad_norms
           within rel 1e-5 of phase 10's, the same launches.
14. train_gemma3, train_vlm, train_whisper  gemma3-4b (2 x 2048 tokens a
           step, the backward at Dh 320; 29 of each 34 flash calls with the
           window of 1024, recorded by ``flash_windows``), qwen2-vl-2b (4 x
           1024 tokens at a 32 x 32 patch grid's positions3, 2 microbatches)
           and whisper-large-v3 (4 x 1500 encoder frames, 4 x 448 decoder
           tokens) at full width and depth in bf16 (f32 moments), remat,
           flash: 8 AdamW steps each; the loss must fall by 0.5 nats and the
           launches be 2 flash_fwd_lse and one each of flash_bwd_dq and
           flash_bwd_dkv an attention a microbatch a step.
14b. train_hybrid, train_xlstm  zamba2-7b at full width cut to 12 layers
           (4 x 256 tokens a step; 1.28 B leaves) and xlstm-125m whole (4 x 256)
           in bf16 with remat: 8 AdamW steps each; zamba2's loss must fall by
           0.5 nats (xLSTM's drop is reported), the launches be 24 ssd_fwd /
           18 mlstm_fwd a step; MFU on the leaves' count.  Both scans'
           backwards replay the sequential scan: host-bound steps.
14c. train_fsdp_families  on the world of one, ``gspmd_fsdp`` for
           zamba2-7b (12 layers), xlstm-125m, whisper-large-v3 and
           qwen2-vl-2b: 3 steps each whose losses and grad_norms must equal
           their one-process phase's first 3 within rel 1e-5, launches too.
14d. serve_sharded_families  ``make_serve_step(mesh=)`` on a world of one
           ((1, 1) "data", "model") for the same four at full width in bf16:
           a prefill of 4 x 256 tokens and 4 decode calls from a fresh cache
           against the unsharded serve of the same params (rel 1e-5).
14e. pipeline  ``parallel/pipeline.py`` with one stage (a world of one,
           (1,) "pipe"): a llama3.2-3b layer over 4 microbatches of 1 x 1024
           tokens, the same bits as the layer applied unpipelined.
15. train_e2e  railx-100m (examples/train_end_to_end.py: 12 layers, d_model
           768, 12 / 4 heads, vocab 16384, f32) through the twin's ``run``
           (``examples/torch/train_end_to_end.py``) on a world of one, mesh
           (1, 1, 1), ``gspmd_fsdp`` with 2 microbatches, the reference's data
           (16 x 128 tokens a step) and AdamW, with attn_impl "flash" (the
           only change from the reference's config): 3 steps of each
           attention path from the same seed (loss rel 1e-5, grad_norm rel
           1e-4), then the reference's 300 steps; the loss must fall by 0.5
           nats and the launches be L x 2 of each of flash_fwd_lse,
           flash_bwd_dq and flash_bwd_dkv a step (the f32 3xTF32 kernels) and
           nothing else.
16. examples  the smoke-size twins on worlds of one, each to its reference
           assertion: the fault drill (phase 1 on (1, 1), phase 2 restoring
           with resharding on a fresh (1, 1) world), quickstart steps 1-3 and
           step 4 on (1, 1, 1), serve_decode on (1, 1) under a port
           ``Tracer`` (its trace valid, one serve.decode_step span a decode
           call).

Every phase prints its wall time on a ``clock:`` line, and the run its
total.  Every serve and train phase sets all launch counts to 0 before it runs and
reads them after; the ``kernels`` line reports each kernel's launches from
the phase whose path it serves, the Dh-320 kernels (``*_d320``) from
serve_gemma3 and train_gemma3, the f32 kernels (``*_f32``, timed at
railx-100m's training shape, bound at the 3xTF32 rate) from train_e2e, the
flow kernels (``flow_*``) from phase flow's main path, AdamW's (``adamw_*``)
from phase train.

Then the ``kernels`` JSON line and, last, the ``ok`` JSON line.  It needs a
CUDA device and the rest of the repository: without either it fails before
printing any result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from typing import Optional
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 SIMT, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

BF16_TOL = 2e-2   # abs, unit-variance inputs: bf16 probabilities and output
F32_TOL = 1e-4    # abs: f32 throughout, only the summation order differs
# lse is f32 from scores the kernel and the plain version both sum in f32
LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
# gradients, relative to the largest |value| of the plain version's output:
# bf16 rounds P and dS as mma operands (2^-9 relative) and the output
# (2^-9); dk/dv sum Sq x group such terms, so their error grows with the
# sum and is held against the sum's scale.  f32: summation order only.
GRAD_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_env():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"env: allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"env: card {smi}", flush=True)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.adamw import adamw
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flow import flow
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.ssd import ssd

    sources = [fa.SOURCE, fa.BWD_SOURCE, ssd.SOURCE, mlstm.SOURCE, flow.SOURCE, adamw.SOURCE]
    t0 = time.perf_counter()
    build.build_all(sources)
    print(f"build: {len(sources)} source(s) in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        info = build.BUILD_INFO[src]
        print(f"build: {src} nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"build:   {line.strip()}")
    # the TMA / wgmma kernels keep their products' fragments in registers
    # (at Dh 320 a 160-register accumulator a thread beside them), and so
    # do the f32 kernels (3xTF32 mma.sync; at Dh 320 80 registers of O, dQ,
    # dK or dV a thread): each instantiation must build without spilling
    f32_dims = "Dh 16, 32, 64, 128, 320"
    for src, kernel, want in ((fa.SOURCE, "flash_fwd_wgmma_kernel", "Dh 64, 128, 320"),
                              (fa.SOURCE, "flash_fwd_tf32_kernel", f32_dims),
                              (fa.BWD_SOURCE, "flash_bwd_dq_wgmma_kernel", "Dh 64, 128, 320"),
                              (fa.BWD_SOURCE, "flash_bwd_dkv_wgmma_kernel", "Dh 64, 128, 320"),
                              (fa.BWD_SOURCE, "flash_bwd_dq_tf32_kernel", f32_dims),
                              (fa.BWD_SOURCE, "flash_bwd_dkv_tf32_kernel", f32_dims)):
        spills = _spill_stores(build.BUILD_INFO[src]["log"], kernel)
        print(f"build: {kernel} instantiations {len(spills)}, spill stores "
              f"{sorted(spills.values())} bytes", flush=True)
        if len(spills) != len(want.split(",")) or any(spills.values()):
            fail(f"{kernel} should build once for each of {want} without spills: {spills}")
    sys.stdout.flush()


def _spill_stores(log: str, kernel: str) -> dict:
    """{entry: bytes of spill stores} of each entry function of ``kernel``
    in nvcc's -Xptxas -v output."""
    spills, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry and kernel in entry:
            spills[entry] = int(line.split("bytes spill stores")[0].split(",")[-1])
    return spills


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """CUDA events around ``iters`` back-to-back calls: the device time per
    call where the host keeps ahead, the host's time where it does not."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: CUDA events around replays of a CUDA graph of
    ``iters`` calls, so no host work lies between the launches.  A kernel
    launched through ctypes on the capturing stream is captured with its
    arguments (the tensor maps by value)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # builds, plans and allocations happen outside the graph
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
    return start.elapsed_time(end) / (iters * replays)


def _host_us(fn, iters: int = 50) -> float:
    """Host time per call, with the device left to catch up afterwards."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / iters * 1e6


# name, B, H, Hk, Sq, Skv, Dh, causal, window, q_offset, dtype, layout.  bf16
# at Dh 64, 128 and 320 runs the TMA / wgmma kernel (128-row q tiles over
# 128-key tiles, 48-key at Dh 320), Dh 16 and 32 the mma.sync one; f32 the
# 3xTF32 one (64-row blocks, the keys split at small grids); "model"
# passes q/k/v as the transposed views of (B, S, H, Dh) that
# ops.flash_attention passes.
FLASH_CASES = [
    ("serve_prefill", 4, 24, 8, 1024, 1024, 128, True, None, 0, "bfloat16", "kernel"),
    ("serve_prefill_model", 4, 24, 8, 1024, 1024, 128, True, None, 0, "bfloat16", "model"),
    ("ragged_1000", 2, 24, 8, 1000, 1000, 128, True, None, 0, "bfloat16", "kernel"),
    ("ragged_130", 2, 24, 8, 130, 130, 128, True, None, 0, "bfloat16", "kernel"),  # 2-row tile
    ("ragged_333_d64", 2, 8, 4, 333, 333, 64, True, None, 0, "bfloat16", "model"),
    ("window_256", 2, 24, 8, 1024, 1024, 128, True, 256, 0, "bfloat16", "kernel"),
    ("window_200", 2, 24, 8, 1024, 1024, 128, True, 200, 0, "bfloat16", "model"),
    ("q_offset_960", 2, 24, 8, 64, 1024, 128, True, None, 960, "bfloat16", "kernel"),  # Sq < 128
    ("gqa3_d64", 2, 12, 4, 512, 512, 64, True, None, 0, "bfloat16", "kernel"),
    ("mqa_hk1", 2, 48, 1, 512, 512, 128, True, None, 0, "bfloat16", "kernel"),
    ("mqa_hk1_d64", 1, 16, 1, 300, 300, 64, True, None, 0, "bfloat16", "model"),
    ("non_causal", 2, 8, 4, 384, 320, 64, False, None, 0, "bfloat16", "kernel"),
    ("head_dim_32", 2, 4, 2, 200, 200, 32, True, None, 0, "bfloat16", "kernel"),
    ("head_dim_16", 2, 4, 2, 64, 64, 16, True, None, 0, "bfloat16", "kernel"),
    ("f32", 2, 8, 2, 1000, 1000, 128, True, None, 0, "float32", "kernel"),
    ("f32_window_d64", 2, 4, 4, 256, 256, 64, True, 48, 0, "float32", "kernel"),
    # window without causal: rows at q >= 143 see no key and average v
    ("no_visible_key", 1, 4, 2, 64, 128, 64, False, 16, 100, "bfloat16", "kernel"),
    ("no_visible_key_d128", 1, 4, 2, 64, 128, 128, False, 16, 100, "bfloat16", "kernel"),
    ("no_visible_key_f32", 1, 4, 2, 64, 128, 64, False, 16, 100, "float32", "kernel"),
    # moonshot-v1-16b-a3b's prefill and training shape: MHA (a group of 1)
    ("moonshot_prefill", 4, 16, 16, 1024, 1024, 128, True, None, 0, "bfloat16", "model"),
    # gemma3-4b's prefill at Dh 320 (the wgmma kernel at 48-key tiles): its
    # local layers' window of 1024 binds on half the rows
    ("gemma3_local", 4, 8, 4, 2048, 2048, 320, True, 1024, 0, "bfloat16", "model"),
    ("gemma3_global", 4, 8, 4, 2048, 2048, 320, True, None, 0, "bfloat16", "model"),
    ("d320_ragged_f32", 1, 4, 2, 333, 333, 320, True, None, 0, "float32", "kernel"),
    # the f32 forward (3xTF32) at gemma3-4b's head geometry
    ("gemma3_global_f32", 1, 8, 4, 2048, 2048, 320, True, None, 0, "float32", "kernel"),
    ("d320_ragged_q_offset", 2, 4, 2, 200, 1100, 320, True, 700, 900, "bfloat16", "kernel"),
    ("no_visible_key_d320", 1, 4, 2, 64, 128, 320, False, 16, 100, "bfloat16", "kernel"),
    # whisper-large-v3: the encoder (1500 frames, not a multiple of the
    # 128-key tile) and the decoder's cross-attention, MHA at Dh 64, not causal
    ("whisper_enc", 4, 20, 20, 1500, 1500, 64, False, None, 0, "bfloat16", "model"),
    ("whisper_cross", 4, 20, 20, 224, 1500, 64, False, None, 0, "bfloat16", "model"),
    # qwen2-vl-2b's prefill: a GQA group of 6
    ("qwen2vl_prefill", 4, 12, 2, 1024, 1024, 128, True, None, 0, "bfloat16", "model"),
    # gemma3-4b's training shape (2 x 2048 tokens, Dh 320): the forward with
    # lse, dq and dk/dv (all wgmma), local and global layers
    ("gemma3_train_local", 2, 8, 4, 2048, 2048, 320, True, 1024, 0, "bfloat16", "model"),
    ("gemma3_train_global", 2, 8, 4, 2048, 2048, 320, True, None, 0, "bfloat16", "model"),
    # llama3.2-3b's training shape at the configs' default dtype, f32: the
    # 3xTF32 forward with lse, dq and dk/dv
    ("llama_train_f32", 4, 24, 8, 1024, 1024, 128, True, None, 0, "float32", "model"),
    # railx-100m's training shape (examples/train_end_to_end.py): f32, GQA
    # group 3, one of 2 microbatches of 16 x 128 tokens; the kernels line's
    # *_f32 entries come from it
    ("railx100m_train_f32", 8, 12, 4, 128, 128, 64, True, None, 0, "float32", "model"),
    # a rank's training shape of qwen3-8b under TP on (1, 2, 2)
    # (chip_profile.py tp_cards): 2 x 1024 tokens, 16 of 32 heads, 4 of 8 KV
    ("qwen3_rank_train", 2, 16, 4, 1024, 1024, 128, True, None, 0, "bfloat16", "model"),
    # a rank's training shape of llama3.2-3b under sequence parallelism over
    # four ranks (chip_profile.py sp_cards): its 256 of 1024 positions of 4
    # rows attend over all 1024 keys, gathered over "model" ("gathered"
    # layout), the first and the last rank; on the first the keys past its
    # last query take no gradient
    ("llama_sp_rank0", 4, 24, 8, 256, 1024, 128, True, None, 0, "bfloat16", "gathered"),
    ("llama_sp_rank3", 4, 24, 8, 256, 1024, 128, True, None, 768, "bfloat16", "gathered"),
]
# the cases of the gemma3, whisper and vlm serving paths and of the f32
# forward (the model phase's f32 checks), timed beside their bounds in the
# kernel phase; the f32 ones beside the memory-efficient backend, the only
# sdpa backend that takes f32 at Dh 320
FAMILY_TIMED = ("gemma3_local", "gemma3_global", "d320_ragged_f32", "gemma3_global_f32",
                "whisper_enc", "whisper_cross", "qwen2vl_prefill")
# the cases of the gemma3 training path, and of the f32 kernels (Dh 320 at a
# ragged shape and at gemma3-4b's head geometry, llama3.2-3b's and
# railx-100m's training shapes), whose forward with lse and backward are
# timed beside their bounds; gemma3_train_global's times go into the kernels
# line (the *_d320 entries), railx100m_train_f32's (the *_f32 entries, at
# the 3xTF32 bound)
BWD_TIMED = ("d320_ragged_f32", "gemma3_global_f32", "gemma3_train_local",
             "gemma3_train_global", "llama_train_f32", "railx100m_train_f32",
             "qwen3_rank_train", "llama_sp_rank0", "llama_sp_rank3")


def _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed, layout="kernel"):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(b, h, s, d, kv=False):
        if layout == "gathered" and kv:  # all-gathered over position blocks: (S, B, Hk, Dh)
            x = torch.randn((s, b, h, d), generator=g, device="cuda", dtype=torch.float32)
            return x.to(dt).movedim(0, 1).transpose(1, 2)
        if layout in ("model", "gathered"):
            x = torch.randn((b, s, h, d), generator=g, device="cuda", dtype=torch.float32)
            return x.to(dt).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=g, device="cuda", dtype=torch.float32).to(dt)

    return randn(B, H, Sq, Dh), randn(B, Hk, Skv, Dh, True), randn(B, Hk, Skv, Dh, True)


def _bound(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms) -> dict:
    """``source`` and ``replaces`` are paths under src/repro_torch and
    src/repro."""
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/{source}",
        "replaces": f"src/repro/{replaces}",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
    }


def _flash_entry(name, source, line, *rest) -> dict:
    return _entry(name, f"kernels/flash_attention/csrc/{source}",
                  f"kernels/flash_attention/flash_attention.py:{line}", *rest)


def reset_launch_counts() -> None:
    """The LLM paths' kernels (the flow kernels' counts are phase_flow's)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.ssd import ssd

    for mod in (fa, ssd, mlstm):
        mod.reset_launch_counts()


def launch_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.ssd import ssd

    return {**fa.launch_counts(), **ssd.launch_counts(), **mlstm.launch_counts()}


def phase_kernel() -> list:
    kernels = [*_flash_fwd_kernel(), *_training_kernels(), _ssd_kernel(), _mlstm_kernel()]
    for kname, where, shape in SCAN_TRAIN_TIMED:
        time_scan(kname, where, shape)
    return kernels + _adamw_kernels()


# AdamW's kernels against the plain update from the same state and norm: f32
# ulps for the moments, bf16 ulps for the params (the chain's roundings may
# differ: an add with alpha is one fma in the kernel; PyTorch's CUDA kernels
# divide by a scalar as a product with its reciprocal, the kernel divides)
ADAMW_ULPS = {"mu": (4, 24), "nu": (4, 24), "p": (1, 8)}  # (most, significand bits)
ADAMW_NORM_REL = 1e-5


def _adamw_state(i: int, shape, g: bool = False):
    """Leaf ``i``'s bf16 params and f32 moments as a few steps in (or, with
    ``g``, its bf16 gradient of unit normals: the norm clips), the same
    tensors every call."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1000 * (1 + g) + i)
    if g:
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    p = (0.02 * torch.randn(shape, generator=gen, device="cuda")).bfloat16()
    mu = 1e-3 * torch.randn(shape, generator=gen, device="cuda")
    return p, mu, torch.square(1e-3 * torch.randn(shape, generator=gen, device="cuda"))


def _ulps(got, want, before, bits: int) -> float:
    """The largest |got - want| in units of the last place (of ``bits``
    significand bits) at the larger of |got|, |want| and the value before
    the step (an update that nearly cancels a value leaves a result whose
    own ulp says nothing of the arithmetic)."""
    import torch

    worst = 0.0
    for a, b, c in zip(*(t.reshape(-1).split(1 << 25) for t in (got, want, before))):
        a, b, c = a.double(), b.double(), c.double()
        _, e = torch.frexp(torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs()))
        ulp = torch.ldexp(torch.ones_like(a), e - bits).clamp(min=2.0 ** -149)
        worst = max(worst, float(((a - b).abs() / ulp).max()))
    return worst


def _adamw_kernels() -> list:
    """AdamW's kernels at the train phase's table against the plain version,
    then timed; -> the kernels line's adamw_sum_sq, adamw_norm_finalize and
    adamw_update entries (their launches from phase train)."""
    import torch

    from repro_torch.kernels.adamw import adamw as fused
    from repro_torch.train import optimizer as opt_lib

    cfg, zoo, ocfg, _ = _train_setup()
    shapes = list(zoo.param_shapes().values())
    n = sum(math.prod(s) for s in shapes)
    leaves = []
    for i, s in enumerate(shapes):
        p, mu, nu = _adamw_state(i, s)
        leaves.append(fused.Leaf(p, _adamw_state(i, s, g=True), mu, nu, len(s) >= 2))
    grads = [leaf.g for leaf in leaves]
    lr, b1c, b2c = opt_lib.step_scalars(ocfg, 5)
    hyper = opt_lib.kernel_scalars(ocfg, lr, b1c, b2c)
    norm, again = fused.sum_sq(grads, root=True), fused.sum_sq(grads, root=True)
    plain_norm = opt_lib._sum_sq_plain(grads, root=True)
    fused.update(leaves, norm, hyper)
    torch.cuda.synchronize()
    norm_err = abs(float(norm) - float(plain_norm))
    print(f"kernel adamw: {cfg.name}'s {len(shapes)} leaves, {n} params, bf16 params and "
          f"gradients, f32 moments: norm {float(norm):.6f}, the same bits again "
          f"{torch.equal(norm, again)}, plain {float(plain_norm):.6f} (rel "
          f"{norm_err / float(plain_norm):.2e}, tol {ADAMW_NORM_REL:g})", flush=True)
    if not torch.equal(norm, again) or not norm_err <= ADAMW_NORM_REL * float(plain_norm):
        fail(f"adamw norm {float(norm)} / {float(again)} against plain {float(plain_norm)}")
    worst, p_err = dict.fromkeys(ADAMW_ULPS, 0.0), 0.0
    for i, (s, leaf) in enumerate(zip(shapes, leaves)):
        p, mu, nu = _adamw_state(i, s)
        p0, mu0, nu0 = p.clone(), mu.clone(), nu.clone()
        opt_lib._update_plain(ocfg, {"x": p}, {"x": leaf.g}, {"x": mu}, {"x": nu}, norm, lr,
                              b1c, b2c)
        for name, got, want, before in (("mu", leaf.mu, mu, mu0), ("nu", leaf.nu, nu, nu0),
                                        ("p", leaf.p, p, p0)):
            worst[name] = max(worst[name], _ulps(got, want, before, ADAMW_ULPS[name][1]))
        p_err = max(p_err, float((leaf.p.float() - p.float()).abs().max()))
        del p, mu, nu, p0, mu0, nu0
    print(f"kernel adamw_update: against the plain update, leaf by leaf: mu {worst['mu']:g}, nu "
          f"{worst['nu']:g} f32 ulps (tol {ADAMW_ULPS['mu'][0]}), params {worst['p']:g} bf16 ulps "
          f"(tol {ADAMW_ULPS['p'][0]}), max_abs_err {p_err:.3e}", flush=True)
    bad = {k: v for k, v in worst.items() if not v <= ADAMW_ULPS[k][0]}
    if bad:
        fail(f"adamw_update disagrees with the plain update: {bad} ulps")

    ops, sms = fused._ops(), torch.cuda.get_device_properties(0).multi_processor_count
    (part, code, blocks), = fused.sum_sq_launches(grads, sms)
    partials = torch.empty(blocks, dtype=torch.float64, device="cuda")
    out = torch.empty((), dtype=torch.float32, device="cuda")
    total = opt_lib._sum_sq_plain(grads)
    timed = {
        "adamw_sum_sq": (_time_ms(lambda: ops.sum_sq(part, code, blocks, partials, 0), 10),
                         _time_ms(lambda: opt_lib._sum_sq_plain(grads), 3, warmup=1),
                         2 * n + 8 * blocks,
                         _time_ms(lambda: torch.linalg.vector_norm(
                             torch.stack(torch._foreach_norm(grads))), 10)),
        "adamw_norm_finalize": (_graph_ms(lambda: ops.norm_finalize(partials, blocks, out, True)),
                                _graph_ms(lambda: torch.sqrt(total)), 8 * blocks + 4, None),
        "adamw_update": (_time_ms(lambda: fused.update(leaves, norm, hyper), 10),
                         _time_ms(lambda: opt_lib._update_plain(
                             ocfg, {i: lf.p for i, lf in enumerate(leaves)}, dict(enumerate(grads)),
                             {i: lf.mu for i, lf in enumerate(leaves)},
                             {i: lf.nu for i, lf in enumerate(leaves)}, norm, lr, b1c, b2c),
                             3, warmup=1),
                         22 * n + 4, None),
    }
    del leaves, grads, partials, out, total, norm, again, plain_norm, part
    torch.cuda.empty_cache()
    # PyTorch's fused AdamW takes one dtype for params, gradients and
    # moments: f32 throughout, 28 bytes a parameter against the kernel's 22
    gen = torch.Generator(device="cuda").manual_seed(7)
    ps = [torch.nn.Parameter(0.02 * torch.randn(s, generator=gen, device="cuda")) for s in shapes]
    for p in ps:
        p.grad = torch.randn(p.shape, generator=gen, device="cuda")
    opt = torch.optim.AdamW(ps, lr=lr, betas=(ocfg.b1, ocfg.b2), eps=ocfg.eps,
                            weight_decay=ocfg.weight_decay, fused=True)
    ms, plain_ms, nbytes, _ = timed["adamw_update"]
    timed["adamw_update"] = (ms, plain_ms, nbytes, _time_ms(opt.step, 5, warmup=2))
    del ps, opt
    torch.cuda.empty_cache()

    entries = []
    for kname, (ms, plain_ms, nbytes, library_ms) in timed.items():
        bound = (nbytes / PEAK_BYTES * 1e3, "bytes")
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"kernel {kname}: {ms:.4f} ms at {cfg.name}'s table ({nbytes / 1e9:.3f} GB); plain "
              f"{plain_ms:.4f} ms; library {lib}; bound {bound[0]:.4f} ms (bytes at 3.35 TB/s), "
              f"{bound[0] / ms:.1%} of it", flush=True)
        err = p_err if kname == "adamw_update" else norm_err
        # the reference's global_norm (:59) and apply (:66)
        line = 66 if kname == "adamw_update" else 59
        entries.append(_entry(kname, "kernels/adamw/csrc/adamw.cu", f"train/optimizer.py:{line}",
                              None, err, ms, plain_ms, bound, library_ms))
    return entries


def _flash_fwd_kernel() -> list:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    worst = worst_d320 = 0.0
    for i, (name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype,
            layout) in enumerate(FLASH_CASES):
        q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=i, layout=layout)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
        finite = bool(torch.isfinite(out).all())
        print(f"kernel flash_fwd {name}: B={B} H={H} Hk={Hk} Sq={Sq} Skv={Skv} Dh={Dh} "
              f"causal={causal} window={window} q_offset={q_off} {dtype} {layout} layout: "
              f"max_abs_err {err:.3e} (tol {tol:g})", flush=True)
        if not finite or not err <= tol:
            fail(f"flash_fwd {name} disagrees with attention_ref: {err} > {tol}")
        if name == "serve_prefill":
            worst = err
        if Dh == 320 and dtype == "bfloat16":
            worst_d320 = max(worst_d320, err)

    timed = _time_forward("flash_fwd", fa.flash_attention_fwd, attention_ref, with_lse=False)
    family = {case[0]: _time_flash_case(case) for case in FLASH_CASES if case[0] in FAMILY_TIMED}
    # the Dh-320 instantiation of flash_fwd_wgmma_kernel at gemma3-4b's global layer
    return [_flash_entry("flash_fwd", "flash_fwd.cu", 35, None, worst, *timed),
            _flash_entry("flash_fwd_d320", "flash_fwd.cu", 35, None, worst_d320,
                         *family["gemma3_global"])]


def _time_flash_case(case) -> tuple:
    """Time ``flash_fwd`` at one FLASH_CASES shape of the gemma3, whisper and
    vlm paths (its own layout) beside its bound, its plain version and the
    fastest sdpa backend that computes the same function, on one line;
    -> (ms, plain_ms, (bound_ms, bound_by), library_ms)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_mask, attention_ref

    name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype, layout = case
    q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=7, layout=layout)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    ms = _graph_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
    plain_ms = _time_ms(lambda: attention_ref(q, k, v, **kw), iters=3, warmup=1)
    mask = attention_mask(Sq, Skv, causal, window, q_off, "cuda")
    library = _fwd_yardsticks(q, k, v, False, causal=causal, mask=mask)
    lib_name = min(library, key=library.get) if library else None
    visible = int(mask.sum())
    flops = 4.0 * Dh * visible * B * H
    nbytes = _nbytes(q, k, v, q)
    bound = _bound(flops, nbytes, dtype)
    lib = (f"{library[lib_name]:.4f} ms, {lib_name}, kernel/library "
           f"{ms / library[lib_name]:.3f}") if library else "none takes this shape"
    tf32 = ""
    if dtype == "float32":  # the f32 kernel's own route: 3xTF32 on the tensor cores
        from repro_torch.kernels import bounds
        b = bounds._bound(flops, nbytes)
        tf32 = (f"; 3xTF32 bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                f"{b['bound_ms'] / ms:.1%} of it")
    print(f"kernel flash_fwd timing at {name} (B={B} H={H} Hk={Hk} Sq={Sq} Skv={Skv} Dh={Dh} "
          f"{dtype} causal={causal} window={window} {layout} layout): kernel {ms:.4f} ms device "
          f"(CUDA graph of 20 launches); plain {plain_ms:.4f} ms; library {lib}; bound "
          f"{bound[0]:.4f} ms ({bound[1]}: {flops:.4g} FLOP, {nbytes:.4g} B), "
          f"{bound[0] / ms:.1%} of bound{tf32}", flush=True)
    return ms, plain_ms, bound, library[lib_name] if library else None


def _sdpa_backend_used(q, k, v) -> str:
    """The device kernels of one unpinned sdpa call, by name."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"})
    return "; ".join(n[:80] for n in names) or "no device kernel seen"


def _runs(call) -> bool:
    """Whether ``call`` runs here (a pinned sdpa backend may refuse a shape;
    the reasons it warns of are dropped, the refusal is printed)."""
    import warnings

    import torch

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"kernel: yardstick refused: {str(e).splitlines()[0][:160]}", flush=True)
        return False
    return True


def _fwd_yardsticks(q, k, v, with_lse: bool, causal: bool = True, mask=None,
                    outputs=None) -> dict:
    """Library calls of PyTorch that compute the forward at the timed shape,
    timed as the kernel is: {label: ms}; ``outputs``, where given, gets each
    timed call's result by label.  Without lse: sdpa pinned to each
    backend that runs here (GQA through enable_gqa where the backend takes
    it, else k/v expanded to H heads outside the timing); with ``mask``
    (the visible keys, (Sq, Skv)) where a window or a q offset makes the
    mask other than plain causal; the MATH backend only where no fused one
    takes the shape.  With lse: aten's flash and cuDNN forwards, which
    return the logsumexp too (on k/v expanded to H heads: they take no
    GQA)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    H, Hk = q.shape[1], k.shape[1]
    ke, ve = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
    calls = {}
    if with_lse:
        for label, fn in (("aten._scaled_dot_product_flash_attention", lambda: (
                torch.ops.aten._scaled_dot_product_flash_attention(q, ke, ve, 0.0, True))),
                          ("aten._scaled_dot_product_cudnn_attention", lambda: (
                torch.ops.aten._scaled_dot_product_cudnn_attention(q, ke, ve, None, True, 0.0,
                                                                  True)))):
            if _runs(fn):
                calls[label] = fn
    else:
        # sdpa's own causal mask is the top-left triangle: anything else
        # (a window, a q offset, Sq != Skv) goes in as a bool mask
        if mask is None or (bool(mask.equal(torch.ones_like(mask).tril() if causal else
                                            torch.ones_like(mask)))
                            and (not causal or mask.shape[0] == mask.shape[1])):
            attn = dict(is_causal=causal)
        else:
            attn = dict(attn_mask=mask)
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
            if backend == SDPBackend.MATH and calls:
                break
            for gqa, kk, vv in ((True, k, v), (False, ke, ve)):
                def call(backend=backend, kk=kk, vv=vv, gqa=gqa):
                    with sdpa_kernel(backend):
                        return F.scaled_dot_product_attention(q, kk, vv, enable_gqa=gqa, **attn)
                if _runs(call):
                    calls[f"sdpa[{backend.name}{'' if gqa else ', k/v expanded'}"
                          f"{', bool mask' if 'attn_mask' in attn else ''}]"] = call
                    break
    if outputs is not None:
        outputs.update({label: call() for label, call in calls.items()})
    return {label: _graph_ms(call) for label, call in calls.items()}


def _time_forward(kname: str, fwd, plain, with_lse: bool) -> tuple:
    """Time ``fwd`` at the serving prefill / training shape (FLASH_CASES[0])
    beside its plain version and PyTorch's own forwards; -> (ms, plain_ms,
    (bound_ms, bound_by), library_ms).  ms is the kernel's device time (a
    CUDA graph of launches); printed beside it: back-to-back wrapper calls
    timed with events (PR 11-13's measure), the wrapper's host time per
    call, and the device time on the model's layout (transposed views of
    (B, S, H, Dh))."""
    from repro_torch.kernels.flash_attention.ref import attention_mask

    name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype, _ = FLASH_CASES[0]
    q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=0)
    qm, km, vm = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=0, layout="model")
    kw = dict(causal=causal, window=window, q_offset=q_off)
    ms = _graph_ms(lambda: fwd(q, k, v, **kw))
    b2b = _time_ms(lambda: fwd(q, k, v, **kw))
    host = _host_us(lambda: fwd(q, k, v, **kw))
    model_ms = _graph_ms(lambda: fwd(qm, km, vm, **kw))
    plain_ms = _time_ms(lambda: plain(q, k, v, **kw), iters=5)
    library = _fwd_yardsticks(q, k, v, with_lse)
    lib_name = min(library, key=library.get) if library else None
    library_ms = library[lib_name] if library else None
    visible = int(attention_mask(Sq, Skv, causal, window, q_off, "cuda").sum())
    flops = 4.0 * Dh * visible * B * H              # QK^T and PV over visible pairs
    # q, k, v in; o (like q) and, with lse, (B, H, Sq) f32 out
    nbytes = _nbytes(q, k, v, q) + (B * H * Sq * 4 if with_lse else 0)
    bound = _bound(flops, nbytes, dtype)
    for label, t in library.items():
        print(f"kernel {kname} yardstick {label}: {t:.4f} ms", flush=True)
    if not with_lse:
        print(f"kernel {kname} yardstick: unpinned sdpa runs {_sdpa_backend_used(q, k, v)}",
              flush=True)
    lib = f"{library_ms:.4f} ms, {lib_name}, kernel/library {ms / library_ms:.3f}" if library \
        else "none"
    print(f"kernel {kname} timing at {name} (B={B} H={H} Hk={Hk} S={Sq} Dh={Dh} {dtype} causal): "
          f"kernel {ms:.4f} ms device (CUDA graph of 20 launches), {b2b:.4f} ms back-to-back "
          f"wrapper calls, wrapper host {host:.1f} us/call, model layout {model_ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; library {lib}; bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{flops:.4g} FLOP, {nbytes:.4g} B), {bound[0] / ms:.1%} of bound", flush=True)
    return ms, plain_ms, bound, library_ms


def _max_err(got, want) -> tuple:
    """(max |got - want|, max |want|) in f32."""
    return (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()


def _training_kernels() -> list:
    """flash_fwd_lse, flash_bwd_dq and flash_bwd_dkv against their plain
    versions over FLASH_CASES, then timed at the training shape."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_lse_ref, attention_mask,
    )

    worst = {f"{n}{d}": 0.0 for n in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
             for d in ("", "_d320", "_f32")}
    for i, (name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype,
            layout) in enumerate(FLASH_CASES):
        q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=100 + i, layout=layout)
        do = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=200 + i, layout=layout)[0]
        kw = dict(causal=causal, window=window, q_offset=q_off)
        o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_fwd_lse_ref(q, k, v, **kw)
        # the backward kernels and the plain backward on the same o and lse;
        # a second call must give the same bits (no atomics, fixed sum order)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        grads_ref = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        tol_o = BF16_TOL if dtype == "bfloat16" else F32_TOL
        checks = [("flash_fwd_lse", "o", *_max_err(o, o_ref), tol_o),
                  ("flash_fwd_lse", "lse", *_max_err(lse, lse_ref), LSE_TOL[dtype])]
        for kname, tname, got, want in (("flash_bwd_dq", "dq", dq, grads_ref[0]),
                                        ("flash_bwd_dkv", "dk", dk, grads_ref[1]),
                                        ("flash_bwd_dkv", "dv", dv, grads_ref[2])):
            err, scale = _max_err(got, want)
            checks.append((kname, tname, err, scale, GRAD_REL_TOL[dtype] * max(scale, 1.0)))
        finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, dq, dk, dv))
        line = ", ".join(f"{t} {e:.3e} (max|ref| {m:.3g}, tol {tol:.3g})"
                         for _, t, e, m, tol in checks)
        end = q_off + Sq
        if causal and end < Skv:
            # keys past the last query take no gradient: exactly 0
            past = {t: int(torch.count_nonzero(g[:, :, end:])) for t, g in (("dk", dk),
                                                                            ("dv", dv))}
            line += f"; nonzero dk/dv past the last query (keys {end}..{Skv - 1}): {past}"
            if any(past.values()):
                fail(f"flash_bwd_dkv {name}: dk/dv past the last query are not 0: {past}")
        print(f"kernel train {name}: B={B} H={H} Hk={Hk} Sq={Sq} Skv={Skv} Dh={Dh} "
              f"causal={causal} window={window} q_offset={q_off} {dtype} {layout} layout: "
              f"{line}; two backward calls {'bit-identical' if same else 'DIFFER'}", flush=True)
        if not same:
            fail(f"flash_attention_bwd {name}: two calls on the same inputs differ")
        for kname, tname, err, _, tol in checks:
            if not finite or not err <= tol:
                fail(f"{kname} {name}: {tname} disagrees with its plain version: {err} > {tol} "
                     f"(finite={finite})")
            if name == "serve_prefill":
                worst[kname] = max(worst[kname], err)
            if Dh == 320 and dtype == "bfloat16":
                worst[f"{kname}_d320"] = max(worst[f"{kname}_d320"], err)
            if name == "railx100m_train_f32":
                worst[f"{kname}_f32"] = max(worst[f"{kname}_f32"], err)

    # timing at the training step's shape: the serve_prefill case's shape
    fwd_ms, plain_fwd, fwd_bound, lib_fwd = _time_forward(
        "flash_fwd_lse", fa.flash_attention_fwd_lse, attention_fwd_lse_ref, with_lse=True)
    name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype, _ = FLASH_CASES[0]
    kw = dict(causal=True, window=None, q_offset=0)
    bkw = dict(kw, scale=Dh ** -0.5)
    inputs = {}
    for layout in ("kernel", "model"):
        q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=0, layout=layout)
        do = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=1, layout=layout)[0]
        o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
        inputs[layout] = (q, k, v, do, o, lse, (o.float() * do.float()).sum(-1).contiguous())

    def call(kname, layout):
        q, k, v, do, _, lse, delta = inputs[layout]
        fn = fa.bwd_dq if kname == "flash_bwd_dq" else fa.bwd_dkv
        return lambda: fn(q, k, v, do, lse, delta, **bkw)

    knames = ("flash_bwd_dq", "flash_bwd_dkv")
    ms = {n: _graph_ms(call(n, "kernel")) for n in knames}
    b2b = {n: _time_ms(call(n, "kernel")) for n in knames}
    host = {n: _host_us(call(n, "kernel")) for n in knames}
    model_ms = {n: _graph_ms(call(n, "model")) for n in knames}
    q, k, v, do, o, lse, delta = inputs["kernel"]
    # delta = rowsum(o * do), the torch reduction flash_attention_bwd runs
    # before the two kernels: what folding it into a kernel would save
    delta_ms = _graph_ms(lambda: (o.float() * do.float()).sum(-1).contiguous())
    # the plain backward computes dq, dk and dv in one function
    plain_bwd = _time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw), iters=3)
    library, group_ms = _bwd_yardsticks(q, k, v, do)
    for label, (t, how) in library.items():
        print(f"kernel flash_attention_bwd yardstick {label}: {t:.4f} ms ({how}; dq, dk, dv "
              f"on k/v expanded to {H} heads)", flush=True)
    print(f"kernel flash_attention_bwd yardstick: the sum of expanded dk and dv back to {Hk} "
          f"heads (two torch sums) {group_ms:.4f} ms (CUDA graph); delta = rowsum(o * do) "
          f"{delta_ms:.4f} ms per call (CUDA graph)", flush=True)
    lib_name = min(library, key=lambda n: library[n][0]) if library else None
    lib_bwd = library[lib_name][0] if library else None
    visible = int(attention_mask(Sq, Skv, causal, window, q_off, "cuda").sum()) * B * H
    flops = {"flash_bwd_dq": 6.0 * Dh * visible, "flash_bwd_dkv": 8.0 * Dh * visible}
    nbytes = {"flash_bwd_dq": _nbytes(q, k, v, do, lse, delta, q),
              "flash_bwd_dkv": _nbytes(q, k, v, do, lse, delta, k, v)}
    entries = [_flash_entry("flash_fwd_lse", "flash_fwd.cu", 79, None, worst["flash_fwd_lse"],
                            fwd_ms, plain_fwd, fwd_bound, lib_fwd)]
    lib = f"{lib_bwd:.4f} ms ({lib_name})" if library else "none"
    for kname, src, line in (("flash_bwd_dq", "flash_bwd.cu", 121),
                             ("flash_bwd_dkv", "flash_bwd.cu", 159)):
        bound = _bound(flops[kname], nbytes[kname], dtype)
        print(f"kernel {kname} timing at the training shape (B={B} H={H} Hk={Hk} S={Sq} "
              f"Dh={Dh} bf16 causal): kernel {ms[kname]:.4f} ms device (CUDA graph of 20 "
              f"launches), {b2b[kname]:.4f} ms back-to-back wrapper calls, wrapper host "
              f"{host[kname]:.1f} us/call, model layout {model_ms[kname]:.4f} ms; plain "
              f"{plain_bwd:.4f} ms; library {lib}; bound {bound[0]:.4f} ms ({bound[1]}: "
              f"{flops[kname]:.4g} FLOP, {nbytes[kname]:.4g} B), {bound[0] / ms[kname]:.1%} "
              f"of bound", flush=True)
        entries.append(_flash_entry(kname, src, line, None, worst[kname], ms[kname],
                                    plain_bwd, bound, lib_bwd))
    pair = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
    if library:
        print(f"kernel flash_attention_bwd: dq + dk/dv kernels {pair:.4f} ms device "
              f"({pair + delta_ms:.4f} with delta), fastest library backward {lib_bwd:.4f} ms "
              f"({lib_bwd + group_ms:.4f} with the group sum): kernels/library "
              f"{pair / lib_bwd:.3f}", flush=True)
    print("kernel: plain_ms of flash_bwd_dq and flash_bwd_dkv is the whole plain backward "
          "(dq, dk, dv); their library_ms is the fastest whole PyTorch backward", flush=True)
    # the Dh-320 kernels at gemma3-4b's training shape, and the f32 ones
    timed = {case[0]: _time_bwd_case(case) for case in FLASH_CASES if case[0] in BWD_TIMED}
    for suffix, case in (("_d320", "gemma3_train_global"), ("_f32", "railx100m_train_f32")):
        for kname, line in (("flash_fwd_lse", 79), ("flash_bwd_dq", 121),
                            ("flash_bwd_dkv", 159)):
            src = "flash_fwd.cu" if kname == "flash_fwd_lse" else "flash_bwd.cu"
            entries.append(_flash_entry(f"{kname}{suffix}", src, line, None,
                                        worst[f"{kname}{suffix}"], *timed[case][kname]))
    return entries


def _bwd_yardsticks(q, k, v, do, mask=None, outputs=None) -> tuple:
    """PyTorch's own attention backwards at the timed shape, called as aten
    ops (so that they capture into a CUDA graph), each fed by its own aten
    forward, on k/v expanded to H heads (they take no GQA).  Causal, or,
    with ``mask`` (the visible keys, (Sq, Skv)), not causal with the mask as
    an additive bias (FlashAttention's op takes no bias and is not run).
    Returns ({label: (ms, how it was timed)}, ms of summing the expanded dk
    or dv back to Hk heads, twice): an op that will not capture is timed
    back-to-back, and says so.  ``outputs``, where given, gets each timed
    op's (dq, dk, dv) by label, dk and dv on the expanded heads."""
    import torch

    aten = torch.ops.aten
    B, H, S, Dh = q.shape
    Hk = k.shape[1]
    ke, ve = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
    causal = mask is None
    bias = None if causal else torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(
        ~mask, float("-inf")).expand(B, H, *mask.shape).contiguous()

    def flash():
        out, lse, cq, ck, mq, mk, seed, off, _ = aten._scaled_dot_product_flash_attention(
            q, ke, ve, 0.0, True)
        return lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, ke, ve, out, lse, cq, ck, mq, mk, 0.0, True, seed, off)

    def cudnn():
        out, lse, cq, ck, mq, mk, seed, off, _ = aten._scaled_dot_product_cudnn_attention(
            q, ke, ve, bias, True, 0.0, causal)
        return lambda: aten._scaled_dot_product_cudnn_attention_backward(
            do, q, ke, ve, out, lse, seed, off, bias, cq, ck, mq, mk, 0.0, causal)

    def efficient():
        out, lse, seed, off = aten._scaled_dot_product_efficient_attention(
            q, ke, ve, bias, True, 0.0, causal)
        return lambda: aten._scaled_dot_product_efficient_attention_backward(
            do, q, ke, ve, bias, out, lse, seed, off, 0.0, [True, True, True, False], causal)

    times = {}
    makers = [("aten._scaled_dot_product_flash_attention_backward", flash)] if causal else []
    for label, make in makers + [
            ("aten._scaled_dot_product_cudnn_attention_backward", cudnn),
            ("aten._scaled_dot_product_efficient_attention_backward", efficient)]:
        label = label if causal else f"{label} (bias)"
        try:
            call = make()
            grads = call()[:3]
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"kernel: yardstick {label} refused: {str(e).splitlines()[0][:160]}",
                  flush=True)
            continue
        if outputs is not None:
            outputs[label] = grads
        try:
            times[label] = (_graph_ms(call), "device time, CUDA graph")
        except RuntimeError as e:
            torch.cuda.synchronize()
            times[label] = (_time_ms(call), "back-to-back: it does not capture into a CUDA "
                            f"graph ({str(e).splitlines()[0][:80]})")
    dke = torch.randn((B, H, S, Dh), device=q.device).to(q.dtype)
    group_ms = 2 * _graph_ms(lambda: dke.view(B, Hk, H // Hk, S, Dh).sum(2))
    return times, group_ms


def _time_bwd_case(case) -> dict:
    """Time flash_fwd_lse, flash_bwd_dq and flash_bwd_dkv at one FLASH_CASES
    shape of the gemma3-4b training path (its own layout) beside their
    bounds, their plain versions and PyTorch's own calls (contiguous copies:
    the fastest accurate sdpa forward; the fastest accurate aten backward,
    or "refused"; in f32 also aten's forwards with lse; the calls on the
    keys some query sees, ``_aligned_yardsticks``; a call is accurate when
    it is as close to the plain version as the kernels are held to be,
    ``_accurate``), a line each; -> {kernel: (ms, plain_ms, (bound_ms,
    bound_by), library_ms)}, the bound at the 3xTF32 rate for f32 (the f32
    kernels' route).  The bound counts the K and V rows some query sees,
    read once: a causal rank of a sequence-parallel step reads no key past
    its last query."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_lse_ref, attention_mask,
    )

    name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype, layout = case
    q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=7, layout=layout)
    do = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=8, layout=layout)[0]
    kw = dict(causal=causal, window=window, q_offset=q_off)
    bkw = dict(kw, scale=Dh ** -0.5)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1).contiguous()
    ms = {"flash_fwd_lse": _graph_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, **kw)),
          "flash_bwd_dq": _graph_ms(lambda: fa.bwd_dq(q, k, v, do, lse, delta, **bkw)),
          "flash_bwd_dkv": _graph_ms(lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **bkw))}
    plain_bwd = _time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw), iters=3, warmup=1)
    plain = {"flash_fwd_lse": _time_ms(lambda: attention_fwd_lse_ref(q, k, v, **kw), iters=3,
                                       warmup=1),
             "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    mask = attention_mask(Sq, Skv, causal, window, q_off, "cuda")
    # aten's causal flag is the top-left triangle, this function's only where
    # Sq = Skv: otherwise the mask goes in explicitly
    plain_causal = causal and window is None and q_off == 0 and Sq == Skv
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    fwd_out, bwd_out = {}, {}
    fwd_lib = _fwd_yardsticks(qc, kc, vc, False, causal=causal, mask=mask, outputs=fwd_out)
    if dtype == "float32" and plain_causal:
        # aten's forwards with lse: cuDNN's takes f32 inputs, sdpa's cuDNN
        # backend does not
        fwd_lib.update(_fwd_yardsticks(qc, kc, vc, True, outputs=fwd_out))
    bwd_lib, _ = _bwd_yardsticks(qc, kc, vc, doc, mask=None if plain_causal else mask,
                                 outputs=bwd_out)
    if not plain_causal:
        more_fwd, more_bwd = _aligned_yardsticks((qc, kc, vc, doc), kw, fwd_out, bwd_out)
        fwd_lib.update(more_fwd)
        bwd_lib.update(more_bwd)
    fwd_lib, bwd_lib = _accurate(name, dtype, (q, k, v, do), kw, fwd_lib, fwd_out, bwd_lib,
                                 bwd_out)
    fwd_name = min(fwd_lib, key=fwd_lib.get) if fwd_lib else None
    bwd_name = min(bwd_lib, key=lambda n: bwd_lib[n][0]) if bwd_lib else None
    library = {"flash_fwd_lse": (fwd_lib[fwd_name], fwd_name) if fwd_lib else None}
    library["flash_bwd_dq"] = library["flash_bwd_dkv"] = \
        (bwd_lib[bwd_name][0], bwd_name) if bwd_lib else None
    visible = int(mask.sum()) * B * H
    flops = {"flash_fwd_lse": 4.0 * Dh * visible, "flash_bwd_dq": 6.0 * Dh * visible,
             "flash_bwd_dkv": 8.0 * Dh * visible}
    # K and V are read only at the keys some query sees; dk/dv writes every key
    kv_read = _nbytes(k, v) * int(mask.any(0).sum()) / Skv
    nbytes = {"flash_fwd_lse": kv_read + _nbytes(q, q, lse),
              "flash_bwd_dq": kv_read + _nbytes(q, do, lse, delta, q),
              "flash_bwd_dkv": kv_read + _nbytes(q, do, lse, delta, k, v)}
    out = {}
    for kname in ms:
        bound = _bound(flops[kname], nbytes[kname], dtype)
        lib = library[kname]
        note = "; forward without lse" if lib and lib[1].startswith("sdpa") else ""
        lib_txt = (f"{lib[0]:.4f} ms ({lib[1]}{note})" if lib
                   else "refused (no PyTorch call takes this shape)")
        simt, tf32, entry_bound = "", "", bound
        if dtype == "float32":  # the f32 kernels' own route: 3xTF32 on the tensor cores
            from repro_torch.kernels import bounds
            b = bounds._bound(flops[kname], nbytes[kname])
            simt = " at the f32 SIMT peak"
            tf32 = (f"; 3xTF32 bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                    f"{b['bound_ms'] / ms[kname]:.1%} of it")
            entry_bound = (b["bound_ms"], b["bound_by"])
        print(f"kernel {kname} timing at {name} (B={B} H={H} Hk={Hk} Sq={Sq} Skv={Skv} "
              f"q_offset={q_off} Dh={Dh} {dtype} causal={causal} window={window} {layout} "
              f"layout): kernel {ms[kname]:.4f} ms "
              f"device (CUDA graph of 20 launches); plain {plain[kname]:.4f} ms; library "
              f"{lib_txt}; bound{simt} {bound[0]:.4f} ms ({bound[1]}: {flops[kname]:.4g} FLOP, "
              f"{nbytes[kname]:.4g} B), {bound[0] / ms[kname]:.1%} of bound{tf32}", flush=True)
        out[kname] = (ms[kname], plain[kname], entry_bound, lib[0] if lib else None)
    lib = library["flash_bwd_dq"]
    if lib:
        pair = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
        print(f"kernel flash_attention_bwd at {name}: dq + dk/dv kernels (with their combines) "
              f"{pair:.4f} ms device, library {lib[0]:.4f} ms ({lib[1]}): kernels/library "
              f"{pair / lib[0]:.3f}", flush=True)
    return out


def _aligned_yardsticks(inputs, kw, fwd_out, bwd_out) -> tuple:
    """PyTorch's calls for a causal function without a window whose Sq
    queries sit at ``q_offset`` of Skv > Sq keys, where aten's causal flag
    (the top-left triangle) is not the function: at q_offset 0 the causal
    calls on the first Sq keys, the only ones a query sees (the slices are
    copied outside the timing; the keys past them take a zero gradient);
    where the last query sees the last key (q_offset + Sq = Skv), sdpa with
    ``causal_lower_right`` and aten's calls with the causal flag, which
    FlashAttention's aligns to the bottom right (the others' are dropped by
    ``_accurate``).  -> ({label: ms}, {label: (ms, how)}); each call's
    outputs go into ``fwd_out`` / ``bwd_out`` by label, dk and dv padded
    with zeros to Skv keys."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    q, k, v, do = inputs
    Sq, Skv, off = q.shape[2], k.shape[2], kw["q_offset"]
    if not kw["causal"] or kw["window"] is not None or Skv == Sq:
        return {}, {}
    f_out, b_out = {}, {}
    if off == 0:
        ks, vs = (t[:, :, :Sq].contiguous() for t in (k, v))
        fwd = _fwd_yardsticks(q, ks, vs, False, causal=True, outputs=f_out)
        bwd, _ = _bwd_yardsticks(q, ks, vs, do, outputs=b_out)
        tag = f" on keys < {Sq}"
    elif off + Sq == Skv:
        H, Hk = q.shape[1], k.shape[1]
        ke, ve = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
        bias = causal_lower_right(Sq, Skv)

        def lower_right():
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=bias)

        fwd = {}
        if _runs(lower_right):
            label = "sdpa[causal_lower_right, k/v expanded]"
            f_out[label] = lower_right()
            try:
                fwd[label] = _graph_ms(lower_right)
            except RuntimeError:
                torch.cuda.synchronize()
                fwd[label] = _time_ms(lower_right)
        bwd, _ = _bwd_yardsticks(q, k, v, do, outputs=b_out)
        tag = " (causal flag at Sq < Skv)"
    else:
        return {}, {}
    fwd_out.update({label + tag: out for label, out in f_out.items()})
    bwd_out.update({label + tag: (dq, *(F.pad(g, (0, 0, 0, Skv - g.shape[2])) for g in (dk, dv)))
                    for label, (dq, dk, dv) in b_out.items()})
    return ({label + tag: t for label, t in fwd.items()},
            {label + tag: t for label, t in bwd.items()})


def _accurate(name, dtype, inputs, kw, fwd_lib, fwd_out, bwd_lib, bwd_out) -> tuple:
    """The library calls that are as accurate as the kernels are held to be,
    on the same inputs: a forward's o within F32_TOL (f32) or BF16_TOL
    (bf16) of the plain version's, a backward's dq, dk and dv (dk, dv summed
    over the query group) within GRAD_REL_TOL of the plain backward's scale,
    as in _training_kernels.  Each call is printed with its time and its
    error; one that misses is not a yardstick.  -> (fwd_lib, bwd_lib),
    filtered."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_lse_ref

    fwd_tol = F32_TOL if dtype == "float32" else BF16_TOL
    q, k, v, do = inputs
    o_ref, lse_ref = attention_fwd_lse_ref(q, k, v, **kw)
    grads_ref = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    Hk = k.shape[1]
    fwd_keep, bwd_keep = {}, {}
    for label, t in fwd_lib.items():
        out = fwd_out[label]
        err = _max_err(out[0] if isinstance(out, (tuple, list)) else out, o_ref)[0]
        ok = err <= fwd_tol
        verdict = "compared" if ok else "not accurate, not compared"
        print(f"kernel flash_fwd_lse yardstick at {name}: {label} {t:.4f} ms, o max_abs_err "
              f"{err:.3e} (tol {fwd_tol:g}): {verdict}", flush=True)
        if ok:
            fwd_keep[label] = t
    for label, (t, how) in bwd_lib.items():
        dq, dke, dve = bwd_out[label]
        B, H, S, Dh = dke.shape
        got = (dq, *(g.reshape(B, Hk, H // Hk, S, Dh).sum(2) for g in (dke, dve)))
        errs = []
        for g, want in zip(got, grads_ref):
            err, scale = _max_err(g, want)
            errs.append((err, GRAD_REL_TOL[dtype] * max(scale, 1.0)))
        ok = all(err <= tol for err, tol in errs)
        verdict = "compared" if ok else "not accurate, not compared"
        txt = ", ".join(f"{g} {e:.3e} (tol {tol:.3g})" for g, (e, tol) in zip(("dq", "dk", "dv"),
                                                                            errs))
        print(f"kernel flash_attention_bwd yardstick at {name}: {label} {t:.4f} ms ({how}), "
              f"{txt}: {verdict}", flush=True)
        if ok:
            bwd_keep[label] = (t, how)
    return fwd_keep, bwd_keep


# The scans take f32 (the model path casts to f32).  Tolerances relative to
# the largest |y| of the plain version: against the sequential oracle the
# reference tests' own (1e-4 SSD, 1e-3 mLSTM: tests/test_kernels.py); against
# the chunked plain version 1e-4, the same chunked function summed in other
# orders (the mLSTM's q.n_t as a row sum of w o q k^T) over up to 16 chunks.
SSD_ORACLE_REL, MLSTM_ORACLE_REL, SCAN_CHUNKED_REL = 1e-4, 1e-3, 1e-4
# name, B, S, H, P, N, chunk
SSD_CASES = [
    ("ref_a", 2, 128, 3, 32, 16, 32),      # tests/test_kernels.py::test_ssd_sweep
    ("ref_b", 1, 64, 2, 64, 64, 64),
    ("ref_c", 2, 256, 1, 16, 8, 64),
    ("ref_a_chunk64", 2, 128, 3, 32, 16, 64),
    ("zamba2_smoke", 2, 128, 8, 16, 16, 64),
    ("zamba2_chunk32", 2, 256, 112, 64, 64, 32),
    ("zamba2_prefill", 4, 256, 112, 64, 64, 64),  # serve_hybrid's prefill shape
    # the Pallas kernel's documented range: chunks up to 256, P and N up to 128
    ("p128_n128_chunk128", 2, 512, 8, 128, 128, 128),
    ("chunk256", 2, 512, 16, 64, 64, 256),
    ("p128_n128_chunk256", 1, 512, 4, 128, 128, 256),
    ("p96_n80_chunk128", 1, 256, 3, 96, 80, 128),  # N past 64: the N <= 128 build
    ("odd_p6_n5", 1, 40, 2, 6, 5, 40),    # rows not 16-byte aligned: 4-byte loads
]
SSD_TIMED = (4, 1024, 112, 64, 64, 64)             # zamba2-7b, 4 x 1024 tokens
# name, B, S, H, D, chunk[, input gate of -1e30 on: "first_tile" rows 0-63, a
# whole tile of padding before any real row; "tail" the last 40 rows, as the
# model pads; "scattered" every 7th row]
MLSTM_CASES = [
    ("ref_a", 2, 128, 2, 32, 32),          # tests/test_kernels.py::test_mlstm_sweep
    ("ref_b", 1, 64, 3, 16, 64),
    ("ref_c", 2, 256, 1, 64, 64),
    ("xlstm_smoke", 2, 128, 2, 32, 64),
    ("d96_chunk32", 1, 96, 2, 96, 32),
    ("d192_chunk32", 2, 256, 4, 192, 32),
    ("xlstm_prefill", 4, 1024, 4, 192, 64),        # serve_xlstm's prefill shape
    # the widened range: D up to 256, chunks up to 256
    ("d256_chunk128", 2, 256, 2, 256, 128),
    ("d192_chunk256", 2, 512, 4, 192, 256),
    ("odd_d10", 1, 40, 2, 10, 40),        # rows not 16-byte aligned: 4-byte loads
    ("pad_first_tile", 1, 192, 2, 32, 64, "first_tile"),
    ("pad_tail", 2, 128, 2, 64, 32, "tail"),
    ("pad_scattered", 1, 256, 2, 192, 64, "scattered"),
]
MLSTM_TIMED = (4, 1024, 4, 192, 64)                # xlstm-125m, 4 x 1024 tokens


def _ssd_inputs(B, S, H, P, N, seed):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    return (randn(B, S, H, P), randn(B, S, H).abs() * 0.1 + 0.01, randn(B, S, N), randn(B, S, N),
            -(randn(H).abs() + 0.5))


def _mlstm_inputs(B, S, H, D, seed, pad=None):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    ig = randn(B, S, H)
    rows = {None: slice(0, 0), "first_tile": slice(0, 64), "tail": slice(S - 40, S),
            "scattered": slice(3, S, 7)}[pad]
    ig[:, rows] = -1e30
    return (randn(B, S, H, D) / D ** 0.5, randn(B, S, H, D), randn(B, S, H, D), ig,
            torch.nn.functional.logsigmoid(randn(B, S, H) + 2))


def _check_scan(kname, name, shape, y, chunked, oracle, oracle_rel) -> float:
    """Hold a scan's output against its plain versions; returns the max abs
    error against the chunked one."""
    import torch

    err, scale = _max_err(y, chunked)
    rel = err / max(scale, 1e-6)
    line = f"chunked: max_abs_err {err:.3e}, rel {rel:.3e} (tol {SCAN_CHUNKED_REL:g})"
    ok = bool(torch.isfinite(y).all()) and rel <= SCAN_CHUNKED_REL
    if oracle is not None:
        oerr, oscale = _max_err(y, oracle)
        orel = oerr / max(oscale, 1e-6)
        line += f"; sequential: rel {orel:.3e} (tol {oracle_rel:g})"
        ok = ok and orel <= oracle_rel
    print(f"kernel {kname} {name}: {shape} f32: {line}", flush=True)
    if not ok:
        fail(f"{kname} {name} disagrees with its plain versions")
    return err


def _scan_bound(kname, where, ms, b2b, plain_ms, flops, nbytes) -> tuple:
    """Print a scan's timing beside both bounds (``kernels/bounds.py``): the
    f32-accurate one (3xTF32 on the tensor cores, 165 TFLOP/s, or the bytes)
    and the f32 SIMT one (67 TFLOP/s); returns the first as (ms, bound_by)."""
    from repro_torch.kernels import bounds

    b = bounds._bound(flops, nbytes)
    print(f"kernel {kname} timing at {where}: kernel {ms:.4f} ms device (CUDA graph, all its "
          f"kernels), {b2b:.4f} ms back-to-back, plain {plain_ms:.4f} ms, library none; "
          f"{flops:.4g} FLOP, {nbytes:.4g} B; bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
          f"f32-accurate 3xTF32), {b['bound_ms'] / ms:.1%} of it; f32 SIMT bound "
          f"{b['simt_bound_ms']:.4f} ms ({b['simt_bound_by']}), {b['simt_bound_ms'] / ms:.1%} "
          f"of it", flush=True)
    return b["bound_ms"], b["bound_by"]


# the scans at this slice's training shapes: zamba2-7b's 4 x 256 tokens
# (train_hybrid, all 112 heads) and one rank's quarter of them in
# chip_profile.py family_cards ((1, 4, 1): a row a rank); xlstm-125m's 4 x 256
# (train_xlstm) and one rank's half of the rows and heads on (1, 2, 2)
SCAN_TRAIN_TIMED = (
    ("ssd_fwd", "zamba2-7b train", (4, 256, 112, 64, 64, 64)),
    ("ssd_fwd", "zamba2-7b train, a rank of (1, 4, 1)", (1, 256, 112, 64, 64, 64)),
    ("mlstm_fwd", "xlstm-125m train", (4, 256, 4, 192, 64)),
    ("mlstm_fwd", "xlstm-125m train, a rank of (1, 2, 2)", (2, 256, 2, 192, 64)),
)


def time_scan(kname: str, where: str, shape: tuple) -> dict:
    """A scan kernel timed at ``shape`` (ssd_fwd: B, S, H, P, N, chunk;
    mlstm_fwd: B, S, H, D, chunk) beside its bounds and its chunked plain
    version; -> {ms, plain_ms, bound_ms, bound_by}."""
    from repro_torch.kernels import bounds
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.mlstm.ref import mlstm_chunked_ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    *dims, chunk = shape
    if kname == "ssd_fwd":
        x = _ssd_inputs(*dims, seed=0)
        fn, plain, flops = ssd.ssd_fwd, ssd_chunked_ref, bounds.ssd_flops(*shape)
    else:
        x = _mlstm_inputs(*dims, seed=0)
        fn, plain, flops = mlstm.mlstm_fwd, mlstm_chunked_ref, bounds.mlstm_flops(*shape)
    ms = _graph_ms(lambda: fn(*x, chunk=chunk))
    b2b = _time_ms(lambda: fn(*x, chunk=chunk))
    plain_ms = _time_ms(lambda: plain(*x, chunk), iters=5)
    names = "B S H P N" if kname == "ssd_fwd" else "B S H D"
    dims_s = " ".join(f"{n}={v}" for n, v in zip(names.split(), dims))
    bound = _scan_bound(kname, f"{where} ({dims_s} chunk={chunk} f32)", ms, b2b, plain_ms, flops,
                        _nbytes(*x, x[0]))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]}


def _ssd_kernel() -> dict:
    import torch

    from repro_torch.kernels import bounds
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref

    for i, (name, B, S, H, P, N, chunk) in enumerate(SSD_CASES):
        x = _ssd_inputs(B, S, H, P, N, seed=300 + i)
        y = ssd.ssd_fwd(*x, chunk=chunk)
        torch.cuda.synchronize()
        err = _check_scan("ssd_fwd", name, f"B={B} S={S} H={H} P={P} N={N} chunk={chunk}", y,
                          ssd_chunked_ref(*x, chunk)[0], ssd_ref(*x), SSD_ORACLE_REL)
        if name == "zamba2_prefill":
            worst = err
    B, S, H, P, N, chunk = SSD_TIMED
    x = _ssd_inputs(B, S, H, P, N, seed=0)
    ms = _graph_ms(lambda: ssd.ssd_fwd(*x, chunk=chunk))
    b2b = _time_ms(lambda: ssd.ssd_fwd(*x, chunk=chunk))
    plain_ms = _time_ms(lambda: ssd_chunked_ref(*x, chunk), iters=5)
    flops = bounds.ssd_flops(B, S, H, P, N, chunk)
    nbytes = _nbytes(*x, x[0])  # x, dt, B, C, A in; y out
    bound = _scan_bound("ssd_fwd", f"zamba2-7b (B={B} S={S} H={H} P={P} N={N} chunk={chunk} "
                        "f32)", ms, b2b, plain_ms, flops, nbytes)
    return _entry("ssd_fwd", "kernels/ssd/csrc/ssd_fwd.cu", "kernels/ssd/ssd.py:29", None, worst,
                  ms, plain_ms, bound, None)


def _mlstm_kernel() -> dict:
    import torch

    from repro_torch.kernels import bounds
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.mlstm.ref import mlstm_chunked_ref, mlstm_ref

    for i, (name, B, S, H, D, chunk, *pad) in enumerate(MLSTM_CASES):
        x = _mlstm_inputs(B, S, H, D, seed=400 + i, pad=pad[0] if pad else None)
        y = mlstm.mlstm_fwd(*x, chunk=chunk)
        torch.cuda.synchronize()
        err = _check_scan("mlstm_fwd", name, f"B={B} S={S} H={H} D={D} chunk={chunk}", y,
                          mlstm_chunked_ref(*x, chunk), mlstm_ref(*x), MLSTM_ORACLE_REL)
        if name == "xlstm_prefill":
            worst = err
    B, S, H, D, chunk = MLSTM_TIMED
    x = _mlstm_inputs(B, S, H, D, seed=0)
    ms = _graph_ms(lambda: mlstm.mlstm_fwd(*x, chunk=chunk))
    b2b = _time_ms(lambda: mlstm.mlstm_fwd(*x, chunk=chunk))
    plain_ms = _time_ms(lambda: mlstm_chunked_ref(*x, chunk), iters=5)
    flops = bounds.mlstm_flops(B, S, H, D, chunk)
    nbytes = _nbytes(*x, x[0])  # q, k, v, the gates in; h out
    bound = _scan_bound("mlstm_fwd", f"xlstm-125m (B={B} S={S} H={H} D={D} chunk={chunk} f32)",
                        ms, b2b, plain_ms, flops, nbytes)
    return _entry("mlstm_fwd", "kernels/mlstm/csrc/mlstm_fwd.cu", "kernels/mlstm/mlstm.py:26",
                  None, worst, ms, plain_ms, bound, None)


# ---------------------------------------------------------------------------
# flow: the network core's all-to-all sweeps (core/compiled_flow.py) and the
# four kernels of kernels/flow
# ---------------------------------------------------------------------------

# Fig. 14 at m 2, k_internal 2.0, 8 injection ports, as the reference's
# benchmarks/bench_simulator.py runs it.  The expected throughputs are the
# reference's own floats, recorded in BENCH_simulator.json ("rows"): its exact
# engine on the dict networks at scale 32 (4,096 chips; equal to its seed
# engine's "seed_baselines"), its symmetry sweep on the canonical networks at
# scale 160 (102,400 chips).
FLOW_M, FLOW_K, FLOW_INJ = 2, 2.0, 8.0
FLOW_EXACT = (("railx-hyperx", 32, 1.023622047244098),
              ("torus-2d", 32, 0.013885498046807778))
FLOW_SYMMETRY = (("railx-hyperx", 160, 1.006269592476489),
                 ("torus-2d", 160, 0.024999755859375))
FLOW_REACH = 64           # the exact sweep at 16,384 chips, against the symmetry sweep
FLOW_CHECK = 16           # kernels against their plain versions: 1,024 chips
FLOW_ECMP = 8             # the ECMP pass (num_paths=2) on the dict network: 256 chips
FLOW_TIMED_BATCH = 256    # the scale-32 exact sweep's batch, as the main path runs it
# ns of one dependent f64 add (__dadd_rn), as `python3 chip_profile.py
# dadd_chain` measured it on an H100 80GB HBM3 at 700 W: the fold's serial
# floor is its longest run times this
DADD_NS = 4.1415
# name -> the line of src/repro/core/compiled_flow.py where the function whose
# numpy loop it replaces begins: _bfs_levels (a whole level, its ranking
# included), subtree_edge_counts (its per-level fold),
# _symmetric_alltoall_counts_impl, _route_demands_impl
FLOW_REPLACES = {"flow_bfs_level": 459, "flow_subtree_accumulate": 605,
                 "flow_orbit_gather": 1014, "flow_ordered_fold": 895}


def _sleep_then_time(fn) -> float:
    """Device ms of ``fn``'s launches: the stream is held back by a spin
    kernel while the host enqueues them, so no host time lies inside."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)  # ~1 ms: longer than any wrapper's host path
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


class _FlowProbe:
    """Patches the four wrappers of ``kernels/flow/flow.py`` so that every
    call the sweeps make also runs the plain version (``ref.py``) on the card
    on a copy of the same inputs, and must give the same tensors (integers
    equal, floats the same bits); each call's kernel and plain version are
    timed on the device, and its bytes reckoned from its inputs (each input
    read once, each output written once, counting what this call's data
    needs).  Its launches are not the main path's: the counts are reset after."""

    NAMES = ("bfs_level", "subtree_accumulate", "orbit_gather", "ordered_fold")

    def __init__(self):
        self.stats = {f"flow_{k}": {"calls": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
                                    "err": 0, "library_ms": None, "top_down": 0, "bottom_up": 0,
                                    "longest_run": 0}
                      for k in self.NAMES}

    def __enter__(self):
        from repro_torch.kernels.flow import flow

        self.flow, self.orig = flow, {k: getattr(flow, k) for k in self.NAMES}
        for k in self.NAMES:
            setattr(flow, k, getattr(self, k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.flow, k, fn)
        return False

    def _same(self, kname: str, got, want) -> None:
        import torch

        st = self.stats[kname]
        if got.dtype == torch.float64:
            same = torch.equal(got.view(torch.int64), want.view(torch.int64))
            err = (got - want).abs().max().item() if got.numel() else 0.0
        else:
            same = torch.equal(got, want)
            err = (got - want).abs().max().item() if got.numel() else 0
        st["err"] = max(st["err"], err)
        if not same:
            fail(f"{kname} disagrees with its plain version: max |diff| {err}")

    def _add(self, kname, ms, plain_ms, nbytes, library_ms=None) -> None:
        st = self.stats[kname]
        if library_ms is not None:
            st["library_ms"] = (st["library_ms"] or 0.0) + library_ms
        st["calls"] += 1
        st["ms"] += ms
        st["plain_ms"] += plain_ms
        st["bytes"] += nbytes

    def bfs_level(self, bottom_up, level, queue, epos, child, qs, F, rank, depth, win, indptr,
                  nbr, rev_indptr, rev_edge, rev_src, rev_slot, deg, edge_ok, frontier_edges,
                  scratch, info, n, stride):
        import torch

        from repro_torch.kernels.flow import ref

        state = (queue, epos, child, rank, depth, win, info)
        want = [t.clone() for t in state]
        graph = (indptr, nbr, rev_indptr, rev_edge, rev_src, rev_slot, deg, edge_ok,
                 frontier_edges)
        size, E = depth.numel(), nbr.numel()
        und = torch.nonzero(depth == -1).flatten() % n   # the state before the level
        u = queue[qs:qs + F] % n
        D = int((indptr[u + 1] - indptr[u]).sum())
        I = int((rev_indptr[und + 1] - rev_indptr[und]).sum())
        ms = _sleep_then_time(lambda: self.orig["bfs_level"](
            bottom_up, level, queue, epos, child, qs, F, rank, depth, win, *graph, scratch, info,
            n, stride))
        q2, e2, c2, r2, d2, w2, i2 = want
        plain_ms = _sleep_then_time(lambda: ref.bfs_level_ref(
            bottom_up, level, q2, e2, c2, qs, F, r2, d2, w2, *graph, scratch, i2, n, stride))
        for got, w in zip(state, want):
            self._same("flow_bfs_level", got, w)
        if bool(scratch[-(-size // self.flow.SCAN_TILE):].any()):  # past the tile sums
            fail("flow_bfs_level left its scratch masks set")
        Fn, ok = int(info[0]), 0 if edge_ok is None else 1
        # both directions: the frontier's keys; the new level's keys, edges,
        # depths and ranks, the frontier's child offsets, info; deg at the new
        # level's vertices (the direction sums)
        nbytes = 8 * F + (8 + 8 + 4 + 8) * Fn + 8 * F + 24 + 8 * min(Fn, n)
        if bottom_up:
            # depth whole; rev_indptr at the undiscovered; their in-edges'
            # rev_src and rev_slot (and rev_edge, edge_ok); depth at the tails,
            # rank at the frontier's; indptr at the parents, nbr at the winners
            nbytes += (4 * size + 8 * min(2 * und.numel(), n + 1) + (8 + 9 * ok) * min(I, E)
                       + 4 * min(I, size) + 8 * min(I, F) + 8 * min(F, n + 1) + 4 * Fn)
        else:
            # indptr at the frontier's vertices; nbr (and edge_ok) of its
            # out-edges, depth at their heads; win at the winners
            nbytes += (8 * min(2 * F, n + 1) + (4 + ok) * min(D, E) + 4 * min(D, size)
                       + 8 * Fn)
        self.stats["flow_bfs_level"]["bottom_up" if bottom_up else "top_down"] += 1
        self._add("flow_bfs_level", ms, plain_ms, nbytes)

    def subtree_accumulate(self, queue, epos, child, qs, L, dest, cnt, K, n):
        import torch

        from repro_torch.kernels.flow import ref

        cnt2, K2 = cnt.clone(), K.clone()
        ms = _sleep_then_time(lambda: self.orig["subtree_accumulate"](
            queue, epos, child, qs, L, dest, cnt, K, n))
        plain_ms = _sleep_then_time(lambda: ref.subtree_accumulate_ref(
            queue, epos, child, qs, L, dest, cnt2, K2, n))
        self._same("flow_subtree_accumulate", cnt, cnt2)
        self._same("flow_subtree_accumulate", K, K2)
        live = cnt[qs:qs + L] != 0
        edges = torch.unique(epos[qs:qs + L][live]).numel()
        C = int(child[qs + L] - child[qs]) if L else 0
        # the level's keys and child offsets, epos of its live entries; the
        # children's counts (the level below); dest at its vertices; its
        # counts written; K read and written at the live entries' edges
        nbytes = (8 * L + 8 * (L + 1) + 8 * int(live.sum()) + 8 * C + 8 * min(L, n) + 8 * L
                  + 16 * edges)
        self._add("flow_subtree_accumulate", ms, plain_ms, nbytes)

    def orbit_gather(self, C, indptr, R, scale, step, m2):
        from repro_torch.kernels.flow import ref

        out = []
        ms = _sleep_then_time(lambda: out.append(self.orig["orbit_gather"](
            C, indptr, R, scale, step, m2)))
        operands = ref.orbit_operands(indptr, scale, step, m2)
        want = []
        plain_ms = _sleep_then_time(lambda: want.append(ref.orbit_gather_ref(
            C, indptr, *operands, scale, m2)))
        self._same("flow_orbit_gather", out[0], want[0])
        G = (scale // step) ** 2
        library_ms = None
        if step == 1:  # C is G copies of the R representative slots
            lib = [C.view(G, R).sum(0)]  # a first call loads torch's kernel: not timed
            library_ms = _sleep_then_time(lambda: lib.append(C.view(G, R).sum(0)))
            self._same("flow_orbit_gather", out[0], lib[-1])
        # C once; indptr at the 2 step vertices that give each residue's
        # columns; K written
        nbytes = 8 * C.numel() + 16 * step + 8 * R
        self._add("flow_orbit_gather", ms, plain_ms, nbytes, library_ms)
        return out[0]

    def ordered_fold(self, w_sorted, off):
        import torch

        from repro_torch.kernels.flow import ref

        out = []
        ms = _sleep_then_time(lambda: out.append(self.orig["ordered_fold"](w_sorted, off)))
        want = []
        plain_ms = _sleep_then_time(lambda: want.append(ref.ordered_fold_ref(w_sorted, off)))
        self._same("flow_ordered_fold", out[0], want[0])
        E = off.numel() - 1
        ids = torch.repeat_interleave(torch.arange(E, device=off.device), off[1:] - off[:-1])
        torch.bincount(ids, weights=w_sorted, minlength=E)  # loads torch's kernel: not timed
        library_ms = _sleep_then_time(lambda: torch.bincount(ids, weights=w_sorted, minlength=E))
        st = self.stats["flow_ordered_fold"]
        st["longest_run"] = max(st["longest_run"], int((off[1:] - off[:-1]).max()) if E else 0)
        self._add("flow_ordered_fold", ms, plain_ms, 8 * w_sorted.numel() + 8 * (E + 1) + 8 * E,
                  library_ms)
        return out[0]


def _flow_equal(what: str, got, want) -> None:
    import torch

    same = torch.equal(got.cpu(), want.cpu()) if isinstance(got, torch.Tensor) else got == want
    if not same:
        fail(f"flow: {what}: the card and the CPU disagree")


def _flow_checks(smi: str) -> None:
    """Each kernel against its plain version on the card, call by call, on
    RailX and torus at scale 16 (1,024 chips: the exact sweep, the symmetry
    sweep) and an ECMP pass with num_paths=2 (``edge_ok``-masked levels, the
    ordered fold) on 8 sources of RailX 16; then the whole results against the
    same calls on the CPU (the plain versions): trees, counts, loads and
    throughputs equal."""
    import torch

    from repro_torch.core import compiled_flow as cf

    for arch_build, name in ((cf.build_compiled_railx_hyperx, "railx-hyperx"),
                             (cf.build_compiled_torus2d, "torus-2d")):
        nets = {dev: arch_build(FLOW_CHECK, FLOW_M, FLOW_K, device=dev) for dev in ("cuda", "cpu")}
        for f in ("indptr", "nbr", "cap", "edge_src"):
            _flow_equal(f"{name} {f}", getattr(nets["cuda"], f), getattr(nets["cpu"], f))
        with _FlowProbe() as probe:
            K = cf.alltoall_edge_counts(nets["cuda"])
            re, Ks = cf.symmetric_alltoall_counts(nets["cuda"])
            srcs = nets["cuda"].chips()[:64]
            forest = cf.bfs_forest(nets["cuda"], srcs)
        _flow_equal(f"{name} counts", K, cf.alltoall_edge_counts(nets["cpu"]))
        _flow_equal(f"{name} symmetry counts", Ks, cf.symmetric_alltoall_counts(nets["cpu"])[1])
        _flow_equal(f"{name} symmetry == exact", K[re], Ks)
        want = cf.bfs_forest(nets["cpu"], srcs.cpu())
        for got, w, what in zip(forest, want, ("parent_e", "depth")):
            _flow_equal(f"{name} {what}", got, w)
        thr = {dev: (cf.alltoall_throughput_compiled(cn, FLOW_INJ),
                     cf.symmetric_alltoall_throughput(cn, FLOW_INJ)) for dev, cn in nets.items()}
        _flow_equal(f"{name} throughputs", thr["cuda"], thr["cpu"])
        st = probe.stats
        print(f"flow check {name} {FLOW_CHECK} m {FLOW_M}: {nets['cuda'].num_vertices} chips, "
              f"{nets['cuda'].num_edges} edges; exact {thr['cuda'][0]!r}, symmetry "
              f"{thr['cuda'][1]!r}; every call equal to its plain version: "
              + ", ".join(f"{k} {v['calls']}" for k, v in st.items())
              + f" (bfs levels top-down {st['flow_bfs_level']['top_down']}, bottom-up "
              f"{st['flow_bfs_level']['bottom_up']}); trees of 64 sources, counts and "
              f"throughputs equal to the CPU's [{smi}]", flush=True)
    nets = {dev: cf.build_compiled_railx_hyperx(FLOW_CHECK, FLOW_M, FLOW_K, device=dev)
            for dev in ("cuda", "cpu")}
    nchips = nets["cpu"].num_vertices
    demands = {(s, t): 1.0 + s for s in range(0, 8 * 4, 4) for t in range(nchips) if t != s}
    loads = {}
    with _FlowProbe() as probe:
        loads["cuda"] = [cf.route_demands(nets["cuda"], demands, p) for p in (1, 2)]
    loads["cpu"] = [cf.route_demands(nets["cpu"], demands, p) for p in (1, 2)]
    for p, got, want in zip((1, 2), loads["cuda"], loads["cpu"]):
        _flow_equal(f"route_demands num_paths={p} (bits)", got.view(torch.int64),
                    want.view(torch.int64))
    print(f"flow check route_demands on railx-hyperx {FLOW_CHECK}, 8 sources x {nchips - 1} "
          f"destinations, num_paths 1 and 2: loads bit-identical to the CPU's; "
          + ", ".join(f"{k} {v['calls']}" for k, v in probe.stats.items()), flush=True)


def _flow_timed(smi: str) -> dict:
    """Each kernel timed call by call against its plain version at the main
    path's shapes: the scale-32 RailX exact sweep, every chip a source and a
    destination, in batches of 256 sources (``flow_bfs_level``,
    ``flow_subtree_accumulate``), the scale-160 RailX symmetry sweep
    (``flow_orbit_gather``: 4 classes, a group of 25,600; beside the column
    sum ``C.view(G, R).sum(0)``) and the scale-8 ECMP pass of the dict
    network (``flow_ordered_fold``; beside ``torch.bincount``, and its
    serial floor: the longest run times one dependent f64 add)."""
    import torch

    from repro_torch.arch import get
    from repro_torch.core import compiled_flow as cf
    from repro_torch.core.simulator import alltoall_throughput

    (_, exact_scale, _), (_, sym_scale, _) = FLOW_EXACT[0], FLOW_SYMMETRY[0]
    rx = cf.build_compiled_railx_hyperx(exact_scale, FLOW_M, FLOW_K)
    with _FlowProbe() as exact:
        cf.alltoall_edge_counts(rx, batch=FLOW_TIMED_BATCH)
    del rx
    torch.cuda.empty_cache()
    with _FlowProbe() as sym:
        cf.symmetric_alltoall_counts(get("railx-hyperx").compiled_fig14(sym_scale, FLOW_M, FLOW_K))
    torch.cuda.empty_cache()
    fb = get("railx-hyperx").flow_fig14(FLOW_ECMP, FLOW_M, FLOW_K, FLOW_INJ)
    with _FlowProbe() as ecmp:
        alltoall_throughput(fb.net, fb.chips, FLOW_INJ, num_paths=2)
    timed = {"flow_bfs_level": (exact, f"RailX {exact_scale} m {FLOW_M}, the exact sweep in "
                                       f"batches of {FLOW_TIMED_BATCH} sources"),
             "flow_subtree_accumulate": (exact, "the same sweep"),
             "flow_orbit_gather": (sym, f"RailX {sym_scale} m {FLOW_M}, symmetry sweep"),
             "flow_ordered_fold": (ecmp, f"RailX {FLOW_ECMP} m 2 dict network, all-to-all "
                                         "num_paths=2")}
    out = {}
    for kname, (probe, where) in timed.items():
        st = probe.stats[kname]
        c = st["calls"]
        if not c:
            fail(f"flow: {kname} was not called at {where}")
        ms, plain_ms, bound = st["ms"] / c, st["plain_ms"] / c, st["bytes"] / c / PEAK_BYTES * 1e3
        library = None if st["library_ms"] is None else st["library_ms"] / c
        lib_name = {"flow_orbit_gather": "C.view(G, R).sum(0), equal",
                    "flow_ordered_fold": "torch.bincount"}.get(kname)
        floor = ""
        if kname == "flow_ordered_fold":
            floor_ms = st["longest_run"] * DADD_NS * 1e-6
            floor = (f"; serial floor {floor_ms:.4f} ms (longest run {st['longest_run']} x "
                     f"{DADD_NS} ns a dependent f64 add, chip_profile.py dadd_chain), "
                     f"{floor_ms / ms:.1%} of it")
        print(f"flow kernel {kname} at {where}: {c} calls, kernel {ms:.4f} ms a call (device, "
              f"total {st['ms']:.3f} ms), plain {plain_ms:.4f} ms, library "
              f"{'none' if library is None else f'{library:.4f} ms ({lib_name})'}; "
              f"{st['bytes'] / c:.4g} B a call, bound {bound:.4f} ms (bytes at 3.35 TB/s), "
              f"{bound / ms:.1%} of it{floor}; max |diff| {st['err']} [{smi}]", flush=True)
        out[kname] = {"err": st["err"], "ms": ms, "plain_ms": plain_ms,
                      "bound": (bound, "bytes"), "library_ms": library}
    return out


def _flow_main_path(smi: str) -> None:
    """The network core as a user drives it: the Fig. 14 exact points from
    the registry's dict networks (``flow_fig14`` -> ``simulator.
    alltoall_throughput``), the 102,400-chip symmetry points from its
    canonical builders (``compiled_fig14`` -> ``symmetric_alltoall_throughput``),
    the ECMP all-to-all with num_paths=2 (equal to the same call on the CPU),
    and the exact sweep at 16,384 chips held against the symmetry sweep edge
    by edge."""
    import torch

    from repro_torch.arch import get
    from repro_torch.core import compiled_flow as cf
    from repro_torch.core.simulator import alltoall_throughput

    for arch, scale, want in FLOW_EXACT:
        t0 = time.perf_counter()
        fb = get(arch).flow_fig14(scale, FLOW_M, FLOW_K, FLOW_INJ)
        t1 = time.perf_counter()
        thr = alltoall_throughput(fb.net, fb.chips, FLOW_INJ)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"flow fig14 exact {arch} {scale} m {FLOW_M} ({len(fb.chips)} chips, dict "
              f"network): throughput {thr!r} (reference {want!r}); dict build {t1 - t0:.3f} s, "
              f"lowering + sweep {t2 - t1:.3f} s wall [{smi}]", flush=True)
        if thr != want:
            fail(f"flow: {arch} {scale} exact throughput {thr!r} != the reference's {want!r}")
    for arch, scale, want in FLOW_SYMMETRY:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cn = get(arch).compiled_fig14(scale, FLOW_M, FLOW_K)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        thr = cf.symmetric_alltoall_throughput(cn, FLOW_INJ)
        t2 = time.perf_counter()
        print(f"flow fig14 symmetry {arch} {scale} m {FLOW_M} ({cn.num_vertices} chips, "
              f"{cn.num_edges} edges): throughput {thr!r} (reference {want!r}); build "
              f"{t1 - t0:.3f} s, sweep {t2 - t1:.3f} s wall [{smi}]", flush=True)
        if thr != want:
            fail(f"flow: {arch} {scale} symmetry throughput {thr!r} != the reference's {want!r}")
        del cn
        torch.cuda.empty_cache()
    fb = get("railx-hyperx").flow_fig14(FLOW_ECMP, FLOW_M, FLOW_K, FLOW_INJ)
    t0 = time.perf_counter()
    ecmp = alltoall_throughput(fb.net, fb.chips, FLOW_INJ, num_paths=2)
    t1 = time.perf_counter()
    cpu = alltoall_throughput(fb.net, fb.chips, FLOW_INJ, num_paths=2, device="cpu")
    print(f"flow ecmp railx-hyperx {FLOW_ECMP} m {FLOW_M} ({len(fb.chips)} chips): num_paths=2 "
          f"throughput {ecmp!r} (CPU {cpu!r}); {t1 - t0:.3f} s wall [{smi}]", flush=True)
    if not 0 < ecmp <= FLOW_INJ:
        fail(f"flow: ECMP throughput {ecmp!r} out of (0, {FLOW_INJ}]")
    _flow_equal("ECMP throughput", ecmp, cpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cn = cf.build_compiled_railx_hyperx(FLOW_REACH, FLOW_M, FLOW_K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    K = cf.alltoall_edge_counts(cn)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    re, Ks = cf.symmetric_alltoall_counts(cn)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    nchips = cn.num_vertices
    thr = FLOW_INJ * min(1.0, 1.0 / cf.utilization_from_counts(
        K, cn.cap, FLOW_INJ / (nchips - 1), sequential=True))
    print(f"flow reach railx-hyperx {FLOW_REACH} m {FLOW_M}: {nchips} chips, {cn.num_edges} "
          f"edges, {nchips * (nchips - 1)} ordered pairs; build {t1 - t0:.3f} s, exact sweep "
          f"{t2 - t1:.3f} s, symmetry sweep {t3 - t2:.3f} s wall; exact throughput {thr!r}; "
          f"counts on all {re.numel()} representative edges equal to the symmetry sweep's: "
          f"{bool(torch.equal(K[re], Ks))} [{smi}]", flush=True)
    if not torch.equal(K[re], Ks):
        fail("flow: the 16,384-chip exact sweep's counts differ from the symmetry sweep's")


def phase_flow(smi: str) -> list:
    """The network core on the card: the kernels against their plain
    versions, timed at the main path's shapes, then the main path with the
    launch counts set to 0 just before and read just after."""
    import torch

    from repro_torch.kernels.flow import flow

    _flow_checks(smi)
    timed = _flow_timed(smi)
    torch.cuda.empty_cache()
    flow.reset_launch_counts()
    _flow_main_path(smi)
    launches = flow.launch_counts()
    print(f"flow launches on the main path: {launches}", flush=True)
    for kname, c in launches.items():
        if not c:
            fail(f"flow: {kname} was not launched on the main path")
    torch.cuda.empty_cache()
    return [_entry(k, "kernels/flow/csrc/flow.cu", f"core/compiled_flow.py:{FLOW_REPLACES[k]}",
                   launches[k], t["err"],
                   t["ms"], t["plain_ms"], t["bound"], t["library_ms"])
            for k, t in timed.items()]


# ---------------------------------------------------------------------------
# The MLaaS cluster twin (``repro_torch.cluster``): its goodput on the card
# ---------------------------------------------------------------------------

# benchmarks/bench_cluster.py's run_grid(128, True): a 128 x 128 node grid,
# RailXConfig(m=4, n=4, R=256), best_fit, flow goodput and circuit validation
# on, a day-long Poisson trace (seed 1234, 12 jobs/h, 2 h mean service) and a
# node-failure trace (MTBF 5e6 x side / 32 s, MTTR 1800 s).  Its summary as
# recorded in BENCH_cluster.json ("rows", grid "128x128", mode "full"), every
# key of the row but the wall time; the day's other two summary keys
# (mean_queue_delay_s, reconfig_downtime_s) are held card == CPU.
CLUSTER_SIDE = 128
CLUSTER_DAY = {"events": 780, "jobs": 304, "finished": 304, "utilization": 0.024,
               "mean_goodput": 0.838, "reconfig_rounds": 618, "circuits_flipped": 425728,
               "placement_attempts": 309, "placement_scans": 309,
               "circuit_cache_hits": 304, "circuit_cache_misses": 5,
               "goodput_cache_hits": 304, "goodput_cache_misses": 5}
CLUSTER_FABRICS = ("railx-hyperx", "torus-2d", "torus-3d", "rail-only")
# the reference's estimate_goodput of _cluster_capped_miss's job (its numpy
# engine on a CPU)
CLUSTER_MISS = 0.6109131300041653
# benchmarks/bench_serving.py's run_mixed: 16 x 16, seed 102026, two services
# on diurnal rates sampled every 600 s, a training load of qwen3-8b jobs
# submitted every 300 s and a switch-heavy fault trace; the horizon is
# its full day of 12 jobs (a day costs well under a second on the host)
SERVING_SIDE, SERVING_SEED, SERVING_RATE_INTERVAL_S = 16, 10_2026, 600.0
SERVING_FAULTS = dict(mtbf_node_s=0.0, mtbf_switch_s=4.0e5, mttr_switch_s=1800.0)
SERVING_HOURS, SERVING_JOBS = 24.0, 12


def cluster_day(side: int, full: bool, device) -> tuple:
    """bench_cluster's ``run_grid(side, full)`` on the port, its goodput
    routed on ``device``; -> (scheduler, wall seconds of the event loop)."""
    import itertools

    from repro_torch.cluster import ClusterScheduler, iter_failure_trace, iter_poisson_trace
    from repro_torch.core.topology import RailXConfig

    cfg = RailXConfig(m=4, n=4, R=2 * side)
    sched = ClusterScheduler(cfg, n=side, policy="best_fit",
                             goodput_model="flow" if full else "none",
                             validate_circuits=full, device=device)
    sched.enqueue(itertools.chain(
        iter_poisson_trace(seed=1234, duration_s=24 * 3600.0, arrival_rate_per_h=12.0,
                           mean_service_s=2 * 3600.0),
        iter_failure_trace(n=side, seed=1234, duration_s=24 * 3600.0,
                           mtbf_node_s=5e6 * side / 32, mttr_s=1800.0),
    ))
    t0 = time.perf_counter()
    sched.run()
    return sched, time.perf_counter() - t0


def serving_services():
    """bench_serving's two services: qwen3-8b chat (SLO 2 s) and
    llama3.2-3b edge (SLO 1 s), one replica each at start, up to 6, with
    their diurnal rate profiles."""
    from repro_torch.cluster import DiurnalProfile, make_service

    chat = make_service(0, "qwen3-8b", slo_p99_s=2.0, initial_replicas=1, max_replicas=6)
    edge = make_service(1, "llama3.2-3b", slo_p99_s=1.0, initial_replicas=1, max_replicas=6)
    profiles = {
        0: DiurnalProfile(base_rps=20.0),
        1: DiurnalProfile(base_rps=26.0, harmonics=(
            (0.5, 86400.0, -math.pi / 4.0),
            (0.2, 43200.0, math.pi / 2.0),
        )),
    }
    return (chat, edge), profiles


def serving_day(fabric: str, autoscale: bool, device, duration_s: float = SERVING_HOURS * 3600.0,
                jobs: int = SERVING_JOBS, chip: Optional[dict] = None) -> tuple:
    """bench_serving's ``run_mixed(fabric, autoscale=...)`` on the port, its
    goodput routed on ``device``; ``chip`` overrides the service model's
    rates (``ServingConfig``'s ``peak_flops`` / ``hbm_bw`` / ``link_bw``,
    an H100's by default).  -> (scheduler, fingerprint: the JSON of the
    summary and the serving summary, as bench_serving's, the serving summary,
    wall s)."""
    from repro_torch.cluster import (
        ClusterScheduler, JobSubmit, ServingConfig, iter_diurnal_trace,
        iter_fault_domain_trace, make_job,
    )
    from repro_torch.core.topology import RailXConfig

    cfg = RailXConfig(m=4, n=4, R=2 * SERVING_SIDE)
    services, profiles = serving_services()
    events = []
    for sid, profile in sorted(profiles.items()):
        events.extend(iter_diurnal_trace(
            service_id=sid, seed=SERVING_SEED + sid, duration_s=duration_s,
            interval_s=SERVING_RATE_INTERVAL_S, profile=profile, burst_prob=0.05))
    for i in range(jobs):
        events.append(JobSubmit(time=i * 300.0, job=make_job(
            i, "qwen3-8b", service_s=(1.0 + (i % 3)) * 3600.0)))
    events.extend(iter_fault_domain_trace(
        n=SERVING_SIDE, rails=cfg.r, seed=SERVING_SEED, duration_s=duration_s,
        emit_horizon_recoveries=True, **SERVING_FAULTS))
    sched = ClusterScheduler(
        cfg, n=SERVING_SIDE, policy="best_fit", goodput_model="flow",
        validate_circuits=False, fabric=fabric, checkpoint_interval_s=900.0,
        serving=ServingConfig(services=services, autoscale=autoscale,
                              preempt_training=autoscale,
                              headroom_nodes=4 if autoscale else 0, **(chip or {})),
        device=device)
    t0 = time.perf_counter()
    m = sched.run(events)
    wall = time.perf_counter() - t0
    srv = sched.serving_summary(until=duration_s)
    return sched, json.dumps({"summary": m.summary(), "serving": srv}, sort_keys=True), srv, wall


class _GoodputClock:
    """Times every goodput miss (``metrics.estimate_goodput``, which the
    ``GoodputCache`` calls once per new allocation shape) and counts the flow
    kernels' launches inside it."""

    def __enter__(self):
        from repro_torch.cluster import metrics
        from repro_torch.kernels.flow import flow

        self.misses = []
        inner = self._inner = metrics.estimate_goodput

        def timed(*args, **kw):
            before = flow.launch_counts()
            t0 = time.perf_counter()
            g = inner(*args, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            after = flow.launch_counts()
            self.misses.append((ms, {k: after[k] - before[k] for k in after if after[k] - before[k]}))
            return g

        metrics.estimate_goodput = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.cluster import metrics

        metrics.estimate_goodput = self._inner


def _cluster_day_on_card(smi: str) -> dict:
    """The 128 x 128 day on the card, launch counts set to 0 just before and
    read just after, then the same day with ``device="cpu"``: the summary
    equal to BENCH_cluster.json's row and to the CPU's, every job record
    (unrounded goodput included) and ``mean_goodput()`` equal."""
    import torch

    from repro_torch.kernels.flow import flow

    torch.cuda.synchronize()
    flow.reset_launch_counts()
    with _GoodputClock() as clock:
        card, wall = cluster_day(CLUSTER_SIDE, True, None)
    torch.cuda.synchronize()
    launches = flow.launch_counts()
    summary = card.metrics.summary()
    events = summary["events"]
    print(f"cluster day {CLUSTER_SIDE}x{CLUSTER_SIDE} full on the card: {events} events in "
          f"{wall:.3f} s wall, {events / wall:.1f} events/s; summary {summary} [{smi}]", flush=True)
    print(f"cluster day: {len(clock.misses)} goodput misses, wall ms each "
          + ", ".join(f"{ms:.1f} ({c})" for ms, c in clock.misses)
          + f"; flow launches on the day {launches} [{smi}]", flush=True)
    for k in ("flow_bfs_level", "flow_ordered_fold"):
        if not launches[k]:
            fail(f"cluster: {k} was not launched on the 128 x 128 day")
    got = {k: summary[k] for k in CLUSTER_DAY}
    if got != CLUSTER_DAY:
        fail(f"cluster: the day's summary {got} != BENCH_cluster.json's {CLUSTER_DAY}")
    cpu, cpu_wall = cluster_day(CLUSTER_SIDE, True, "cpu")
    same = (cpu.metrics.summary() == summary and cpu.metrics.records == card.metrics.records
            and cpu.metrics.mean_goodput() == card.metrics.mean_goodput())
    print(f"cluster day on the CPU: {cpu_wall:.3f} s wall; summary, every job record and "
          f"mean_goodput() {card.metrics.mean_goodput()!r} equal to the card's: {same}", flush=True)
    if not same:
        fail("cluster: the card's day differs from the CPU's")
    return {"wall_s": wall, "events": events, "misses": clock.misses, "launches": launches}


def _cluster_fabrics(smi: str) -> None:
    """A qwen3-8b job at its ``default_plan`` on each of the four fabrics
    with a ``job_network``: its goodput on the card ``==`` on the CPU."""
    from repro_torch.cluster import estimate_goodput, make_job, plan_job_mapping
    from repro_torch.core.availability import JobAllocation
    from repro_torch.core.topology import RailXConfig
    from repro_torch.kernels.flow import flow

    cfg = RailXConfig(m=4, n=4, R=2 * SERVING_SIDE)
    job = make_job(0, "qwen3-8b")
    jm = plan_job_mapping(cfg, job)
    alloc = JobAllocation(tuple(range(jm.rows_req)), tuple(range(jm.cols_req)))
    for fabric in CLUSTER_FABRICS:
        flow.reset_launch_counts()
        t0 = time.perf_counter()
        g = estimate_goodput(cfg, job, jm.mapping, alloc, fabric=fabric)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in flow.launch_counts().items() if v}
        want = estimate_goodput(cfg, job, jm.mapping, alloc, fabric=fabric, device="cpu")
        print(f"cluster goodput {fabric}: qwen3-8b {jm.rows_req}x{jm.cols_req} nodes, card "
              f"{g!r} in {ms:.1f} ms wall ({launches}), CPU {want!r} [{smi}]", flush=True)
        if g != want:
            fail(f"cluster: {fabric}'s goodput on the card {g!r} != the CPU's {want!r}")


def _cluster_capped_miss(smi: str) -> None:
    """What one goodput miss costs at ``max_flow_nodes`` (512): a 32 x 32
    node qwen3-8b job (tp 16, dp 32, pp 32) trimmed to 16 x 32 nodes, all
    of its sources routed in forests of ``ROUTE_KEYS // n`` sources on the
    card (one forest here).  Its goodput must equal the reference's float;
    its wall time, forests and launches are printed."""
    from repro_torch.cluster import estimate_goodput, make_job, plan_job_mapping
    from repro_torch.core import compiled_flow as cf
    from repro_torch.core.availability import JobAllocation
    from repro_torch.core.mapping import ParallelismPlan
    from repro_torch.core.topology import RailXConfig
    from repro_torch.kernels.flow import flow

    cfg = RailXConfig(m=4, n=4, R=64)
    job = make_job(0, "qwen3-8b", plan=ParallelismPlan(tp=16, cp=1, ep=1, dp=32, pp=32))
    jm = plan_job_mapping(cfg, job)
    alloc = JobAllocation(tuple(range(jm.rows_req)), tuple(range(jm.cols_req)))
    flow.reset_launch_counts()
    cf.reset_route_forest_counts()
    t0 = time.perf_counter()
    g = estimate_goodput(cfg, job, jm.mapping, alloc)
    ms = (time.perf_counter() - t0) * 1e3
    forests = cf.route_forest_counts()
    launches = {k: v for k, v in flow.launch_counts().items() if v}
    print(f"cluster goodput miss at max_flow_nodes 512: qwen3-8b {jm.rows_req}x{jm.cols_req} "
          f"nodes trimmed to 512, railx-hyperx, goodput {g!r} (reference {CLUSTER_MISS!r}), "
          f"{ms:.1f} ms wall, {forests['forests']} forests of {forests['sources']} sources in all, "
          f"launches {launches} [{smi}]", flush=True)
    if g != CLUSTER_MISS:
        fail(f"cluster: the capped miss's goodput {g!r} != the reference's {CLUSTER_MISS!r}")


def _cluster_example(smi: str) -> None:
    """The MLaaS twin, both acts, on the card, its own asserts holding, its
    lines equal to the same run with ``device="cpu"``."""
    mlaas = example("mlaas_allocation")
    lines = {}
    for dev in (None, "cpu"):
        out = lines[dev] = []
        t0 = time.perf_counter()
        try:
            mlaas.run(dev, out.append)
        except AssertionError as e:
            fail(f"cluster: the MLaaS twin's own check failed on {dev or 'cuda'}: {e}")
        print(f"cluster example mlaas_allocation on {dev or 'the card'}: {len(out)} lines in "
              f"{time.perf_counter() - t0:.3f} s wall", flush=True)
    for line in lines[None][-6:]:
        print(f"cluster example: {line}", flush=True)
    if lines[None] != lines["cpu"]:
        fail("cluster: the MLaaS twin's lines on the card differ from the CPU's")


def _cluster_serving(smi: str) -> None:
    """bench_serving's mixed day on railx-hyperx, fixed and autoscale, at
    the H100 service model: the card's fingerprint ``==`` the CPU's.  The
    SLO attainments are printed, not held."""
    for autoscale in (False, True):
        _, fp, srv, wall = serving_day("railx-hyperx", autoscale, None)
        _, cpu_fp, _, cpu_wall = serving_day("railx-hyperx", autoscale, "cpu")
        mode = "autoscale" if autoscale else "fixed"
        print(f"cluster serving railx-hyperx {mode} {SERVING_SIDE}x{SERVING_SIDE} "
              f"{SERVING_HOURS:g} h (H100 service model): slo_attainment "
              f"{srv['slo_attainment']}, p99_queue_delay_s {srv['p99_queue_delay_s']}, "
              f"scale_ups {srv['scale_ups']}; card {wall:.3f} s, CPU {cpu_wall:.3f} s wall; "
              f"fingerprints equal: {fp == cpu_fp} [{smi}]", flush=True)
        if fp != cpu_fp:
            fail(f"cluster: the {mode} serving day on the card differs from the CPU's")


def phase_cluster(smi: str) -> dict:
    """The MLaaS cluster twin with its goodput on the card: bench_cluster's
    128 x 128 day, one job on each ``job_network`` fabric, the MLaaS twin,
    and bench_serving's mixed day, each against the same run on the CPU."""
    day = _cluster_day_on_card(smi)
    _cluster_fabrics(smi)
    _cluster_capped_miss(smi)
    _cluster_example(smi)
    _cluster_serving(smi)
    return day


def phase_model() -> None:
    """Small llama-shaped model: flash kernel on the card vs plain path on
    the CPU with the same weights, in f32; then the recurrent, MoE and
    gemma3 / vlm / whisper smoke models the same way (the last three also
    trained, with gemma3 at Dh 320)."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model

    base = dataclasses.replace(
        get_config("llama3.2-3b"), num_layers=2, d_model=256, heads=4, kv_heads=2,
        d_ff=512, vocab=512,
    )
    gpu_zoo = get_model(dataclasses.replace(base, attn_impl="flash"))
    cpu_zoo = get_model(base)
    params = gpu_zoo.init(0, device="cuda")
    cpu_params = ParamTree.from_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, base.vocab, (2, 100), generator=g)
    with torch.inference_mode():
        got, _ = gpu_zoo.forward(params, {"tokens": tokens.cuda()})
        want, _ = cpu_zoo.forward(cpu_params, {"tokens": tokens})
    err = (got.cpu() - want).abs().max().item()
    print(f"model: small llama f32, card+flash vs cpu+plain: logits {tuple(got.shape)} "
          f"max_abs_err {err:.3e} (tol 1e-3)", flush=True)
    if not bool(torch.isfinite(got).all()) or not err <= 1e-3:
        fail(f"small model on the card disagrees with the CPU plain path: {err}")
    _model_train(base, params)
    _model_recurrent()
    _model_moe()
    for arch in FAMILY_ARCHS:
        family_agreement(arch)
    for base in (*map(get_smoke_config, FAMILY_ARCHS), gemma3_d320_smoke()):
        family_train_agreement(base)
    for arch in RECURRENT_ARCHS:
        recurrent_train_agreement(get_smoke_config(arch))


# smoke recurrent models, f32, card (kernels, cuBLAS) vs CPU (chunked plain
# versions): the same functions summed in other orders, through 4-8 layers
RECURRENT_TOL = 1e-3


def _model_recurrent() -> None:
    """The zamba2 and xlstm smoke configs: SSD / mLSTM kernels on the card vs
    the plain path on the CPU with the same weights, in f32: a forward of
    2 x 100 tokens (chunk 64, padded to 128) and 3 one-token decode steps."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model

    for arch, kname, n_scans in (("zamba2-7b", "ssd_fwd", 8), ("xlstm-125m", "mlstm_fwd", 3)):
        zoo = get_model(get_smoke_config(arch))
        cpu_params = zoo.init(0, device="cpu")
        params = ParamTree.from_state_dict({k: v.cuda() for k, v in cpu_params.state_dict().items()})
        g = torch.Generator().manual_seed(2)
        tokens = torch.randint(0, zoo.cfg.vocab, (2, 100), generator=g)
        reset_launch_counts()
        with torch.inference_mode():
            got, _ = zoo.forward(params, {"tokens": tokens.cuda()})
            counts = launch_counts()
            want, _ = zoo.forward(cpu_params, {"tokens": tokens})
            errs = [(got.cpu() - want).abs().max().item()]
            caches = [zoo.init_cache(2, 8, device=d) for d in ("cuda", "cpu")]
            for t in range(3):
                step = tokens[:, t:t + 1]
                a, caches[0] = zoo.decode_step(params, caches[0], {"tokens": step.cuda()})
                b, caches[1] = zoo.decode_step(cpu_params, caches[1], {"tokens": step})
                errs.append((a.cpu() - b).abs().max().item())
        print(f"model: {zoo.cfg.name} f32, card+{kname} vs cpu+plain: forward max_abs_err "
              f"{errs[0]:.3e}, decode steps {[f'{e:.3e}' for e in errs[1:]]} (tol "
              f"{RECURRENT_TOL:g}); forward launched {kname} {counts[kname]} times", flush=True)
        if not bool(torch.isfinite(got).all()) or max(errs) > RECURRENT_TOL:
            fail(f"{zoo.cfg.name} on the card disagrees with the CPU plain path: {errs}")
        if counts[kname] != n_scans or sum(counts.values()) != n_scans:
            fail(f"{zoo.cfg.name} forward launched {counts}, expected {n_scans} {kname}")


FAMILY_ARCHS = ("gemma3-4b", "qwen2-vl-2b", "whisper-large-v3")


def _grid_positions3(B: int, S: int, side: int):
    """positions3 (3, B, S) of a prompt that is a side x side patch grid,
    (0, row, col) (Qwen2-VL's image positions), and the position at which
    text after it continues in all three streams (side)."""
    import torch

    i = torch.arange(S)
    grid = torch.stack([torch.zeros_like(i), i // side, i % side])
    return grid[:, None].expand(3, B, S).contiguous(), side


def _family_inputs(cfg, B: int, S: int, gen) -> tuple:
    """The first prompt and the decode inputs of a family, drawn from
    ``gen``: (prefill batch, [decode batch of one token per step] x 3).
    vlm: the prompt as embeddings at a patch-grid positions3, the steps
    continuing after the grid; whisper: 40 encoder frames, enc_embeds."""
    import torch

    tokens = torch.randint(0, cfg.vocab, (B, S + 3), generator=gen)
    steps = [{"tokens": tokens[:, S + t:S + t + 1]} for t in range(3)]
    batch = {"tokens": tokens[:, :S]}
    if cfg.family == "vlm":
        pos3, nxt = _grid_positions3(B, S, math.isqrt(S))
        batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=gen), "positions3": pos3}
        for t, st in enumerate(steps):
            st["positions3"] = torch.full((3, B, 1), nxt + t, dtype=torch.long)
    if cfg.family == "whisper":
        batch["enc_embeds"] = torch.randn((B, 40, cfg.d_model), generator=gen)
    return batch, steps


def family_agreement(arch: str) -> tuple:
    """``arch``'s smoke config in f32, flash on the card against the plain
    path on the CPU with the same weights: a forward of 2 x 100 positions
    (gemma3-smoke's window of 8 binds) and 3 one-token decode steps after a
    one-call fill of the prompt.  Fails beyond MOE_MODEL_TOL or on other
    launches than one flash_fwd an attention of the forward; returns
    (errors, forward launches)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model

    base = get_smoke_config(arch)
    gpu_zoo, cpu_zoo = get_model(dataclasses.replace(base, attn_impl="flash")), get_model(base)
    cpu_params = cpu_zoo.init(0, device="cpu")
    params = ParamTree.from_state_dict({k: v.cuda() for k, v in cpu_params.state_dict().items()})
    batch, steps = _family_inputs(base, 2, 100, torch.Generator().manual_seed(5))
    want_launches = n_attentions(base)
    outs = {}
    with torch.inference_mode():
        for side, dev, zoo, p in (("card", "cuda", gpu_zoo, params),
                                  ("host", "cpu", cpu_zoo, cpu_params)):
            reset_launch_counts()
            logits, _ = zoo.forward(p, {k: v.to(dev) for k, v in batch.items()})
            counts = launch_counts()
            cache = zoo.init_cache(2, 103, device=dev)
            if "enc_embeds" in batch:
                cache["enc_out"] = zoo.encode(p, batch["enc_embeds"].to(dev))
            prompt = {k: v.to(dev) for k, v in batch.items() if k != "enc_embeds"}
            fill, cache = zoo.decode_step(p, cache, prompt)
            dec = [fill[:, -1:].cpu()]
            for st in steps:
                lg, cache = zoo.decode_step(p, cache, {k: v.to(dev) for k, v in st.items()})
                dec.append(lg.cpu())
            outs[side] = (logits.cpu(), dec, counts)
    (got, gdec, counts), (want, wdec, _) = outs["card"], outs["host"]
    errs = [(got - want).abs().max().item()] + [(a - b).abs().max().item()
                                                for a, b in zip(gdec, wdec)]
    print(f"model: {base.name} f32, card+flash vs cpu+plain: forward logits {tuple(got.shape)} "
          f"max_abs_err {errs[0]:.3e}, fill and decode steps {[f'{e:.3e}' for e in errs[1:]]} "
          f"(tol {MOE_MODEL_TOL:g}); forward launched flash_fwd {counts['flash_fwd']} times "
          f"(want {want_launches})", flush=True)
    if not bool(torch.isfinite(got).all()) or max(errs) > MOE_MODEL_TOL:
        fail(f"{base.name} on the card disagrees with the CPU plain path: {errs}")
    if counts["flash_fwd"] != want_launches or sum(counts.values()) != want_launches:
        fail(f"{base.name} forward launched {counts}, expected {want_launches} flash_fwd")
    return errs, counts["flash_fwd"]


# two f32 train steps, card vs CPU.  loss and grad_norm: f32 sums in another
# order (~1e-6 relative).  params: after AdamW's first steps an element moves
# by lr * mhat / (sqrt(vhat) + eps), about lr = 1e-3, and the two sides' grads
# agree to ~1e-6 relative, so 99.9 % of elements agree within 1e-6 abs; an
# element whose grad is near zero has an unstable ratio and may differ by a
# fraction of a step, so every element stays within 1e-4 (10 % of lr).
MODEL_LOSS_RTOL, MODEL_GNORM_RTOL = 1e-5, 1e-4
MODEL_PARAM_TIGHT, MODEL_PARAM_SHARE, MODEL_PARAM_MAX = 1e-6, 0.999, 1e-4


def _train_card_vs_cpu(tag: str, base, state: dict, batches: list, n_attn: int,
                       scans: Optional[dict] = None) -> tuple:
    """AdamW steps of ``base`` in f32 from the weights ``state``, one a
    batch: the kernels with remat on the card against the plain path on the
    CPU.  Fails unless the card launched 2 flash_fwd_lse and one each of
    flash_bwd_dq and flash_bwd_dkv per attention (``n_attn`` a forward) a
    step, the scan launches ``scans`` ({kernel: launches a step}, none by
    default), and nothing else, and the two sides agree on loss, grad_norm
    and params within the MODEL_* bounds; -> the card's (params, AdamW
    state)."""
    import torch

    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    sides = {}
    for dev, cfg in (("cuda", dataclasses.replace(base, attn_impl="flash", remat=True)),
                     ("cpu", base)):
        params = ParamTree.from_state_dict({k: v.to(dev).clone() for k, v in state.items()},
                                           requires_grad=True)
        step_fn = make_train_step(get_model(cfg), ocfg, device=dev)
        opt = opt_lib.init(ocfg, params)
        reset_launch_counts()
        metrics = []
        for batch in batches:
            params, opt, m = step_fn(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        sides[dev] = (params, opt, metrics, launch_counts())
    (gp, gopt, gm, counts), (cp, _, cm, _) = sides["cuda"], sides["cpu"]
    n = n_attn * len(batches)
    want = {"flash_fwd": 0, "flash_fwd_lse": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "ssd_fwd": 0, "mlstm_fwd": 0}
    want.update({k: v * len(batches) for k, v in (scans or {}).items()})
    print(f"{tag}: {len(batches)} train steps (remat) on the card launched {counts}", flush=True)
    if counts != want:
        fail(f"{tag}: {len(batches)} train steps launched {counts}, expected {want}")
    for step, (g, c) in enumerate(zip(gm, cm)):
        dl = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        dg = abs(g["grad_norm"] - c["grad_norm"]) / abs(c["grad_norm"])
        print(f"{tag}: train step {step} card loss {g['loss']:.7f} gnorm {g['grad_norm']:.7f}, "
              f"cpu loss {c['loss']:.7f} gnorm {c['grad_norm']:.7f}: rel diff {dl:.2e} "
              f"(tol {MODEL_LOSS_RTOL:g}), {dg:.2e} (tol {MODEL_GNORM_RTOL:g})", flush=True)
        if not (dl <= MODEL_LOSS_RTOL and dg <= MODEL_GNORM_RTOL):
            fail(f"{tag}: train step {step}: card and CPU disagree on loss or grad_norm")
    cstate = cp.state_dict()
    diff = torch.cat([(v.cpu() - cstate[k]).abs().flatten() for k, v in gp.state_dict().items()])
    perr, share = diff.max().item(), (diff <= MODEL_PARAM_TIGHT).float().mean().item()
    print(f"{tag}: params after {len(batches)} steps, card vs cpu: max_abs_err {perr:.3e} (tol "
          f"{MODEL_PARAM_MAX:g}), share within {MODEL_PARAM_TIGHT:g}: {share:.6f} "
          f"(need {MODEL_PARAM_SHARE})", flush=True)
    if not (perr <= MODEL_PARAM_MAX and share >= MODEL_PARAM_SHARE):
        fail(f"{tag}: params after {len(batches)} train steps disagree: max {perr}, "
             f"share {share}")
    return gp, gopt


def _model_train(base, init_params) -> None:
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    state = {k: v.detach() for k, v in init_params.state_dict().items()}
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=128, global_batch=4))
    gp, gopt = _train_card_vs_cpu("model", base, state, [data.batch(s) for s in range(2)],
                                  base.num_layers)
    with tempfile.TemporaryDirectory() as d:
        ckpt_lib.save(d, 2, {"params": gp, "opt": gopt}, extra={"step": 2})
        tree, extra = ckpt_lib.restore(d, {"params": gp, "opt": gopt})
    same = (extra["step"] == 2 and tree["opt"].step == gopt.step
            and all(torch.equal(v, gp.state_dict()[k]) for k, v in tree["params"].state_dict().items())
            and all(torch.equal(tree["opt"].mu[k], gopt.mu[k]) and torch.equal(tree["opt"].nu[k], gopt.nu[k])
                    for k in gopt.mu))
    print(f"model: checkpoint save/restore of params and AdamW state on the card: "
          f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
    if not same:
        fail("checkpoint round trip changed the training state")


def n_attentions(cfg) -> int:
    """Attention calls of one forward: one a layer, whisper's decoder two
    (self and cross) and its encoder one."""
    return cfg.num_layers * (2 if cfg.family == "whisper" else 1) + cfg.enc_layers


def gemma3_d320_smoke():
    """gemma3-smoke widened to gemma3-4b's head dim: d_model 640 over 2
    heads (1 kv head) is Dh 320; its window of 8 binds."""
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config("gemma3-4b"), name="gemma3-4b-smoke-d320",
                               d_model=640, heads=2, kv_heads=1)


def family_train_agreement(base) -> None:
    """Two f32 AdamW steps of ``base`` (a smoke config of the gemma3, vlm or
    whisper family, or ``gemma3_d320_smoke``) on the card against the CPU
    (``_train_card_vs_cpu``): 4 x 128 tokens from the bigram corpus; vlm at
    an 11-wide patch grid's positions3, whisper with 40 encoder frames."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model

    state = {k: v.detach() for k, v in get_model(base).init(0, device="cpu").state_dict().items()}
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=128, global_batch=4))
    gen = torch.Generator().manual_seed(6)
    batches = []
    for step in range(2):
        batch = data.batch(step)
        if base.family == "vlm":
            batch["positions3"] = _grid_positions3(4, 128, 11)[0]
        if base.family == "whisper":
            batch["enc_embeds"] = torch.randn((4, 40, base.d_model), generator=gen)
        batches.append(batch)
    _train_card_vs_cpu(f"model: {base.name} Dh={base.resolved_head_dim}", base, state, batches,
                       n_attentions(base))


RECURRENT_ARCHS = ("zamba2-7b", "xlstm-125m")


def scan_launches(cfg, remat: bool) -> dict:
    """The scan kernel's launches in one training step of the hybrid or
    xLSTM family: one a Mamba2 / mLSTM layer a forward, the hybrid's grouped
    layers and every xLSTM layer run twice under remat (the reference
    rematerialises the hybrid's groups, not its tail), the backward none
    (it differentiates the sequential scan)."""
    twice = 2 if remat else 1
    if cfg.family == "hybrid":
        grouped = cfg.num_layers // cfg.shared_attn_every * cfg.shared_attn_every
        return {"ssd_fwd": twice * grouped + cfg.num_layers - grouped}
    every = cfg.xlstm_slstm_every
    mlstm = sum(1 for i in range(cfg.num_layers) if i % every != every - 1)
    return {"mlstm_fwd": twice * mlstm}


# a leaf's gradient, card against CPU from the same params, relative to the
# leaf's largest element: the mLSTM backward's tolerance on the CPU
# (tests/test_torch_mlstm.py, tests/test_torch_family_train.py GRAD_RTOL)
GRAD_LEAF_RTOL = 1e-4


def recurrent_train_agreement(base) -> None:
    """Two f32 AdamW steps of the zamba2 smoke config on the card (SSD
    kernel, remat) against the CPU (the chunked plain version), 4 x 128
    tokens from the bigram corpus, at the train rows' bounds
    (``_train_card_vs_cpu``).  xLSTM's first AdamW step moves a parameter
    whose gradient is near zero by up to lr either way (1.02e-3 on the
    card), so for xlstm-smoke each of the two steps' gradients is held
    instead, from the CPU's params before it: the loss and grad norm at the
    train rows' bounds, each leaf within GRAD_LEAF_RTOL of its largest
    element, and the mLSTM launches of a remat step."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    state = {k: v.detach() for k, v in get_model(base).init(0, device="cpu").state_dict().items()}
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=128, global_batch=4))
    batches = [data.batch(s) for s in range(2)]
    scans = scan_launches(dataclasses.replace(base, remat=True), True)
    if base.family != "xlstm":
        _train_card_vs_cpu(f"model: {base.name}", base, state, batches, 0, scans)
        return
    tag = f"model: {base.name}"
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params = ParamTree.from_state_dict({k: v.clone() for k, v in state.items()},
                                       requires_grad=True)
    opt, step_fn = opt_lib.init(ocfg, params), make_train_step(get_model(base), ocfg, device="cpu")
    for step, batch in enumerate(batches):
        sides = {}
        for dev, cfg in (("cuda", dataclasses.replace(base, remat=True)), ("cpu", base)):
            p = ParamTree.from_state_dict({k: v.detach().to(dev).clone()
                                           for k, v in params.state_dict().items()},
                                          requires_grad=True)
            reset_launch_counts()
            loss, _ = get_model(cfg).loss(p, {k: torch.as_tensor(v, device=dev)
                                              for k, v in batch.items()})
            loss.backward()
            grads = {k: q.grad.cpu() for k, q in p.named_parameters()}
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).item()
            sides[dev] = (float(loss), norm, grads, launch_counts())
        (gl, gn, gg, counts), (cl, cn, cg, _) = sides["cuda"], sides["cpu"]
        leaf = max((gg[k] - cg[k]).abs().max().item() / max(cg[k].abs().max().item(), 1e-30)
                   for k in cg)
        dl, dn = abs(gl - cl) / abs(cl), abs(gn - cn) / abs(cn)
        want = {**{k: 0 for k in counts}, **scans}
        print(f"{tag}: step {step} gradients from the CPU's params: card loss {gl:.7f} gnorm "
              f"{gn:.7f}, cpu loss {cl:.7f} gnorm {cn:.7f}: rel diff {dl:.2e} (tol "
              f"{MODEL_LOSS_RTOL:g}), {dn:.2e} (tol {MODEL_GNORM_RTOL:g}); largest leaf "
              f"difference {leaf:.2e} of its largest element (tol {GRAD_LEAF_RTOL:g}); launched "
              f"{counts}", flush=True)
        if not (dl <= MODEL_LOSS_RTOL and dn <= MODEL_GNORM_RTOL and leaf <= GRAD_LEAF_RTOL):
            fail(f"{tag}: step {step}: card and CPU gradients disagree")
        if counts != want:
            fail(f"{tag}: a step launched {counts}, expected {want}")
        params, opt, _ = step_fn(params, opt, batch)


# moonshot-smoke in f32, card (flash, cuBLAS) vs CPU: routed alike, the two
# differ by f32 sums in another order (dispatch and combine are a scatter
# into slots and a per-token gather: no accumulating scatter).  A near-tie in
# the router can flip an expert on one side and move a token's output by
# O(1): the share of token -> expert choices that agree is printed, and a
# flip is reported with its size and fails the run (it is not hidden by a
# wider tolerance).
MOE_MODEL_TOL = 1e-3     # abs, logits (the small llama's bound)
MOE_AUX_RTOL = 1e-5


@contextlib.contextmanager
def routing_choices():
    """Record each MoE routing call's (T, K) expert choices, in call order,
    by wrapping ``models.moe._route`` while the block runs."""
    from repro_torch.models import moe

    route, calls = moe._route, []

    def recorded(*args, **kw):
        r = route(*args, **kw)
        calls.append(r.experts)
        return r

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def _routing_agreement(tag: str, what: str, got: list, want: list) -> float:
    """The share of (token, k) expert choices equal between two traces of
    the same routing calls; prints each flip."""
    import torch

    if len(got) != len(want):
        fail(f"{tag}: {what}: {len(got)} routing calls against {len(want)}")
    same = total = 0
    for i, (a, b) in enumerate(zip(got, want)):
        eq = a.cpu() == b
        same, total = same + int(eq.sum()), total + eq.numel()
        rows = (~eq).any(-1).nonzero().flatten().tolist()
        if rows:
            print(f"{tag}: {what}: routing call {i}: {len(rows)} of {eq.shape[0]} tokens chose "
                  f"other experts (tokens {rows[:8]})", flush=True)
    return same / max(total, 1)


def _model_moe() -> None:
    """moonshot-smoke (64 experts cut to 4, top-2) in f32: flash kernels and
    remat on the card against the plain path on the CPU with the same
    weights: a forward (logits, aux), two train steps (loss, aux,
    grad_norm) and 3 decode steps, with the share of expert choices that
    agree."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    tag = "model: moonshot-smoke"
    base = get_smoke_config("moonshot-v1-16b-a3b")
    gpu_zoo, cpu_zoo = get_model(dataclasses.replace(base, attn_impl="flash")), get_model(base)
    cpu_params = cpu_zoo.init(0, device="cpu")
    state = {k: v.detach() for k, v in cpu_params.state_dict().items()}
    params = ParamTree.from_state_dict({k: v.cuda() for k, v in state.items()})
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, base.vocab, (2, 100), generator=g)
    with torch.inference_mode():
        with routing_choices() as tg:
            got, aux_g = gpu_zoo.forward(params, {"tokens": tokens.cuda()})
        with routing_choices() as tc:
            want, aux_c = cpu_zoo.forward(cpu_params, {"tokens": tokens})
        share = _routing_agreement(tag, "forward", tg, tc)
        err = (got.cpu() - want).abs().max().item()
        daux = abs(aux_g.item() - aux_c.item()) / abs(aux_c.item())
        caches = [gpu_zoo.init_cache(2, 8, device="cuda"), cpu_zoo.init_cache(2, 8, device="cpu")]
        derrs = []
        with routing_choices() as dg:
            outs_g = []
            for t in range(3):
                a, caches[0] = gpu_zoo.decode_step(params, caches[0],
                                                   {"tokens": tokens[:, t:t + 1].cuda()})
                outs_g.append(a.cpu())
        with routing_choices() as dc:
            for t in range(3):
                b, caches[1] = cpu_zoo.decode_step(cpu_params, caches[1],
                                                   {"tokens": tokens[:, t:t + 1]})
                derrs.append((outs_g[t] - b).abs().max().item())
        dshare = _routing_agreement(tag, "decode", dg, dc)
    print(f"{tag} f32, card+flash vs cpu+plain: forward logits {tuple(got.shape)} max_abs_err "
          f"{err:.3e} (tol {MOE_MODEL_TOL:g}), aux {aux_g.item():.6f} vs {aux_c.item():.6f} rel "
          f"{daux:.2e} (tol {MOE_AUX_RTOL:g}); decode steps max_abs_err "
          f"{[f'{e:.3e}' for e in derrs]}; expert choices agreeing: forward {share:.6f}, "
          f"decode {dshare:.6f}", flush=True)
    if not (bool(torch.isfinite(got).all()) and err <= MOE_MODEL_TOL and daux <= MOE_AUX_RTOL
            and max(derrs) <= MOE_MODEL_TOL and aux_g.item() > 0
            and share == 1 and dshare == 1):
        fail(f"{tag} on the card disagrees with the CPU (expert choices agreeing {share}, "
             f"decode {dshare})")

    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=128, global_batch=4))
    sides = {}
    for dev, cfg in (("cuda", dataclasses.replace(base, attn_impl="flash", remat=True)),
                     ("cpu", base)):
        p = ParamTree.from_state_dict({k: v.to(dev).clone() for k, v in state.items()},
                                      requires_grad=True)
        step_fn = make_train_step(get_model(cfg), ocfg, device=dev)
        opt = opt_lib.init(ocfg, p)
        fa.reset_launch_counts()
        metrics = []
        for step in range(2):
            p, opt, m = step_fn(p, opt, data.batch(step))
            metrics.append({k: float(v) for k, v in m.items()})
        sides[dev] = (metrics, fa.launch_counts())
    (gm, counts), (cm, _) = sides["cuda"], sides["cpu"]
    L = base.num_layers
    want_counts = {"flash_fwd": 0, "flash_fwd_lse": 2 * 2 * L, "flash_bwd_dq": 2 * L,
                   "flash_bwd_dkv": 2 * L}
    if counts != want_counts:
        fail(f"{tag}: 2 train steps launched {counts}, expected {want_counts}")
    for step, (a, b) in enumerate(zip(gm, cm)):
        gaps = {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "aux", "grad_norm")}
        print(f"{tag}: train step {step} card loss {a['loss']:.7f} aux {a['aux']:.7f} gnorm "
              f"{a['grad_norm']:.7f}, cpu loss {b['loss']:.7f} aux {b['aux']:.7f} gnorm "
              f"{b['grad_norm']:.7f}: rel diff {gaps['loss']:.2e} / {gaps['aux']:.2e} / "
              f"{gaps['grad_norm']:.2e} (tol {MODEL_LOSS_RTOL:g} / {MOE_AUX_RTOL:g} / "
              f"{MODEL_GNORM_RTOL:g}); launches {counts}", flush=True)
        if not (gaps["loss"] <= MODEL_LOSS_RTOL and gaps["aux"] <= MOE_AUX_RTOL
                and gaps["grad_norm"] <= MODEL_GNORM_RTOL):
            fail(f"{tag}: train step {step}: card and CPU disagree")


def phase_serve(smi: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import (
        BatchScheduler, Request, ServeArtifacts, make_serve_step, serve_waves,
    )

    SLOTS, PROMPT, MAX_NEW, N_REQ = 4, 1024, 32, 8
    CACHE = PROMPT + MAX_NEW
    cfg = dataclasses.replace(
        get_config("llama3.2-3b"), param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16, attn_impl="flash",
    )
    zoo = get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} H={cfg.heads} "
          f"Hk={cfg.kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} bf16, {n_params / 1e9:.3f} B params, "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)

    arts = make_serve_step(zoo, device="cuda")
    times = {"prefill": [], "fill": [], "decode": []}

    def timed_prefill(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = arts.prefill_fn(p, batch)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t)
        return out

    def timed_decode(p, cache, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = arts.decode_fn(p, cache, batch)
        torch.cuda.synchronize()
        times["fill" if batch["tokens"].shape[1] > 1 else "decode"].append(time.perf_counter() - t)
        return out

    sched = BatchScheduler(slots=SLOTS, eos_id=0)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(2, cfg.vocab, PROMPT), max_new=MAX_NEW)
            for i in range(N_REQ)]
    for r in reqs:
        sched.submit(r)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    waves = serve_waves(zoo, ServeArtifacts(timed_decode, timed_prefill), params, sched, CACHE,
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["flash_fwd"]

    for r in reqs:
        ok = len(r.generated) == r.max_new or (r.generated and r.generated[-1] == sched.eos_id)
        if not (r.done and ok):
            fail(f"request {r.rid} unanswered: {len(r.generated)} tokens, done={r.done}")
    n_prefill = len(times["prefill"])
    print(f"serve: {len(reqs)} requests answered in {len(waves)} waves; tokens per request "
          f"{[len(r.generated) for r in reqs]}", flush=True)
    if launches != cfg.num_layers * n_prefill or launches == 0:
        fail(f"flash_fwd launched {launches} times, expected {cfg.num_layers} x {n_prefill} prefills")
    if any(n for k, n in counts.items() if k != "flash_fwd"):
        fail(f"serving launched another kernel than flash_fwd: {counts}")
    print(f"serve: flash_fwd launches {launches} = {cfg.num_layers} layers x {n_prefill} prefills")

    # prefill (flash kernel, bf16 probabilities) vs cache fill (plain
    # attention, f32 probabilities), last prompt position.  The two round
    # differently inside attention and the bf16 residual stream carries that
    # through 28 layers: hold the rms of the difference to 5% of the logits'
    # std and its max (over 4 x 128256 logits) to 25%.
    TOL_RMS, TOL_MAX = 0.05, 0.25
    for w in waves:
        a, b = w.prefill_last.float(), w.fill_last.float()
        if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail("non-finite logits")
        std = a.std().item()
        diff = (a - b).abs().max().item()
        rms = (a - b).pow(2).mean().sqrt().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        print(f"serve: wave {[r.rid for r in w.requests]} prefill-vs-fill last logits: "
              f"max_abs_diff {diff:.4f}, rms_diff {rms:.4f}, std {std:.4f}, "
              f"max/std {diff / std:.4f} (tol {TOL_MAX}), rms/std {rms / std:.4f} (tol {TOL_RMS}), "
              f"argmax agreement {agree:.2f}", flush=True)
        if not (diff / std <= TOL_MAX and rms / std <= TOL_RMS):
            fail("prefill and cache-fill logits disagree beyond tolerance")

    gen_tokens = sum(len(r.generated) for r in reqs)
    prefill_ms = 1e3 * sum(times["prefill"]) / n_prefill
    fill_ms = 1e3 * sum(times["fill"]) / len(times["fill"])
    step_ms = 1e3 * sum(times["decode"]) / len(times["decode"])
    print(f"serve: per-wave ms: prefill {[round(1e3 * t, 2) for t in times['prefill']]}, "
          f"cache fill {[round(1e3 * t, 2) for t in times['fill']]}")
    print(f"serve: prefill {prefill_ms:.2f} ms per wave ({SLOTS}x{PROMPT} tokens), cache fill "
          f"{fill_ms:.2f} ms, decode {step_ms:.3f} ms/step ({SLOTS} slots), "
          f"decode {SLOTS * 1e3 / step_ms:.1f} tokens/s, "
          f"end to end {gen_tokens / wall:.1f} generated tokens/s over {wall:.2f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]",
          flush=True)
    return {"flash_fwd": launches}


# prefill vs cache fill, last prompt position: (rms, max) of |diff| over the
# logits' std.  Hybrid: the dense serve phase's bounds.  xLSTM: the recurrent
# form (the fill) divides each mLSTM head's output by max(|q.n|, 1), the
# chunkwise form (the prefill) by max(|q.n|, exp(-m)) (a reference quirk), and
# |q.n| < 1 at most positions of the random-weight model.  The per-head
# RMSNorm that follows removes that scale, but in bf16 the two differently
# scaled outputs round apart: each mLSTM layer's output then differs by about
# one bf16 rounding (2^-8 of its std) where equal values would differ in a few
# elements only, and the 12-layer stack magnifies that (each bf16 rounding of
# a value perturbed by less than its rounding step moves it by a whole step,
# or not at all).  With the fill dividing as the prefill does, each layer
# differs by 16 times less, yet the logits still by 0.11 rms of their std:
# the stack, not the kernel, makes most of the end-to-end gap
# (``chip_profile.py xlstm_agreement``).  So each mLSTM layer is held, on its
# prefill input, at 0.01 rms (two and a half bf16 roundings) and 0.1 max of
# the std (seed 0 reads 0.0038-0.0039 and 0.033 in every layer); the stack's bf16
# logits at a third (rms) and a seventh (max) over the reading of seed 0
# (0.150, 0.877); the same weights in f32, where only the RMSNorm's epsilon
# sees the scale, tightly.
SERVE_TOL = (0.05, 0.25)
XLSTM_BF16_TOL, XLSTM_F32_TOL, XLSTM_LAYER_TOL = (0.2, 1.0), (0.01, 0.05), (0.01, 0.1)


def _rel(a, b) -> tuple:
    """(rms, max) of |a - b| over the std of a, in f32."""
    a, b = a.float(), b.float()
    std = a.std()
    return ((a - b).pow(2).mean().sqrt() / std).item(), ((a - b).abs().max() / std).item()


def xlstm_layer_walk(zoo, params, tokens) -> tuple:
    """Walk the xLSTM stack over ``tokens`` twice from a zero state: by the
    prefill's full-sequence forms (mLSTM through ``mlstm_fwd`` on the card)
    and by the cache fill's recurrent forms.  Per layer, the two forms'
    outputs on the prefill's own input (``local``: what this layer alone
    adds) and the two residual streams after it (``stream``: what the stack
    has made of it), each as ``_rel``.  Returns (rows [(layer, kind, local,
    stream)], prefill last logits, fill last logits)."""
    import torch

    from repro_torch.models import common as C
    from repro_torch.models import xlstm_lm
    from repro_torch.models.ssm import mlstm, slstm

    cfg = zoo.cfg
    dt, xc = xlstm_lm._dt(cfg), xlstm_lm._xcfg(cfg)
    zero = zoo.init_cache(tokens.shape[0], 0, device=tokens.device)
    rows = []
    with torch.no_grad():
        xa = xb = C.embed(params["embed"], tokens, dt)
        for i, is_s in enumerate(xlstm_lm._is_slstm_flags(cfg)):
            lp = C.layer_slice(params["layers"], i)
            kind = "slstm" if is_s else "mlstm"
            block = slstm if is_s else mlstm
            state = {k: v[i] for k, v in zero[kind].items()}
            ha, hb = C.rmsnorm(lp["ln"], xa), C.rmsnorm(lp["ln"], xb)
            oa = block(lp[kind], xc, ha, dt)[0]
            local = _rel(oa, block(lp[kind], xc, ha, dt, state=state)[0])
            xa, xb = xa + oa, xb + block(lp[kind], xc, hb, dt, state=state)[0]
            rows.append((i, kind, local, _rel(xa, xb)))
        last = [C.unembed(params["embed"], C.rmsnorm(params["final_norm"], x[:, -1:]), dt)[:, 0]
                for x in (xa, xb)]
    return rows, last[0], last[1]


def _agreement(tag: str, what: str, a, b, tol) -> None:
    import torch

    a, b = a.float(), b.float()
    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"{tag}: non-finite logits")
    std = a.std().item()
    rms, mx = _rel(a, b)
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"{tag}: {what} last logits: max_abs_diff {mx * std:.4f}, rms_diff {rms * std:.4f}, "
          f"std {std:.4f}, max/std {mx:.4f} (tol {tol[1]}), rms/std {rms:.4f} "
          f"(tol {tol[0]}), argmax agreement {agree:.2f}", flush=True)
    if not (rms <= tol[0] and mx <= tol[1]):
        fail(f"{tag}: {what} logits disagree beyond tolerance")


def _serve_recurrent(smi: str, tag: str, arch: str, prompt: int, max_new: int, kname: str,
                     n_scans: int, tol=SERVE_TOL, f32_tol=None, layer_tol=None) -> dict:
    """Serve 4 requests in one wave of 4 slots with ``arch`` at full size in
    bf16, random weights from seed 0; ``kname`` must launch ``n_scans`` times
    per prefill and no other kernel may launch.  With ``layer_tol`` (xLSTM),
    each mLSTM layer's two forms are then held to it on the prompts
    (``xlstm_layer_walk``); with ``f32_tol``, the same weights in f32 give the
    prompts' prefill and one-call fill logits, held to it.  Returns
    {kname: launches}."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import (
        BatchScheduler, Request, ServeArtifacts, make_serve_step, serve_waves,
    )

    slots = n_req = 4
    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    zoo = get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag}: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} H={cfg.heads} "
          f"vocab={cfg.vocab} bf16, {n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    arts = make_serve_step(zoo, device="cuda")
    fill_calls = prompt if zoo.decode_tokens == 1 else 1
    times = {"prefill": [], "fill": [], "decode": []}
    since_prefill = [0]

    def timed_prefill(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = arts.prefill_fn(p, batch)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t)
        since_prefill[0] = 0
        return out

    def timed_decode(p, cache, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = arts.decode_fn(p, cache, batch)
        torch.cuda.synchronize()
        kind = "fill" if since_prefill[0] < fill_calls else "decode"
        times[kind].append(time.perf_counter() - t)
        since_prefill[0] += 1
        return out

    sched = BatchScheduler(slots=slots, eos_id=0)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(2, cfg.vocab, prompt), max_new=max_new)
            for i in range(n_req)]
    for r in reqs:
        sched.submit(r)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    waves = serve_waves(zoo, ServeArtifacts(timed_decode, timed_prefill), params, sched,
                        prompt + max_new, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    for r in reqs:
        ok = len(r.generated) == r.max_new or (r.generated and r.generated[-1] == sched.eos_id)
        if not (r.done and ok):
            fail(f"request {r.rid} unanswered: {len(r.generated)} tokens, done={r.done}")
    n_prefill = len(times["prefill"])
    print(f"{tag}: {n_req} requests answered in {len(waves)} wave(s); tokens per request "
          f"{[len(r.generated) for r in reqs]}; launches {counts}", flush=True)
    if counts[kname] != n_scans * n_prefill or any(n for k, n in counts.items() if k != kname):
        fail(f"{tag} launched {counts}, expected {n_scans} x {n_prefill} {kname} and nothing else")
    print(f"{tag}: {kname} launches {counts[kname]} = {n_scans} layers x {n_prefill} prefill(s)")

    # prefill (the chunked scan kernel) vs the cache fill (the recurrence),
    # last prompt position
    for w in waves:
        _agreement(tag, "bf16 prefill-vs-fill", w.prefill_last, w.fill_last, tol)
    if layer_tol is not None:
        toks = torch.as_tensor(np.stack([r.prompt for r in reqs]), device="cuda")
        rows = xlstm_layer_walk(zoo, params, toks)[0]
        for i, kind, local, stream in rows:
            print(f"{tag}: bf16 layer {i:2d} {kind}: kernel-vs-recurrence on the prefill input "
                  f"rms/std {local[0]:.4f} max/std {local[1]:.4f}; residual stream prefill-vs-fill "
                  f"rms/std {stream[0]:.4f}", flush=True)
        worst = [max(r[2][j] for r in rows if r[1] == "mlstm") for j in (0, 1)]
        print(f"{tag}: worst mLSTM layer rms/std {worst[0]:.4f} (tol {layer_tol[0]}), max/std "
              f"{worst[1]:.4f} (tol {layer_tol[1]})", flush=True)
        if not (worst[0] <= layer_tol[0] and worst[1] <= layer_tol[1]):
            fail(f"{tag}: an mLSTM layer's two forms disagree beyond tolerance")
    if f32_tol is not None:
        from repro_torch.models.common import ParamTree

        zoo32 = get_model(dataclasses.replace(cfg, param_dtype=torch.float32,
                                              compute_dtype=torch.float32))
        p32 = ParamTree.from_state_dict({k: v.float() for k, v in params.state_dict().items()})
        arts32 = make_serve_step(zoo32, device="cuda")
        toks = torch.as_tensor(np.stack([r.prompt for r in reqs]))  # the steps move it
        a = arts32.prefill_fn(p32, {"tokens": toks})[:, -1]
        b, _ = arts32.decode_fn(p32, zoo32.init_cache(n_req, prompt, device="cuda"),
                                {"tokens": toks})
        _agreement(tag, "f32 (same weights) prefill-vs-fill", a, b[:, -1], f32_tol)
        del p32, a, b

    gen_tokens = sum(len(r.generated) for r in reqs)
    prefill_ms = 1e3 * sum(times["prefill"]) / n_prefill
    fill_ms = 1e3 * sum(times["fill"]) / n_prefill
    step_ms = 1e3 * sum(times["decode"]) / len(times["decode"])
    print(f"{tag}: prefill {prefill_ms:.2f} ms per wave ({slots}x{prompt} tokens), cache fill "
          f"{fill_ms:.2f} ms per wave in {fill_calls} call(s) "
          f"({fill_ms / fill_calls:.3f} ms per call), decode {step_ms:.3f} ms/step ({slots} slots), "
          f"decode {slots * 1e3 / step_ms:.1f} tokens/s, end to end {gen_tokens / wall:.1f} "
          f"generated tokens/s over {wall:.2f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
    return {kname: counts[kname]}


def phase_serve_hybrid(smi: str) -> dict:
    """zamba2-7b at full width and depth: 4 x 256-token prompts, 16 new
    tokens each; the hybrid decode takes one token per call, so the cache
    fill is 256 host-bound steps, and 256-token prompts keep it short."""
    return _serve_recurrent(smi, "serve_hybrid", "zamba2-7b", prompt=256, max_new=16,
                            kname="ssd_fwd", n_scans=81)


def phase_serve_xlstm(smi: str) -> dict:
    """xlstm-125m at full size: 4 x 1024-token prompts, 32 new tokens each;
    9 of its 12 layers are mLSTM."""
    return _serve_recurrent(smi, "serve_xlstm", "xlstm-125m", prompt=1024, max_new=32,
                            kname="mlstm_fwd", n_scans=9, tol=XLSTM_BF16_TOL,
                            f32_tol=XLSTM_F32_TOL, layer_tol=XLSTM_LAYER_TOL)


# moonshot-v1-16b-a3b's init must fit one card with room for serving
MOE_INIT_PEAK_GIB = 60.0
# the reference's own bound on MoE prefill against decode (argmax agreement,
# tests/test_models_smoke.py), and the rms of prefill (flash) minus fill
# (plain attention) over the logits' std: both route all 4096 tokens in one
# call at capacity 480, so they differ by bf16 roundings that move a few
# near-tie routings; sound runs read 0.0531 and 0.0538, a wrong kernel O(1)
MOE_ARGMAX_AGREE = 0.7
MOE_PREFILL_RMS = 0.1


def phase_serve_moe(smi: str) -> None:
    """moonshot-v1-16b-a3b at full width and depth in bf16 (48 layers, 64
    experts top-6, 28.06 B params), random weights from seed 0: 4 requests
    of 1024-token prompts, 32 new tokens each, one wave of 4 slots; 48
    flash_fwd launches per prefill; prefill against the one-call cache fill
    over every prompt position, at the reference's MoE bound."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import (
        BatchScheduler, Request, ServeArtifacts, make_serve_step, serve_waves,
    )

    tag, slots, prompt, max_new = "serve_moe", 4, 1024, 32
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, attn_impl="flash")
    zoo = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in params.parameters())
    held = torch.cuda.memory_allocated() / 2**30
    print(f"{tag}: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} H={cfg.heads} "
          f"experts={cfg.moe.num_experts} top-{cfg.moe.top_k} d_ff={cfg.moe.d_ff} "
          f"vocab={cfg.vocab} bf16, {n_params / 1e9:.3f} B params ({held:.2f} GiB held), init "
          f"{init_s:.2f} s, init peak {init_peak:.2f} GiB (limit {MOE_INIT_PEAK_GIB}) [{smi}]",
          flush=True)
    if not init_peak < MOE_INIT_PEAK_GIB:
        fail(f"{tag}: the init peaked at {init_peak:.2f} GiB")

    arts = make_serve_step(zoo, device="cuda")
    times = {"prefill": [], "fill": [], "decode": []}
    held_logits, agreement = {}, []

    def timed_prefill(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = arts.prefill_fn(p, batch)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t)
        held_logits["prefill"] = out
        return out

    def timed_decode(p, cache, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = arts.decode_fn(p, cache, batch)
        torch.cuda.synchronize()
        fill = batch["tokens"].shape[1] > 1
        times["fill" if fill else "decode"].append(time.perf_counter() - t)
        if fill:  # every prompt position of the prefill against the fill, a row at a time
            a, b = held_logits.pop("prefill"), out[0]
            same, sq, s1, s2 = 0, 0.0, 0.0, 0.0
            for i in range(a.shape[0]):
                ai, bi = a[i].float(), b[i].float()
                if not bool(torch.isfinite(ai).all() and torch.isfinite(bi).all()):
                    fail(f"{tag}: non-finite logits")
                same += int((ai.argmax(-1) == bi.argmax(-1)).sum())
                sq += float((ai - bi).pow(2).sum())
                s1, s2 = s1 + float(ai.sum()), s2 + float(ai.pow(2).sum())
            n = a.numel()
            agreement.append((same / (n // a.shape[-1]),
                              math.sqrt(sq / n) / math.sqrt(s2 / n - (s1 / n) ** 2)))
        return out

    sched = BatchScheduler(slots=slots, eos_id=0)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(2, cfg.vocab, prompt), max_new=max_new)
            for i in range(slots)]
    for r in reqs:
        sched.submit(r)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    waves = serve_waves(zoo, ServeArtifacts(timed_decode, timed_prefill), params, sched,
                        prompt + max_new, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for r in reqs:
        ok = len(r.generated) == r.max_new or (r.generated and r.generated[-1] == sched.eos_id)
        if not (r.done and ok):
            fail(f"{tag}: request {r.rid} unanswered: {len(r.generated)} tokens, done={r.done}")
    n_prefill = len(times["prefill"])
    print(f"{tag}: {len(reqs)} requests answered in {len(waves)} wave(s); tokens per request "
          f"{[len(r.generated) for r in reqs]}; launches {counts}", flush=True)
    if counts["flash_fwd"] != cfg.num_layers * n_prefill or \
            any(n for k, n in counts.items() if k != "flash_fwd"):
        fail(f"{tag} launched {counts}, expected {cfg.num_layers} x {n_prefill} flash_fwd only")
    for agree, rms in agreement:
        print(f"{tag}: prefill (flash) vs cache fill (plain attention), each one routing call "
              f"of {slots * prompt} tokens a layer, over all {slots}x{prompt} positions: argmax "
              f"agreement {agree:.4f} (need > "
              f"{MOE_ARGMAX_AGREE}), rms diff / std {rms:.4f} (tol {MOE_PREFILL_RMS})",
              flush=True)
        if not (agree > MOE_ARGMAX_AGREE and rms <= MOE_PREFILL_RMS):
            fail(f"{tag}: prefill and fill agree on {agree:.4f} of argmaxes, rms diff / std "
                 f"{rms:.4f}")
    gen_tokens = sum(len(r.generated) for r in reqs)
    prefill_ms = 1e3 * sum(times["prefill"]) / n_prefill
    fill_ms = 1e3 * sum(times["fill"]) / len(times["fill"])
    step_ms = 1e3 * sum(times["decode"]) / len(times["decode"])
    print(f"{tag}: prefill {prefill_ms:.2f} ms per wave ({slots}x{prompt} tokens, "
          f"{slots * prompt / prefill_ms * 1e3:.0f} tokens/s), cache fill {fill_ms:.2f} ms, "
          f"decode {step_ms:.3f} ms/step ({slots} slots, capacity 1 a step), decode "
          f"{slots * 1e3 / step_ms:.1f} tokens/s, end to end {gen_tokens / wall:.1f} generated "
          f"tokens/s over {wall:.2f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)


@contextlib.contextmanager
def flash_windows(name: str = "flash_attention_fwd"):
    """Record the ``window`` of every call the models make through
    ``ops.<name>`` (``flash_attention_fwd`` when serving;
    ``flash_attention_fwd_lse`` and ``flash_attention_bwd`` when training),
    in call order (the kernels' counters count the launches; this tells a
    windowed launch from another)."""
    from repro_torch.kernels.flash_attention import ops

    seen, real = [], getattr(ops, name)

    def recording(*args, **kw):
        seen.append(kw.get("window"))
        return real(*args, **kw)

    setattr(ops, name, recording)
    try:
        yield seen
    finally:
        setattr(ops, name, real)


def _serve_family(smi: str, tag: str, arch: str, prompt: int, max_new: int, requests) -> dict:
    """Serve 8 requests in two waves of 4 slots with ``arch`` at full size in
    bf16 with flash attention, random weights from seed 0; ``requests(cfg,
    rng, n)`` gives the n requests (their prompts, positions3, enc_embeds).
    All answered, one flash_fwd per attention layer of the prefill's forward
    (whisper: encoder, decoder and cross-attention) and of the encode that
    fills whisper's enc_out, per wave, and no other kernel; the prefill
    against the one-call fill within SERVE_TOL.  Prints each wave's prefill,
    fill (and encode) and decode latency (the first wave pays the first
    calls' set-up: the second is the steady figure), tokens/s and peak
    memory; returns the launches and the windows the flash calls took."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import (
        BatchScheduler, ServeArtifacts, make_serve_step, serve_waves,
    )

    slots, n_req = 4, 8
    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, attn_impl="flash")
    zoo = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag}: {cfg.name} L={cfg.num_layers} enc_layers={cfg.enc_layers} "
          f"d_model={cfg.d_model} H={cfg.heads} Hk={cfg.kv_heads} Dh={cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} window={cfg.sliding_window} bf16, "
          f"{n_params / 1e9:.3f} B params ({torch.cuda.memory_allocated() / 2**30:.2f} GiB held), "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)

    arts = make_serve_step(zoo, device="cuda")
    want_launches = cfg.num_layers + (cfg.num_layers + 2 * cfg.enc_layers if zoo.has_encoder
                                      else 0)
    times = {"prefill": [], "encode": [], "fill": [], "decode": []}
    since_prefill = [0]

    def timed(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[kind(args) if callable(kind) else kind].append(time.perf_counter() - t)
            return out
        return call

    def decode_kind(args):
        since_prefill[0] += 1
        return "fill" if since_prefill[0] == 1 else "decode"

    def prefill(*args):
        since_prefill[0] = 0
        return arts.prefill_fn(*args)

    encode = arts.encode_fn and timed("encode", arts.encode_fn)
    served = ServeArtifacts(timed(decode_kind, arts.decode_fn), timed("prefill", prefill),
                            encode_fn=encode)
    sched = BatchScheduler(slots=slots, eos_id=0)
    reqs = requests(cfg, np.random.RandomState(0), n_req)
    for r in reqs:
        sched.submit(r)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with flash_windows() as windows:
        waves = serve_waves(zoo, served, params, sched, prompt + max_new, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for r in reqs:
        ok = len(r.generated) == r.max_new or (r.generated and r.generated[-1] == sched.eos_id)
        if not (r.done and ok):
            fail(f"{tag}: request {r.rid} unanswered: {len(r.generated)} tokens, done={r.done}")
    n_wave = len(waves)
    print(f"{tag}: {len(reqs)} requests answered in {n_wave} wave(s); tokens per request "
          f"{[len(r.generated) for r in reqs]}; launches {counts}", flush=True)
    if counts["flash_fwd"] != want_launches * n_wave or \
            any(n for k, n in counts.items() if k != "flash_fwd"):
        fail(f"{tag} launched {counts}, expected {want_launches} x {n_wave} flash_fwd only")
    print(f"{tag}: flash_fwd launches {counts['flash_fwd']} = {want_launches} per wave x "
          f"{n_wave} wave(s)", flush=True)
    for w in waves:
        _agreement(tag, "bf16 prefill (flash) vs one-call fill (plain attention)",
                   w.prefill_last, w.fill_last, SERVE_TOL)
    gen_tokens = sum(len(r.generated) for r in reqs)
    ms = {k: [round(1e3 * t, 2) for t in v] for k, v in times.items() if v and k != "decode"}
    ends = np.cumsum([0] + [w.decode_steps for w in waves]).tolist()
    step_ms = [1e3 * sum(times["decode"][a:b]) / (b - a) for a, b in zip(ends, ends[1:])]
    print(f"{tag}: per-wave ms: {ms}, decode ms/step {[round(t, 3) for t in step_ms]}",
          flush=True)
    last = {k: v[-1] for k, v in ms.items()}
    enc = f", encode {last['encode']:.2f} ms" if "encode" in last else ""
    print(f"{tag}: second wave: prefill {last['prefill']:.2f} ms ({slots}x{prompt} tokens, "
          f"{slots * prompt / last['prefill'] * 1e3:.0f} tokens/s){enc}, cache fill "
          f"{last['fill']:.2f} ms, decode {step_ms[-1]:.3f} ms/step ({slots} slots), decode "
          f"{slots * 1e3 / step_ms[-1]:.1f} tokens/s; end to end {gen_tokens / wall:.1f} "
          f"generated tokens/s over {wall:.2f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
    return {"flash_fwd": counts["flash_fwd"], "windows": windows}


def phase_serve_gemma3(smi: str) -> dict:
    """gemma3-4b at full size (34 layers, Dh 320, window 1024 on 29 local
    layers): 4 x 2048-token prompts, so the window binds on half the
    positions, 32 new tokens; 34 flash_fwd a prefill, 29 with the window."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.serve_step import Request

    prompt = 2048

    def requests(cfg, rng, n):
        return [Request(rid=i, prompt=rng.randint(2, cfg.vocab, prompt), max_new=32)
                for i in range(n)]

    cfg = get_config("gemma3-4b")
    flags = transformer._is_global_flags(cfg)
    out = _serve_family(smi, "serve_gemma3", "gemma3-4b", prompt, 32, requests)
    want = [None if g else cfg.sliding_window for g in flags]
    w = cfg.sliding_window
    n = len(out["windows"]) // len(flags)  # prefills
    print(f"serve_gemma3: flash_fwd windows per prefill: {out['windows'].count(w) // n} with "
          f"window {w}, {out['windows'].count(None) // n} without (want "
          f"{len(flags) - sum(flags)} and {sum(flags)}: global layers "
          f"{[i for i, g in enumerate(flags) if g]})", flush=True)
    if out["windows"] != want * n:
        fail(f"serve_gemma3: the flash calls took windows {out['windows']}, want {want}")
    return out


def phase_serve_vlm(smi: str) -> dict:
    """qwen2-vl-2b at full size: 4 prompts of 1024 positions given as
    embeddings from the seed (the vision frontend is a stub) at a 32 x 32
    patch grid's positions3 (0, row, col); the decoded tokens continue at 32
    + step in all three streams; 28 flash_fwd a prefill."""
    import torch

    from repro_torch.serve.serve_step import Request

    prompt, side = 1024, 32

    def requests(cfg, rng, n):
        pos3 = _grid_positions3(1, prompt, side)[0][:, 0].numpy()
        g = torch.Generator().manual_seed(0)
        return [Request(rid=i, prompt=torch.randn((prompt, cfg.d_model), generator=g).numpy(),
                        max_new=32, positions3=pos3) for i in range(n)]

    return _serve_family(smi, "serve_vlm", "qwen2-vl-2b", prompt, 32, requests)


def phase_serve_whisper(smi: str) -> dict:
    """whisper-large-v3 at full size: enc_embeds of 4 x 1500 frames from the
    seed, 4 x 224 decoder tokens (half of Whisper's 448-token context), 32
    new tokens.  A wave launches flash_fwd 32 (encoder) + 32 (decoder self)
    + 32 (cross) times in the prefill's forward and 32 more in the encode
    that fills the cache's enc_out: 128."""
    import torch

    from repro_torch.serve.serve_step import Request

    prompt = 224

    def requests(cfg, rng, n):
        g = torch.Generator().manual_seed(0)
        return [Request(rid=i, prompt=rng.randint(2, cfg.vocab, prompt), max_new=32,
                        enc_embeds=torch.randn((1500, cfg.d_model), generator=g).numpy())
                for i in range(n)]

    return _serve_family(smi, "serve_whisper", "whisper-large-v3", prompt, 32, requests)


TRAIN_STEPS = 8
TRAIN_B, TRAIN_S = 4, 1024
# the distributed step on a world of one against the one-process step: the
# same kernels on the same inputs; the reduce is a copy and a division by 1
DIST_REL_TOL = 1e-5
DIST_FLAT_STEPS = 3


def _train_setup():
    """llama3.2-3b at full width and depth in bf16 with remat and flash, its
    AdamW config and its data."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(
        get_config("llama3.2-3b"), param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        remat=True, attn_impl="flash",
    )
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    # tokens from a 4096-token bigram corpus: valid ids of the 128256 vocab,
    # where a full-vocab table would take 131 GB of host memory
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=TRAIN_S, global_batch=TRAIN_B))
    return cfg, get_model(cfg), ocfg, data


def _train_init(zoo, ocfg, layout=None):
    """Weights from seed 0 on the card (with ``layout``, this rank's blocks
    of them), and fresh AdamW state."""
    import torch

    from repro_torch.train import optimizer as opt_lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    if layout is not None:
        params = layout.shard(params)
    params.requires_grad_(True)
    return params, opt_lib.init(ocfg, params)


def _train_run(tag: str, step_fn, params, opt, data, steps: int) -> dict:
    """``steps`` steps through ``train_loop`` with the launch counts set to 0
    before and read after; per-step loss, grad_norm and ms, and the peak
    memory of the run."""
    import torch

    from repro_torch.train.trainer import train_loop

    from repro_torch.kernels.adamw import adamw

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    adamw.reset_launch_counts()
    res = train_loop(step_fn, params, opt, data.batches(0), num_steps=steps,
                     log_every=1, log_fn=lambda line: print(f"{tag}: {line}", flush=True))
    torch.cuda.synchronize()
    hist = res.history
    run = {"launches": launch_counts(), "adamw": adamw.launch_counts(),
           "peak": torch.cuda.max_memory_allocated(),
           "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
           "aux": [h["aux"] for h in hist], "step_ms": [1e3 * h["step_time_s"] for h in hist]}
    if len(hist) != steps or not all(math.isfinite(x) for x in run["loss"] + run["grad_norm"]):
        fail(f"{tag}: non-finite loss or grad_norm, or missing steps: {run['loss']} "
             f"{run['grad_norm']}")
    steady = run["step_ms"][1:]  # the first step pays one-time warm-up
    run["mean_ms"] = sum(steady) / len(steady)
    return run


def _train_launches(L: int, steps: int) -> dict:
    return {"flash_fwd": 0, "flash_fwd_lse": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps, "ssd_fwd": 0, "mlstm_fwd": 0}


def phase_train(smi: str) -> dict:
    """llama3.2-3b at full width and depth, 8 AdamW steps in one process;
    returns the run (launches, per-step loss, grad_norm and ms)."""
    import torch

    from repro_torch.kernels.adamw import adamw
    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    cfg, zoo, ocfg, data = _train_setup()
    params, opt = _train_init(zoo, ocfg)
    step_fn = make_train_step(zoo, ocfg, microbatches=1, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"train: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} vocab={cfg.vocab} bf16 "
          f"params, f32 moments, remat, flash; {n_params / 1e9:.3f} B params; batch {TRAIN_B} x "
          f"{TRAIN_S} tokens from a 4096-token bigram corpus; set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the step's arguments as the dry run counts them (phase dryrun_check)
    arg_bytes = _nbytes(*params.parameters(), *opt.mu.values(), *opt.nu.values())
    run = _train_run("train", step_fn, params, opt, data, TRAIN_STEPS)
    run["arg_bytes"] = arg_bytes
    losses = run["loss"]
    drop = losses[0] - losses[-1]
    print(f"train: loss {losses[0]:.4f} -> {losses[-1]:.4f}, drop {drop:.4f} nats (need >= 0.5)",
          flush=True)
    if not drop >= 0.5:
        fail(f"the loss fell by {drop} nats in {TRAIN_STEPS} steps, expected >= 0.5")
    want = _train_launches(cfg.num_layers, TRAIN_STEPS)
    launches = run["launches"]
    print(f"train: launches {launches}; expected {want} (remat: the forward runs twice a step)",
          flush=True)
    if launches != want:
        fail(f"train launches {launches} differ from {want}")
    want = dict.fromkeys(adamw.KERNELS, TRAIN_STEPS)
    print(f"train: AdamW's launches {run['adamw']}; expected {want} (3 a step)", flush=True)
    if run["adamw"] != want:
        fail(f"train AdamW launches {run['adamw']} differ from {want}")

    mean_ms = run["mean_ms"]
    tokens = TRAIN_B * TRAIN_S
    mfu = 6.0 * n_params * tokens / (mean_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    print(f"train: per-step ms {[round(t, 2) for t in run['step_ms']]}", flush=True)
    print(f"train: steady step {mean_ms:.2f} ms (mean of steps 1-{TRAIN_STEPS - 1}), "
          f"{tokens / (mean_ms / 1e3):.1f} tokens/s, MFU {mfu:.2%} (6 N tokens / step time / "
          f"989 TFLOP/s), max_memory_allocated {run['peak'] / 2**30:.2f} GiB [{smi}]", flush=True)
    return run


# the dry run's reckoned peak against the measured one
DRYRUN_PEAK_REL = 0.15


def phase_dryrun_check(smi: str, train: dict) -> None:
    """The dry run of the train phase's own cell (``launch/roofline.py``:
    the same step traced on the meta device): its argument bytes must equal
    the parameters plus moments the phase held, and its peak (arguments +
    what the traced step allocates at its peak) be within DRYRUN_PEAK_REL
    of the phase's ``max_memory_allocated``; its compute term beside the
    measured step time."""
    import torch

    from repro_torch.launch import roofline
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    cfg, zoo, ocfg, data = _train_setup()
    meta = torch.device("meta")
    params = zoo.init(0, device=meta)
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    batch = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=torch.int64, device=meta)
             for k in ("tokens", "targets")}
    step_fn = make_train_step(zoo, ocfg, microbatches=1, device=meta)
    args = [*params.parameters(), *opt.mu.values(), *opt.nu.values(), *batch.values()]
    _, stats = roofline.trace(step_fn, params, opt, batch, external=args)
    arg_bytes = _nbytes(*params.parameters(), *opt.mu.values(), *opt.nu.values())
    peak = arg_bytes + _nbytes(*batch.values()) + stats.peak_bytes
    H, Dh, L = cfg.heads, cfg.resolved_head_dim, cfg.num_layers
    # the flash kernels' FLOPs, opaque to the count: forward, remat, backward
    flash = 4 * (2 * 2 * TRAIN_B * H * TRAIN_S * TRAIN_S * Dh * 0.5 * L)
    n = sum(p.numel() for p in params.parameters())
    report = roofline.build_report(cfg.name, "train_4x1024", "one card", 1, stats,
                                   {"argument_bytes": arg_bytes, "peak_bytes": peak},
                                   roofline.model_train_flops(n, TRAIN_B * TRAIN_S),
                                   default_trip=L, extra_flops_global=flash)
    rel = abs(peak - train["peak"]) / train["peak"]
    print(f"dryrun_check: {cfg.name} train cell ({TRAIN_B} x {TRAIN_S} tokens, bf16, remat, "
          f"flash) traced on the meta device in {time.perf_counter() - t0:.1f} s, {stats.ops} "
          f"ops: argument bytes {arg_bytes} against the train phase's parameters + moments "
          f"{train['arg_bytes']}; reckoned peak {peak / 2**30:.3f} GiB against "
          f"max_memory_allocated {train['peak'] / 2**30:.3f} GiB: rel {rel:.3f} (tol "
          f"{DRYRUN_PEAK_REL:g}); roofline terms compute {report.compute_s * 1e3:.2f} ms "
          f"({report.hlo_flops_per_dev / 1e12:.2f} TFLOP at 989 TFLOP/s), memory "
          f"{report.memory_s * 1e3:.2f} ms ({report.hbm_bytes_per_dev / 1e9:.2f} GB at 3.35 "
          f"TB/s), dominant {report.dominant}, against the measured steady step "
          f"{train['mean_ms']:.2f} ms [{smi}]", flush=True)
    if arg_bytes != train["arg_bytes"]:
        fail(f"dryrun_check: argument bytes {arg_bytes} != the phase's {train['arg_bytes']}")
    if not rel <= DRYRUN_PEAK_REL:
        fail(f"dryrun_check: reckoned peak {peak} is {rel:.3f} off the measured {train['peak']}")


def _largest_gap(got: list, want: list) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


@contextlib.contextmanager
def _world_of_one(shape=(1, 1, 1), axes=("pod", "data", "model")):
    """A mesh of one rank through NCCL, (1, 1, 1) ("pod", "data", "model")
    unless ``shape`` / ``axes`` say otherwise; a new process group each
    time, destroyed on exit."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(shape, axes, device="cuda")
        print(f"world of one: backend {dist.get_backend()}, world {dist.get_world_size()}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {torch.cuda.get_device_name(0)}",
              flush=True)
        if dist.get_backend() != "nccl":
            fail(f"the world of one runs on {dist.get_backend()}, not NCCL")
        yield mesh
    finally:
        dist.destroy_process_group()


def _check_gaps(tag: str, gaps: dict) -> None:
    for what, gap in gaps.items():
        if not gap <= DIST_REL_TOL:
            fail(f"{tag}: {what} differs by {gap:.3e} relative (tol {DIST_REL_TOL:g})")


def phase_train_dist(smi: str, train: dict, mesh) -> None:
    """The ``manual_hier`` step on the world of one: the same model, seed,
    data and kernels as ``phase_train``, whose losses, grad_norms and
    launches it must match."""
    import torch

    from repro_torch.collectives import byte_ledger
    from repro_torch.train.train_step import make_train_step

    cfg, zoo, ocfg, data = _train_setup()
    runs = {}
    for schedule, steps in (("hierarchical", TRAIN_STEPS), ("flat", DIST_FLAT_STEPS)):
        params, opt = _train_init(zoo, ocfg)
        step_fn = make_train_step(zoo, ocfg, microbatches=1, device="cuda", mesh=mesh,
                                  dp_mode="manual_hier", schedule=schedule)
        with byte_ledger() as ledger:
            run = _train_run(f"train_dist {schedule}", step_fn, params, opt, data, steps)
        del params, opt, step_fn
        torch.cuda.empty_cache()
        run["ledger"] = ledger
        runs[schedule] = run
        want = _train_launches(cfg.num_layers, steps)
        if run["launches"] != want:
            fail(f"train_dist {schedule}: launches {run['launches']} differ from {want}")
    hier, flat = runs["hierarchical"], runs["flat"]
    gaps = {"loss": _largest_gap(hier["loss"], train["loss"]),
            "grad_norm": _largest_gap(hier["grad_norm"], train["grad_norm"]),
            "flat loss": _largest_gap(flat["loss"], hier["loss"][:DIST_FLAT_STEPS])}
    print(f"train_dist: largest relative gap to phase train: loss {gaps['loss']:.3e}, "
          f"grad_norm {gaps['grad_norm']:.3e}; flat's loss to hierarchical's "
          f"{gaps['flat loss']:.3e} (tol {DIST_REL_TOL:g})", flush=True)
    _check_gaps("train_dist", gaps)
    print(f"train_dist: launches {hier['launches']} in {TRAIN_STEPS} hierarchical steps, "
          f"the same as phase train's", flush=True)
    try:
        make_train_step(zoo, ocfg, device="cuda", mesh=mesh, dp_mode="manual_hier",
                        schedule="compressed")
    except ValueError as e:
        print(f"train_dist: compressed refused on this mesh (a world of one has no 'pod' "
              f"axis of size > 1; its int8 path is held against JAX on the CPU gloo "
              f"worlds): {e}", flush=True)
    else:
        fail("train_dist: the compressed schedule ran on a mesh whose pod axis is 1")
    for schedule, run in runs.items():
        steps = len(run["loss"])
        ar = run["ledger"].bytes("all_reduce") // steps
        moved = run["ledger"].bytes() // steps
        print(f"train_dist: {schedule}: per-step ms {[round(t, 2) for t in run['step_ms']]}; "
              f"steady step {run['mean_ms']:.2f} ms (mean of steps 1-{steps - 1}) against "
              f"phase train's {train['mean_ms']:.2f} ms: overhead "
              f"{run['mean_ms'] - train['mean_ms']:+.2f} ms a step for the flatten, pad, "
              f"collectives and unpad; collective results {moved / 1e9:.3f} GB a step "
              f"({ar / 1e9:.3f} GB all-reduce); max_memory_allocated "
              f"{run['peak'] / 2**30:.2f} GiB (train {train['peak'] / 2**30:.2f}) [{smi}]",
              flush=True)


def phase_train_fsdp(smi: str, train: dict, mesh) -> None:
    """The ``gspmd_fsdp`` step (the default with a mesh) on the world of
    one: params and moments as the rank's blocks of ``param_layout``; the
    same model, seed, data and kernels as ``phase_train``, whose losses,
    grad_norms and launches it must match."""
    import torch

    from repro_torch.collectives import byte_ledger
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train.train_step import make_train_step

    cfg, zoo, ocfg, data = _train_setup()
    layout = param_layout(zoo, mesh)
    params, opt = _train_init(zoo, ocfg, layout)
    step_fn = make_train_step(zoo, ocfg, microbatches=1, device="cuda", mesh=mesh)
    with byte_ledger() as ledger:
        run = _train_run("train_fsdp", step_fn, params, opt, data, TRAIN_STEPS)
    del params, opt, step_fn
    torch.cuda.empty_cache()
    want = _train_launches(cfg.num_layers, TRAIN_STEPS)
    if run["launches"] != want:
        fail(f"train_fsdp: launches {run['launches']} differ from {want}")
    gaps = {"loss": _largest_gap(run["loss"], train["loss"]),
            "grad_norm": _largest_gap(run["grad_norm"], train["grad_norm"])}
    print(f"train_fsdp: largest relative gap to phase train: loss {gaps['loss']:.3e}, grad_norm "
          f"{gaps['grad_norm']:.3e} (tol {DIST_REL_TOL:g}); launches {run['launches']}, the "
          f"same as phase train's", flush=True)
    _check_gaps("train_fsdp", gaps)
    print(f"train_fsdp: per-step ms {[round(t, 2) for t in run['step_ms']]}; steady step "
          f"{run['mean_ms']:.2f} ms (mean of steps 1-{TRAIN_STEPS - 1}) against phase train's "
          f"{train['mean_ms']:.2f} ms: {run['mean_ms'] - train['mean_ms']:+.2f} ms a step; "
          f"collective results {ledger.bytes() / TRAIN_STEPS / 1e9:.3f} GB a step (a world of "
          f"one issues none); max_memory_allocated {run['peak'] / 2**30:.2f} GiB (train "
          f"{train['peak'] / 2**30:.2f}) [{smi}]", flush=True)


# moonshot-v1-16b-a3b trains at full width with its depth cut: 48 layers
# need ~337 GB (bf16 params and grads, f32 moments); 4 take ~35 GB
MOE_TRAIN_LAYERS = 4


def _train_moe_setup():
    """moonshot-v1-16b-a3b at full width, 4 layers, in bf16 with remat and
    flash; the train phase's AdamW config and data."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(
        get_config("moonshot-v1-16b-a3b"), num_layers=MOE_TRAIN_LAYERS,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, remat=True, attn_impl="flash",
    )
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=TRAIN_S, global_batch=TRAIN_B))
    return cfg, get_model(cfg), ocfg, data


def phase_train_moe(smi: str) -> dict:
    """8 AdamW steps of moonshot-v1-16b-a3b (4 layers) in one process: the
    loss must fall, aux be > 0 every step, and the launches be 2L
    flash_fwd_lse, L flash_bwd_dq and L flash_bwd_dkv a step."""
    import torch

    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    cfg, zoo, ocfg, data = _train_moe_setup()
    params, opt = _train_init(zoo, ocfg)
    step_fn = make_train_step(zoo, ocfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"train_moe: {cfg.name} L={cfg.num_layers} (cut from 48) d_model={cfg.d_model} "
          f"experts={cfg.moe.num_experts} top-{cfg.moe.top_k} vocab={cfg.vocab} bf16 params, f32 "
          f"moments, remat, flash; {n_params / 1e9:.3f} B params "
          f"({cfg.active_param_count() / 1e9:.3f} B active); batch {TRAIN_B} x {TRAIN_S} tokens "
          f"from a 4096-token bigram corpus; set-up {time.perf_counter() - t0:.2f} s", flush=True)
    run = _train_run("train_moe", step_fn, params, opt, data, TRAIN_STEPS)
    del params, opt, step_fn
    torch.cuda.empty_cache()
    losses, aux = run["loss"], run["aux"]
    print(f"train_moe: loss {losses[0]:.4f} -> {losses[-1]:.4f}; aux per step "
          f"{[round(a, 5) for a in aux]}", flush=True)
    if not (losses[-1] < losses[0] and min(aux) > 0):
        fail(f"train_moe: the loss did not fall or an aux was not > 0: {losses} {aux}")
    want = _train_launches(cfg.num_layers, TRAIN_STEPS)
    print(f"train_moe: launches {run['launches']}; expected {want}", flush=True)
    if run["launches"] != want:
        fail(f"train_moe launches {run['launches']} differ from {want}")
    tokens = TRAIN_B * TRAIN_S
    mfu = 6.0 * cfg.active_param_count() * tokens / (run["mean_ms"] / 1e3) / PEAK_FLOPS["bfloat16"]
    print(f"train_moe: per-step ms {[round(t, 2) for t in run['step_ms']]}; steady step "
          f"{run['mean_ms']:.2f} ms, {tokens / (run['mean_ms'] / 1e3):.1f} tokens/s, MFU {mfu:.2%} "
          f"(6 N_active tokens / step time / 989 TFLOP/s), max_memory_allocated "
          f"{run['peak'] / 2**30:.2f} GiB [{smi}]", flush=True)
    return run


def phase_train_moe_fsdp(smi: str, train_moe: dict, mesh) -> None:
    """The same MoE steps through ``gspmd_fsdp`` on the world of one: the
    expert-parallel layers (all-to-all over a "data" axis of one), whose
    losses, aux and grad_norms must equal ``phase_train_moe``'s within rel
    1e-5, with its launches."""
    import torch

    from repro_torch.collectives import byte_ledger
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train.train_step import make_train_step

    cfg, zoo, ocfg, data = _train_moe_setup()
    layout = param_layout(zoo, mesh)
    params, opt = _train_init(zoo, ocfg, layout)
    step_fn = make_train_step(zoo, ocfg, device="cuda", mesh=mesh)
    if zoo.shard_plan(layout).ep is None:
        fail("train_moe_fsdp: the MoE layers do not run expert-parallel under the mesh")
    with byte_ledger() as ledger:
        run = _train_run("train_moe_fsdp", step_fn, params, opt, data, TRAIN_STEPS)
    del params, opt, step_fn
    torch.cuda.empty_cache()
    want = _train_launches(cfg.num_layers, TRAIN_STEPS)
    if run["launches"] != want:
        fail(f"train_moe_fsdp: launches {run['launches']} differ from {want}")
    gaps = {k: _largest_gap(run[k], train_moe[k]) for k in ("loss", "aux", "grad_norm")}
    print(f"train_moe_fsdp: largest relative gap to train_moe: loss {gaps['loss']:.3e}, aux "
          f"{gaps['aux']:.3e}, grad_norm {gaps['grad_norm']:.3e} (tol {DIST_REL_TOL:g}); "
          f"launches {run['launches']}, the same", flush=True)
    _check_gaps("train_moe_fsdp", gaps)
    print(f"train_moe_fsdp: steady step {run['mean_ms']:.2f} ms against train_moe's "
          f"{train_moe['mean_ms']:.2f}; collective results {ledger.bytes() / TRAIN_STEPS / 1e9:.3f} "
          f"GB a step (a world of one issues none); max_memory_allocated "
          f"{run['peak'] / 2**30:.2f} GiB (train_moe {train_moe['peak'] / 2**30:.2f}) [{smi}]",
          flush=True)


# gemma3-4b, qwen2-vl-2b and whisper-large-v3 trained at full width and
# depth: arch -> (global batch, positions a row, microbatches).  gemma3-4b
# 2 x 2048 tokens, so that the local layers' window of 1024 binds on half
# the positions (4 x 2048 would not fit 80 GB beside the 262144-wide logits
# and their f32 gradient); qwen2-vl-2b 4 x 1024 at a 32 x 32 patch grid's
# positions3 in 2 microbatches (positions3 cut on its dim 1);
# whisper-large-v3 4 x 448 decoder tokens (Whisper's context) over 1500
# encoder frames
FAMILY_TRAIN = {"gemma3-4b": (2, 2048, 1), "qwen2-vl-2b": (4, 1024, 2),
                "whisper-large-v3": (4, 448, 1)}
WHISPER_FRAMES = 1500


class FamilyBatches:
    """The 4096-token bigram corpus's batches with a family's other inputs:
    vlm the positions3 of a 32 x 32 patch grid, whisper enc_embeds drawn on
    the card from a generator seeded with the first step."""

    def __init__(self, cfg, B: int, S: int):
        from repro_torch.data.pipeline import DataConfig, SyntheticLM

        self.cfg, self.B, self.S = cfg, B, S
        self.data = SyntheticLM(DataConfig(vocab=4096, seq_len=S, global_batch=B))

    def batches(self, start: int = 0):
        import torch

        gen = torch.Generator(device="cuda")
        gen.manual_seed(start)
        for batch in self.data.batches(start):
            if self.cfg.family == "vlm":
                batch["positions3"] = _grid_positions3(self.B, self.S, 32)[0]
            if self.cfg.family == "whisper":
                batch["enc_embeds"] = torch.randn((self.B, WHISPER_FRAMES, self.cfg.d_model),
                                                  generator=gen, device="cuda")
            yield batch


def family_train_setup(arch: str):
    """``arch`` at full size in bf16 with remat and flash, the train phase's
    AdamW config, its batches and its microbatch count."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, remat=True, attn_impl="flash")
    B, S, micro = FAMILY_TRAIN[arch]
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    return cfg, get_model(cfg), ocfg, FamilyBatches(cfg, B, S), micro


def _phase_train_family(smi: str, tag: str, arch: str) -> dict:
    """8 AdamW steps of ``arch`` at full size through ``train_loop``: the
    loss must fall by 0.5 nats, every loss and grad_norm be finite, and the
    launches be 2 flash_fwd_lse and one each of flash_bwd_dq and
    flash_bwd_dkv an attention a microbatch; prints peak memory, steady step
    time, tokens/s and MFU.  Returns the run with the windows of the
    training flash calls (forward, backward)."""
    import torch

    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    cfg, zoo, ocfg, data, micro = family_train_setup(arch)
    params, opt = _train_init(zoo, ocfg)
    step_fn = make_train_step(zoo, ocfg, microbatches=micro, device="cuda")
    torch.cuda.synchronize()
    named = dict(params.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    n_enc = sum(p.numel() for k, p in named.items() if k.startswith("enc_"))
    B, S = data.B, data.S
    print(f"{tag}: {cfg.name} L={cfg.num_layers} enc_layers={cfg.enc_layers} d_model={cfg.d_model} "
          f"H={cfg.heads} Hk={cfg.kv_heads} Dh={cfg.resolved_head_dim} vocab={cfg.vocab} "
          f"window={cfg.sliding_window} bf16 params, f32 moments, remat, flash; "
          f"{n_params / 1e9:.3f} B params; batch {B} x {S} tokens from a 4096-token bigram "
          f"corpus in {micro} microbatch(es)"
          f"{f', {WHISPER_FRAMES} encoder frames a row' if n_enc else ''}; set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with flash_windows("flash_attention_fwd_lse") as fwd_w, \
            flash_windows("flash_attention_bwd") as bwd_w:
        run = _train_run(tag, step_fn, params, opt, data, TRAIN_STEPS)
    del params, opt, step_fn, named
    torch.cuda.empty_cache()
    losses = run["loss"]
    drop = losses[0] - losses[-1]
    print(f"{tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, drop {drop:.4f} nats (need >= 0.5)",
          flush=True)
    if not drop >= 0.5:
        fail(f"{tag}: the loss fell by {drop} nats in {TRAIN_STEPS} steps, expected >= 0.5")
    want = _train_launches(n_attentions(cfg) * micro, TRAIN_STEPS)
    print(f"{tag}: launches {run['launches']}; expected {want} ({n_attentions(cfg)} attentions "
          f"a forward, {micro} microbatch(es) a step, remat)", flush=True)
    if run["launches"] != want:
        fail(f"{tag} launches {run['launches']} differ from {want}")
    # 6 N tokens, whisper's encoder parameters at its frames
    flop = 6.0 * B * ((n_params - n_enc) * S + n_enc * WHISPER_FRAMES)
    mean_s = run["mean_ms"] / 1e3
    print(f"{tag}: per-step ms {[round(t, 2) for t in run['step_ms']]}", flush=True)
    print(f"{tag}: steady step {run['mean_ms']:.2f} ms (mean of steps 1-{TRAIN_STEPS - 1}), "
          f"{B * S / mean_s:.1f} tokens/s, MFU {flop / mean_s / PEAK_FLOPS['bfloat16']:.2%} "
          f"(6 N tokens{' (encoder N x frames)' if n_enc else ''} / step time / 989 TFLOP/s), "
          f"max_memory_allocated {run['peak'] / 2**30:.2f} GiB [{smi}]", flush=True)
    run["windows"], run["cfg"] = (fwd_w, bwd_w), cfg
    return run


def phase_train_gemma3(smi: str) -> dict:
    """gemma3-4b at full size (34 layers, Dh 320): 2 x 2048 tokens a step;
    68 flash_fwd_lse, 34 flash_bwd_dq and 34 flash_bwd_dkv a step, the
    local layers' 29 of each 34 with the window of 1024."""
    from repro_torch.models import transformer

    run = _phase_train_family(smi, "train_gemma3", "gemma3-4b")
    cfg = run["cfg"]
    flags = transformer._is_global_flags(cfg)
    w, n_local, n_global = cfg.sliding_window, flags.count(False), flags.count(True)
    for what, seen, per in (("forward", run["windows"][0], 2), ("backward", run["windows"][1], 1)):
        got = (seen.count(w), seen.count(None))
        want = (per * n_local * TRAIN_STEPS, per * n_global * TRAIN_STEPS)
        print(f"train_gemma3: {what} flash calls in {TRAIN_STEPS} steps: {got[0]} with window {w}, "
              f"{got[1]} without (want {want[0]} and {want[1]})", flush=True)
        if got != want or len(seen) != sum(want):
            fail(f"train_gemma3: the {what} flash calls took windows {got}, want {want}")
    return run


def phase_train_vlm(smi: str) -> dict:
    """qwen2-vl-2b at full size: 4 x 1024 tokens at a 32 x 32 patch grid's
    positions3, 2 microbatches a step; 2 x (56, 28, 28) launches a step."""
    return _phase_train_family(smi, "train_vlm", "qwen2-vl-2b")


def phase_train_whisper(smi: str) -> dict:
    """whisper-large-v3 at full size: 4 x 1500 encoder frames and 4 x 448
    decoder tokens a step; 192 flash_fwd_lse, 96 flash_bwd_dq and 96
    flash_bwd_dkv a step (32 encoder, 32 self and 32 cross attentions, each
    run twice under remat)."""
    return _phase_train_family(smi, "train_whisper", "whisper-large-v3")


# the recurrent families' training cells: (batch, tokens, layers or None for
# all).  zamba2-7b at full width cut to 12 layers (the shared block runs
# twice), as serve_hybrid's prompts are cut to 256 tokens; xlstm-125m whole
# at 256 tokens (at 512 a step took 9.5 s).  Both scans' backwards replay
# the sequential scan in a Python loop over tokens, so the steps are
# host-bound
RECURRENT_TRAIN = {"zamba2-7b": (4, 256, 12), "xlstm-125m": (4, 256, None)}
# the loss drop the cell must show in 8 steps; xlstm-125m's loss does not
# fall over 8 batches of the bigram corpus at lr 1e-3 (in bf16 or f32, at
# batch 4 or 16) while it fits one batch repeated (11.24 -> 6.85 in 8
# steps, f32 on the CPU), so its drop is reported, not held
RECURRENT_MIN_DROP = {"zamba2-7b": 0.5, "xlstm-125m": None}


def recurrent_train_setup(arch: str):
    """``arch`` in bf16 with remat at its ``RECURRENT_TRAIN`` cut, the train
    phase's AdamW config and its batches (the 4096-token bigram corpus)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    B, S, layers = RECURRENT_TRAIN[arch]
    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, remat=True)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=4096, seq_len=S, global_batch=B))
    return cfg, get_model(cfg), ocfg, data


def _phase_train_recurrent(smi: str, tag: str, arch: str) -> dict:
    """8 AdamW steps of ``arch`` (``RECURRENT_TRAIN``) through
    ``train_loop``: the loss must fall by ``RECURRENT_MIN_DROP``, every loss
    and grad_norm be finite, and the launches be ``scan_launches`` a step
    and nothing else; prints the steady step time, tokens/s, MFU on the
    leaves' count and peak memory."""
    import torch

    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    cfg, zoo, ocfg, data = recurrent_train_setup(arch)
    params, opt = _train_init(zoo, ocfg)
    step_fn = make_train_step(zoo, ocfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    B, S, _ = RECURRENT_TRAIN[arch]
    print(f"{tag}: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} H={cfg.heads} "
          f"vocab={cfg.vocab} bf16 params, f32 moments, remat; {n_params / 1e9:.3f} B params "
          f"(the leaves); batch {B} x {S} tokens from a 4096-token bigram corpus; set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    run = _train_run(tag, step_fn, params, opt, data, TRAIN_STEPS)
    del params, opt, step_fn
    torch.cuda.empty_cache()
    losses = run["loss"]
    drop, need = losses[0] - losses[-1], RECURRENT_MIN_DROP[arch]
    print(f"{tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, drop {drop:.4f} nats "
          f"({f'need >= {need}' if need is not None else 'reported, not held'})", flush=True)
    if need is not None and not drop >= need:
        fail(f"{tag}: the loss fell by {drop} nats in {TRAIN_STEPS} steps, expected >= {need}")
    want = {**_train_launches(0, TRAIN_STEPS),
            **{k: v * TRAIN_STEPS for k, v in scan_launches(cfg, True).items()}}
    print(f"{tag}: launches {run['launches']}; expected {want} (remat)", flush=True)
    if run["launches"] != want:
        fail(f"{tag} launches {run['launches']} differ from {want}")
    mean_s = run["mean_ms"] / 1e3
    mfu = 6.0 * n_params * B * S / mean_s / PEAK_FLOPS["bfloat16"]
    print(f"{tag}: per-step ms {[round(t, 2) for t in run['step_ms']]}", flush=True)
    print(f"{tag}: steady step {run['mean_ms']:.2f} ms (mean of steps 1-{TRAIN_STEPS - 1}), "
          f"{B * S / mean_s:.1f} tokens/s, MFU {mfu:.2%} (6 N tokens, N the leaves' "
          f"{n_params}, / step time / 989 TFLOP/s), max_memory_allocated "
          f"{run['peak'] / 2**30:.2f} GiB [{smi}]", flush=True)
    return run


def phase_train_hybrid(smi: str) -> dict:
    """zamba2-7b at full width, 12 layers: 4 x 256 tokens a step; 24 ssd_fwd
    a step (each Mamba2 layer twice under remat)."""
    return _phase_train_recurrent(smi, "train_hybrid", "zamba2-7b")


def phase_train_xlstm(smi: str) -> dict:
    """xlstm-125m whole: 4 x 256 tokens a step; 18 mlstm_fwd a step (9
    mLSTM layers, twice under remat)."""
    return _phase_train_recurrent(smi, "train_xlstm", "xlstm-125m")


# the sharded step of the four families on the world of one: its first
# steps against the one-process phase's
FSDP_FAMILY_STEPS = 3


def phase_train_fsdp_families(smi: str, runs: dict, mesh) -> None:
    """``gspmd_fsdp`` on the world of one for zamba2-7b (12 layers),
    xlstm-125m, whisper-large-v3 and qwen2-vl-2b with the one-process
    phases' configs, seeds and data: each rank's blocks are whole leaves,
    and the hybrid's and xLSTM's sharded forms (``plan``) run.  Their
    losses and grad_norms must equal the one-process phase's first steps
    within rel 1e-5, and their launches those steps'."""
    import torch

    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train.train_step import make_train_step

    for arch, run in runs.items():
        if arch in RECURRENT_TRAIN:
            cfg, zoo, ocfg, data = recurrent_train_setup(arch)
            micro = 1
        else:
            cfg, zoo, ocfg, data, micro = family_train_setup(arch)
        layout = param_layout(zoo, mesh)
        params, opt = _train_init(zoo, ocfg, layout)
        step_fn = make_train_step(zoo, ocfg, microbatches=micro, device="cuda", mesh=mesh)
        got = _train_run(f"train_fsdp_families {arch}", step_fn, params, opt, data,
                         FSDP_FAMILY_STEPS)
        del params, opt, step_fn
        torch.cuda.empty_cache()
        n = FSDP_FAMILY_STEPS
        want = {k: v * n // TRAIN_STEPS for k, v in run["launches"].items()}
        gaps = {"loss": _largest_gap(got["loss"], run["loss"][:n]),
                "grad_norm": _largest_gap(got["grad_norm"], run["grad_norm"][:n])}
        print(f"train_fsdp_families {arch}: largest relative gap to its one-process phase's "
              f"first {n} steps: loss {gaps['loss']:.3e}, grad_norm {gaps['grad_norm']:.3e} "
              f"(tol {DIST_REL_TOL:g}); launches {got['launches']} (want {want}); step ms "
              f"{[round(t, 2) for t in got['step_ms']]} against {[round(t, 2) for t in run['step_ms'][:n]]}; "
              f"max_memory_allocated {got['peak'] / 2**30:.2f} GiB [{smi}]", flush=True)
        _check_gaps(f"train_fsdp_families {arch}", gaps)
        if got["launches"] != want:
            fail(f"train_fsdp_families {arch}: launches {got['launches']} differ from {want}")


# sharded serving on the world of one: prompts of SHARDED_PROMPT tokens, then
# SHARDED_DECODE one-token calls from a fresh cache
SHARDED_SLOTS, SHARDED_PROMPT, SHARDED_DECODE = 4, 256, 4


def _serve_setup(arch: str):
    """``arch`` at full width in bf16 (zamba2-7b cut to train_hybrid's 12
    layers), its weights from seed 0 on the card and one prompt batch."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model

    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, attn_impl="flash")
    if arch in RECURRENT_TRAIN and RECURRENT_TRAIN[arch][2] is not None:
        cfg = dataclasses.replace(cfg, num_layers=RECURRENT_TRAIN[arch][2])
    zoo = get_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = zoo.init(gen, device="cuda")
    B, P = SHARDED_SLOTS, SHARDED_PROMPT
    batch = {"tokens": torch.randint(0, min(4096, cfg.vocab), (B, P), generator=gen,
                                     device="cuda")}
    if cfg.family == "vlm":
        batch["positions3"] = _grid_positions3(B, P, 16)[0].cuda()
    if cfg.family == "whisper":
        batch["enc_embeds"] = torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=gen,
                                          device="cuda", dtype=torch.bfloat16)
    return cfg, zoo, params, batch


def phase_serve_sharded_families(smi: str, mesh) -> None:
    """``make_serve_step(mesh=)`` on a world of one ((1, 1) ("data",
    "model")) for zamba2-7b (12 layers), xlstm-125m, whisper-large-v3 and
    qwen2-vl-2b at full width in bf16: the prefill of 4 x 256 tokens and 4
    one-token decode calls from a fresh cache, each held against the
    unsharded serve of the same params (rel 1e-5 of the logits' largest
    element); the prefill's launches must be the unsharded one's."""
    import numpy as np
    import torch

    from repro_torch.serve.serve_step import make_serve_step

    for arch in ("zamba2-7b", "xlstm-125m", "whisper-large-v3", "qwen2-vl-2b"):
        _, zoo, params, batch = _serve_setup(arch)
        B = SHARDED_SLOTS
        cache_len = SHARDED_DECODE + 1
        whole = make_serve_step(zoo, "cuda")
        sharded = make_serve_step(
            zoo, "cuda", mesh=mesh, batch_example={"tokens": np.zeros((B, 1), np.int64)},
            cache_example=zoo.init_cache(B, cache_len, device="cuda"))
        local = sharded.param_layout.shard(params)
        logits, launches = {}, {}
        for name, arts, p in (("whole", whole, params), ("sharded", sharded, local)):
            reset_launch_counts()
            t0 = time.perf_counter()
            pre = arts.prefill_fn(p, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches[name] = launch_counts()
            cache = zoo.init_cache(B, cache_len, device="cuda")
            if arts.cache_layout is not None:
                cache = arts.cache_layout.shard(cache)
            if zoo.has_encoder:
                cache["enc_out"] = arts.encode_fn(p, batch["enc_embeds"])
            steps = []
            for t in range(SHARDED_DECODE):
                step = {"tokens": batch["tokens"][:, t:t + 1]}
                if "positions3" in batch:
                    step["positions3"] = batch["positions3"][:, :, t:t + 1]
                out, cache = arts.decode_fn(p, cache, step)
                steps.append(out.float())
            logits[name] = [pre.float(), *steps]
            print(f"serve_sharded_families {arch} {name}: prefill {tuple(pre.shape)} in "
                  f"{ms:.1f} ms (first call) launching {launches[name]}", flush=True)
        errs = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-6)
                for a, b in zip(logits["sharded"], logits["whole"])]
        print(f"serve_sharded_families {arch}: sharded vs unsharded, relative to the largest "
              f"logit: prefill {errs[0]:.3e}, decode calls {[f'{e:.3e}' for e in errs[1:]]} "
              f"(tol {DIST_REL_TOL:g}) [{smi}]", flush=True)
        if not all(bool(torch.isfinite(x).all()) for x in logits["sharded"]) or \
                max(errs) > DIST_REL_TOL:
            fail(f"serve_sharded_families {arch}: the sharded serve disagrees: {errs}")
        if launches["sharded"] != launches["whole"] or not any(launches["whole"].values()):
            fail(f"serve_sharded_families {arch}: prefill launches {launches}")
        del params, local, cache, logits
        torch.cuda.empty_cache()


PIPE_MICRO = 4


def phase_pipeline(smi: str, mesh) -> None:
    """``parallel.pipeline.make_pipelined_apply`` with one stage (a world of
    one, (1,) "pipe": the ring's hop is a local copy): a llama3.2-3b
    decoder layer at full width in bf16 (flash) over 4 microbatches of
    1 x 1024 tokens, against the layer applied to each microbatch
    unpipelined (the same bits)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import DTypes, layer_slice
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.pipeline import make_pipelined_apply

    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=1, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, attn_impl="flash")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    layers = get_model(cfg).init(gen, device="cuda")["layers"]
    S, dt = 1024, DTypes(param=cfg.param_dtype, compute=cfg.compute_dtype)
    positions = torch.arange(S, device="cuda")[None]

    def stage(lp, x):
        return transformer._layer_fwd(lp, cfg, x, positions, None, True, dt)[0]

    xs = torch.randn((PIPE_MICRO, 1, S, cfg.d_model), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    apply = make_pipelined_apply(mesh, stage, PIPE_MICRO)
    with torch.inference_mode():
        reset_launch_counts()
        got = apply(layers, xs)
        counts = launch_counts()
        want = torch.stack([stage(layer_slice(layers, 0), x) for x in xs])
    err = (got.float() - want.float()).abs().max().item()
    print(f"pipeline: one stage, {PIPE_MICRO} microbatches of 1 x {S} tokens through a "
          f"{cfg.name} layer (d_model {cfg.d_model}, bf16, flash): max_abs_err against the "
          f"unpipelined layer {err:.3e} (want 0); flash_fwd launches {counts['flash_fwd']} "
          f"(want {PIPE_MICRO}) [{smi}]", flush=True)
    if err != 0 or counts["flash_fwd"] != PIPE_MICRO:
        fail(f"pipeline: one stage differs from its layer ({err}) or launched {counts}")


def example(name: str):
    """The module of ``examples/torch/<name>.py`` (a twin of a reference
    example; it imports nothing of JAX), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the reference's step count, and the flash-vs-plain check's steps before it;
# the timed window's first and last step (train_loop logs both)
E2E_STEPS, E2E_CHECK_STEPS = 300, 3
E2E_WINDOW = (20, E2E_STEPS - 1)


def phase_train_e2e(smi: str) -> dict:
    """railx-100m (examples/train_end_to_end.py) through the twin's ``run`` on
    the world of one, mesh (1, 1, 1), ``gspmd_fsdp`` with 2 microbatches, the
    reference's data, AdamW and 300 steps, with ``attn_impl="flash"`` (the
    f32 3xTF32 kernels): first 3 steps of each attention path from the same
    seed (loss rel 1e-5, grad_norm rel 1e-4), then the 300 steps with every
    launch count set to 0 before and read after; the loss must fall by 0.5
    nats (the reference's check) and each of flash_fwd_lse, flash_bwd_dq and
    flash_bwd_dkv run L x 2 microbatches a step.  The steady step, tokens/s
    and MFU come from one window of steps (E2E_WINDOW, less the checkpoints
    saved inside it).  Returns the run's launches."""
    import tempfile

    import torch

    e2e = example("train_end_to_end")
    base = e2e.railx_config()
    cfg = dataclasses.replace(base, attn_impl="flash")
    t0 = time.perf_counter()
    data = e2e.corpus(cfg)
    n_params = cfg.param_count()
    print(f"train_e2e: {cfg.name} L={cfg.num_layers} d_model={cfg.d_model} H={cfg.heads} "
          f"Hk={cfg.kv_heads} Dh={cfg.resolved_head_dim} vocab={cfg.vocab} f32, attn_impl flash; "
          f"{n_params / 1e6:.1f}M params (param_count); corpus of the model's vocabulary, floor "
          f"{data[1]:.4f} nats/token, built in {time.perf_counter() - t0:.2f} s on the host",
          flush=True)
    draws = data[0].batches(E2E_STEPS)  # steps the run does not draw
    t0 = time.perf_counter()
    for _ in range(5):
        next(draws)
    print(f"train_e2e: one batch drawn on the host in {(time.perf_counter() - t0) / 5 * 1e3:.2f} "
          f"ms (mean of 5; train_loop draws it outside the step's own time)", flush=True)
    log = lambda line: print(f"train_e2e: {line}", flush=True)  # noqa: E731
    with tempfile.TemporaryDirectory() as ckpt, _world_of_one() as mesh:
        hist = {}
        for impl in ("flash", "ref"):
            res, _ = e2e.run(dataclasses.replace(base, attn_impl=impl), E2E_CHECK_STEPS, mesh,
                             "cuda", f"{ckpt}/{impl}", log, data=data, log_every=1)
            hist[impl] = res.history
        for step, (f, r) in enumerate(zip(hist["flash"], hist["ref"])):
            dl = abs(f["loss"] - r["loss"]) / abs(r["loss"])
            dg = abs(f["grad_norm"] - r["grad_norm"]) / abs(r["grad_norm"])
            print(f"train_e2e: step {step} flash loss {f['loss']:.7f} gnorm "
                  f"{f['grad_norm']:.7f}, ref loss {r['loss']:.7f} gnorm {r['grad_norm']:.7f}: "
                  f"rel diff {dl:.2e} (tol {MODEL_LOSS_RTOL:g}), {dg:.2e} "
                  f"(tol {MODEL_GNORM_RTOL:g})", flush=True)
            if not (dl <= MODEL_LOSS_RTOL and dg <= MODEL_GNORM_RTOL):
                fail(f"train_e2e: step {step}: the flash and plain attention paths disagree on "
                     f"the card")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with _e2e_clock(log) as (timed_log, marks, saves):
            res, floor = e2e.run(cfg, E2E_STEPS, mesh, "cuda", f"{ckpt}/run", timed_log,
                                 data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    hist = res.history
    first, last = hist[0]["loss"], res.last_metrics["loss"]
    print(f"train_e2e: loss {first:.4f} -> {last:.4f} after {res.steps_done} steps, drop "
          f"{first - last:.4f} nats (need >= 0.5); floor {floor:.4f}, final loss - floor "
          f"{last - floor:.4f}", flush=True)
    if not (res.steps_done == E2E_STEPS and math.isfinite(last) and first - last >= 0.5):
        fail(f"train_e2e: the loss fell from {first} to {last} in {res.steps_done} steps, "
             f"expected a drop >= 0.5")
    n = cfg.num_layers * 2 * E2E_STEPS  # an attention a layer a microbatch, no remat
    want = {**{k: 0 for k in launches},
            **{k: n for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}}
    print(f"train_e2e: launches {launches}; expected {want} ({cfg.num_layers} layers x 2 "
          f"microbatches x {E2E_STEPS} steps, no remat)", flush=True)
    if launches != want:
        fail(f"train_e2e launches {launches} differ from {want}")
    # the window: from the end of step a to the end of step b (train_loop
    # waits for each step's loss before it logs), less the checkpoints saved
    # inside it; it holds each step's batch drawn on the host
    a, b = E2E_WINDOW
    inside = {step: t for step, t in saves.items() if a < step <= b}
    window_s = marks[b] - marks[a] - sum(inside.values())
    step_ms = 1e3 * window_s / (b - a)
    tokens = 16 * 128
    mfu = 6.0 * n_params * tokens / (step_ms / 1e3) / PEAK_FLOPS["float32"]
    sampled = [round(1e3 * h["step_time_s"], 2) for h in hist if a <= h["step"] <= b]
    ckpts = {s_ - 1: round(t, 3) for s_, t in saves.items()}
    print(f"train_e2e: step ms of the logged steps {a}-{b} (the step call and its wait, no "
          f"batch) {sampled}; s of the checkpoint saved after each step {ckpts}", flush=True)
    print(f"train_e2e: steady step {step_ms:.2f} ms over the window of steps {a + 1}-{b} "
          f"({b - a} steps, {marks[b] - marks[a]:.2f} s less the checkpoints after steps "
          f"{sorted(s_ - 1 for s_ in inside)}, {sum(inside.values()):.2f} s), "
          f"{tokens / (step_ms / 1e3):.1f} tokens/s, MFU {mfu:.2%} (6 N tokens / step time / "
          f"67 TFLOP/s, the f32 peak outside the tensor cores: TF32 is off), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; the whole run, its first step and "
          f"{len(saves)} checkpoints included: {E2E_STEPS} steps in {wall:.2f} s, "
          f"{E2E_STEPS * tokens / wall:.1f} tokens/s [{smi}]", flush=True)
    return launches


@contextlib.contextmanager
def _e2e_clock(log):
    """A log function for ``train_loop`` that also notes when each logged
    step ended (the loop waits for the step's loss before it logs), and the
    time of each checkpoint save, by the step it is saved at.  Yields
    (log_fn, {step: perf_counter}, {saved step: seconds})."""
    import re

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt_lib

    marks, saves, save = {}, {}, ckpt_lib.save

    def timed_log(line):
        m = re.match(r"step\s+(\d+) ", line)
        if m:
            marks[int(m.group(1))] = time.perf_counter()
        log(line)

    def timed_save(directory, step, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = save(directory, step, *args, **kwargs)
        torch.cuda.synchronize()
        saves[step] = time.perf_counter() - t
        return out

    ckpt_lib.save = timed_save
    try:
        yield timed_log, marks, saves
    finally:
        ckpt_lib.save = save


def phase_examples(smi: str) -> None:
    """The three smoke-size twins on worlds of one, each to its reference
    assertion: the fault drill (phase 1 on (1, 1), the recovery plan, phase
    2 restoring with resharding on a fresh (1, 1) world), quickstart steps
    1-3 (the network core, plain Python) and step 4 on (1, 1, 1), and
    serve_decode on (1, 1) under a port ``Tracer`` whose trace must validate
    and hold one ``serve.decode_step`` a decode call."""
    import tempfile

    from repro_torch.obs import Tracer, tracing, validate_trace

    log = lambda line: print(f"examples: {line}", flush=True)  # noqa: E731
    ft, qs, sd = (example(n) for n in ("fault_tolerant_training", "quickstart", "serve_decode"))
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            with _world_of_one((1, 1), ("data", "model")) as mesh:
                ft.phase1(mesh, "cuda", ckpt, log_fn=log)
                plan = ft.recovery_plan(log)
            with _world_of_one((1, 1), ("data", "model")) as mesh:
                start, _ = ft.phase2(mesh, "cuda", ckpt, log_fn=log)
        if start != ft.STEPS or plan.mesh_shape != (9, 2):
            fail(f"examples: the drill restored step {start} (want {ft.STEPS}), plan "
                 f"{plan.mesh_shape} (want (9, 2))")
        qs.steps_1_to_3(log)
        with _world_of_one() as mesh:
            losses = qs.train_step4(mesh, "cuda", log_fn=log)
        if not (len(losses) == qs.STEPS and all(map(math.isfinite, losses))
                and losses[-1] < losses[0]):
            fail(f"examples: quickstart step 4's losses {losses} did not fall")
        with _world_of_one((1, 1), ("data", "model")) as mesh:
            with tracing(Tracer(process="serve_decode")) as tracer:
                served = sd.serve(mesh, "cuda", log)
    except AssertionError as e:
        fail(f"examples: a twin's own check failed: {e}")
    stats = validate_trace(tracer.to_dict())
    totals = tracer.phase_totals()
    spans = totals.get("serve.decode_step", {}).get("count", 0)
    print(f"examples: serve_decode trace {stats}; phase_totals {totals} [{smi}]", flush=True)
    if spans != served["steps"] or stats["spans"] != served["steps"]:
        fail(f"examples: {spans} serve.decode_step spans for {served['steps']} decode calls")


def clocked(fn, *args):
    """``fn(*args)``, its wall time printed as a ``clock:`` line, so that a
    run shows where the smoke run's time goes."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"clock: {fn.__name__} {time.perf_counter() - t0:.1f} s wall", flush=True)
    return out


def main() -> None:
    import torch

    t_start = time.perf_counter()
    smi = clocked(phase_env)
    clocked(phase_build)
    kernels = clocked(phase_kernel)
    flow_kernels = clocked(phase_flow, smi)
    torch.cuda.empty_cache()
    clocked(phase_cluster, smi)
    torch.cuda.empty_cache()
    clocked(phase_model)
    # each kernel's launches from the phase whose path it serves
    launches = clocked(phase_serve, smi)
    torch.cuda.empty_cache()
    launches.update(clocked(phase_serve_hybrid, smi))
    torch.cuda.empty_cache()
    launches.update(clocked(phase_serve_xlstm, smi))
    torch.cuda.empty_cache()
    clocked(phase_serve_moe, smi)
    torch.cuda.empty_cache()
    served = {}
    for phase in (phase_serve_gemma3, phase_serve_vlm, phase_serve_whisper):
        served[phase.__name__] = clocked(phase, smi)
        torch.cuda.empty_cache()
    train = clocked(phase_train, smi)
    torch.cuda.empty_cache()
    clocked(phase_dryrun_check, smi, train)
    train_moe = clocked(phase_train_moe, smi)
    torch.cuda.empty_cache()
    with _world_of_one() as mesh:
        clocked(phase_train_dist, smi, train, mesh)
        torch.cuda.empty_cache()
        clocked(phase_train_fsdp, smi, train, mesh)
        torch.cuda.empty_cache()
        clocked(phase_train_moe_fsdp, smi, train_moe, mesh)
    torch.cuda.empty_cache()
    train_gemma3 = clocked(phase_train_gemma3, smi)
    one_process = {"whisper-large-v3": clocked(phase_train_whisper, smi),
                   "qwen2-vl-2b": clocked(phase_train_vlm, smi)}
    torch.cuda.empty_cache()
    one_process["zamba2-7b"] = clocked(phase_train_hybrid, smi)
    one_process["xlstm-125m"] = clocked(phase_train_xlstm, smi)
    with _world_of_one() as mesh:
        clocked(phase_train_fsdp_families, smi, one_process, mesh)
    torch.cuda.empty_cache()
    with _world_of_one((1, 1), ("data", "model")) as mesh:
        clocked(phase_serve_sharded_families, smi, mesh)
    torch.cuda.empty_cache()
    with _world_of_one((1,), ("pipe",)) as mesh:
        clocked(phase_pipeline, smi, mesh)
    torch.cuda.empty_cache()
    train_e2e = clocked(phase_train_e2e, smi)
    torch.cuda.empty_cache()
    clocked(phase_examples, smi)
    print(f"clock: all phases {time.perf_counter() - t_start:.1f} s wall", flush=True)
    launches.update({k: train["launches"][k]
                     for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")})
    launches.update(train["adamw"])
    # the Dh-320 kernels' launches from gemma3-4b's serving and training paths
    launches["flash_fwd_d320"] = served["phase_serve_gemma3"]["flash_fwd"]
    launches.update({f"{k}_d320": train_gemma3["launches"][k]
                     for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")})
    # the f32 kernels' launches from railx-100m's training path
    launches.update({f"{k}_f32": train_e2e[k]
                     for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")})
    for k in kernels:
        k["launches"] = launches[k["name"]]
    kernels += flow_kernels  # their launches from phase_flow's main path
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
