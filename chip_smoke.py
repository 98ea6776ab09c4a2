#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. env     torch/CUDA versions, the card, its power limit; TF32 off.
2. build   nvcc builds every kernel source of the main paths (in parallel),
           with the -Xptxas -v register / shared-memory lines.
3. kernel  each kernel against its plain PyTorch version on the card, case
           by case (flash_fwd; flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv;
           ssd_fwd; mlstm_fwd), then timed at its main path's shape
           (serving prefill for flash_fwd, the training step for the other
           flash kernels, zamba2-7b and xlstm-125m at 4 x 1024 tokens for
           the scans) beside its bound and, where one exists, the library
           call that computes the same function.
4. model   a small llama-shaped f32 model on the card (flash kernels)
           against the same weights on the CPU (plain path): a forward, two
           train steps (remat on the card), and a checkpoint round trip;
           then the zamba2 and xlstm smoke models the same way (SSD and
           mLSTM kernels): a forward and 3 decode steps; then moonshot-smoke
           (MoE, 4 experts top-2): a forward (logits, aux), two train steps
           (loss, aux, grad_norm) and 3 decode steps, with the share of
           token -> expert choices that agree between card and CPU (all
           must agree).
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
9. train   llama3.2-3b at full width and depth in bf16 (f32 moments),
           remat, flash attention: 8 AdamW steps of 4 x 1024 tokens through
           ``train_loop``; the loss must fall, and the launches of that run
           must be 2L flash_fwd_lse, L flash_bwd_dq and L flash_bwd_dkv per
           step and no flash_fwd.
10. train_moe  moonshot-v1-16b-a3b at full width, depth cut to 4 layers,
           the same way: the loss must fall, aux be > 0 every step, and the
           launches be the train phase's per layer.
11. train_dist  the same model, seed and data through the distributed
           ``manual_hier`` step on a world of one (NCCL, mesh (1, 1, 1)
           ("pod", "data", "model")): 8 steps of the ``hierarchical``
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

Every serve and train phase sets all launch counts to 0 before it runs and
reads them after; the ``kernels`` line reports each kernel's launches from
the phase whose path it serves.

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
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mlstm import mlstm
    from repro_torch.kernels.ssd import ssd

    sources = [fa.SOURCE, fa.BWD_SOURCE, ssd.SOURCE, mlstm.SOURCE]
    t0 = time.perf_counter()
    build.build_all(sources)
    print(f"build: {len(sources)} source(s) in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        info = build.BUILD_INFO[src]
        print(f"build: {src} nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"build:   {line.strip()}")
    # the TMA / wgmma kernels keep their products' fragments in registers:
    # each instantiation (Dh 64, 128) must build without spilling
    for src, kernel in ((fa.SOURCE, "flash_fwd_wgmma_kernel"),
                        (fa.BWD_SOURCE, "flash_bwd_dq_wgmma_kernel"),
                        (fa.BWD_SOURCE, "flash_bwd_dkv_wgmma_kernel")):
        spills = _spill_stores(build.BUILD_INFO[src]["log"], kernel)
        print(f"build: {kernel} instantiations {len(spills)}, spill stores "
              f"{sorted(spills.values())} bytes", flush=True)
        if len(spills) != 2 or any(spills.values()):
            fail(f"{kernel} should build twice (Dh 64, 128) without spills: {spills}")
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
# at Dh 64 and 128 runs the TMA / wgmma kernel (128-row q tiles, 128-key
# tiles), Dh 16 and 32 the mma.sync one; "model" passes q/k/v as the
# transposed views of (B, S, H, Dh) that ops.flash_attention passes.
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
]


def _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed, layout="kernel"):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(b, h, s, d):
        if layout == "model":
            x = torch.randn((b, s, h, d), generator=g, device="cuda", dtype=torch.float32)
            return x.to(dt).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=g, device="cuda", dtype=torch.float32).to(dt)

    return randn(B, H, Sq, Dh), randn(B, Hk, Skv, Dh), randn(B, Hk, Skv, Dh)


def _bound(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms) -> dict:
    """``source`` and ``replaces`` are paths under src/repro_torch/kernels
    and src/repro/kernels."""
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/{source}",
        "replaces": f"src/repro/kernels/{replaces}",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
    }


def _flash_entry(name, source, line, *rest) -> dict:
    return _entry(name, f"flash_attention/csrc/{source}",
                  f"flash_attention/flash_attention.py:{line}", *rest)


def reset_launch_counts() -> None:
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
    return [_flash_fwd_kernel(), *_training_kernels(), _ssd_kernel(), _mlstm_kernel()]


def _flash_fwd_kernel() -> dict:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    worst = 0.0
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

    timed = _time_forward("flash_fwd", fa.flash_attention_fwd, attention_ref, with_lse=False)
    return _flash_entry("flash_fwd", "flash_fwd.cu", 35, None, worst, *timed)


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
    """Whether ``call`` runs here (a pinned sdpa backend may refuse a shape)."""
    import torch

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"kernel: yardstick refused: {str(e).splitlines()[0][:160]}", flush=True)
        return False
    return True


def _fwd_yardsticks(q, k, v, with_lse: bool) -> dict:
    """Library calls of PyTorch that compute the forward at the timed shape,
    timed as the kernel is: {label: ms}.  Without lse: sdpa pinned to each
    backend that runs here (GQA through enable_gqa where the backend takes
    it, else k/v expanded to H heads outside the timing).  With lse: aten's
    flash and cuDNN forwards, which return the logsumexp too (on k/v
    expanded to H heads: they take no GQA)."""
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
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            for gqa, kk, vv in ((True, k, v), (False, ke, ve)):
                def call(backend=backend, kk=kk, vv=vv, gqa=gqa):
                    with sdpa_kernel(backend):
                        return F.scaled_dot_product_attention(q, kk, vv, is_causal=True,
                                                              enable_gqa=gqa)
                if _runs(call):
                    calls[f"sdpa[{backend.name}{'' if gqa else ', k/v expanded'}]"] = call
                    break
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

    worst = {"flash_fwd_lse": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
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
    return entries


def _bwd_yardsticks(q, k, v, do) -> tuple:
    """PyTorch's own attention backwards at the timed shape, called as aten
    ops (so that they capture into a CUDA graph), each fed by its own aten
    forward, on k/v expanded to H heads (they take no GQA).  Returns
    ({label: (ms, how it was timed)}, ms of summing the expanded dk or dv
    back to Hk heads, twice): an op that will not capture is timed
    back-to-back, and says so."""
    import torch

    aten = torch.ops.aten
    B, H, S, Dh = q.shape
    Hk = k.shape[1]
    ke, ve = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))

    def flash():
        out, lse, cq, ck, mq, mk, seed, off, _ = aten._scaled_dot_product_flash_attention(
            q, ke, ve, 0.0, True)
        return lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, ke, ve, out, lse, cq, ck, mq, mk, 0.0, True, seed, off)

    def cudnn():
        out, lse, cq, ck, mq, mk, seed, off, _ = aten._scaled_dot_product_cudnn_attention(
            q, ke, ve, None, True, 0.0, True)
        return lambda: aten._scaled_dot_product_cudnn_attention_backward(
            do, q, ke, ve, out, lse, seed, off, None, cq, ck, mq, mk, 0.0, True)

    def efficient():
        out, lse, seed, off = aten._scaled_dot_product_efficient_attention(
            q, ke, ve, None, True, 0.0, True)
        return lambda: aten._scaled_dot_product_efficient_attention_backward(
            do, q, ke, ve, None, out, lse, seed, off, 0.0, [True, True, True, False], True)

    times = {}
    for label, make in (("aten._scaled_dot_product_flash_attention_backward", flash),
                        ("aten._scaled_dot_product_cudnn_attention_backward", cudnn),
                        ("aten._scaled_dot_product_efficient_attention_backward", efficient)):
        try:
            call = make()
            call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"kernel: yardstick {label} refused: {str(e).splitlines()[0][:160]}",
                  flush=True)
            continue
        try:
            times[label] = (_graph_ms(call), "device time, CUDA graph")
        except RuntimeError as e:
            torch.cuda.synchronize()
            times[label] = (_time_ms(call), "back-to-back: it does not capture into a CUDA "
                            f"graph ({str(e).splitlines()[0][:80]})")
    dke = torch.randn((B, H, S, Dh), device=q.device).to(q.dtype)
    group_ms = 2 * _graph_ms(lambda: dke.view(B, Hk, H // Hk, S, Dh).sum(2))
    return times, group_ms


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
    return _entry("ssd_fwd", "ssd/csrc/ssd_fwd.cu", "ssd/ssd.py:29", None, worst, ms, plain_ms,
                  bound, None)


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
    return _entry("mlstm_fwd", "mlstm/csrc/mlstm_fwd.cu", "mlstm/mlstm.py:26", None, worst, ms,
                  plain_ms, bound, None)


def phase_model() -> None:
    """Small llama-shaped model: flash kernel on the card vs plain path on
    the CPU with the same weights, in f32."""
    import torch

    from repro_torch.configs import get_config
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


# two f32 train steps, card vs CPU.  loss and grad_norm: f32 sums in another
# order (~1e-6 relative).  params: after AdamW's first steps an element moves
# by lr * mhat / (sqrt(vhat) + eps), about lr = 1e-3, and the two sides' grads
# agree to ~1e-6 relative, so 99.9 % of elements agree within 1e-6 abs; an
# element whose grad is near zero has an unstable ratio and may differ by a
# fraction of a step, so every element stays within 1e-4 (10 % of lr).
MODEL_LOSS_RTOL, MODEL_GNORM_RTOL = 1e-5, 1e-4
MODEL_PARAM_TIGHT, MODEL_PARAM_SHARE, MODEL_PARAM_MAX = 1e-6, 0.999, 1e-4


def _model_train(base, init_params) -> None:
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    state = {k: v.detach() for k, v in init_params.state_dict().items()}
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=128, global_batch=4))
    sides = {}
    for dev, cfg in (("cuda", dataclasses.replace(base, attn_impl="flash", remat=True)),
                     ("cpu", base)):
        params = ParamTree.from_state_dict({k: v.to(dev).clone() for k, v in state.items()},
                                           requires_grad=True)
        step_fn = make_train_step(get_model(cfg), ocfg, device=dev)
        opt = opt_lib.init(ocfg, params)
        fa.reset_launch_counts()
        metrics = []
        for step in range(2):
            params, opt, m = step_fn(params, opt, data.batch(step))
            metrics.append({k: float(v) for k, v in m.items()})
        sides[dev] = (params, opt, metrics, fa.launch_counts())
    (gp, gopt, gm, counts), (cp, _, cm, _) = sides["cuda"], sides["cpu"]
    L = base.num_layers
    want = {"flash_fwd": 0, "flash_fwd_lse": 2 * 2 * L, "flash_bwd_dq": 2 * L,
            "flash_bwd_dkv": 2 * L}
    print(f"model: 2 train steps (remat) on the card launched {counts}", flush=True)
    if counts != want:
        fail(f"small-model train steps launched {counts}, expected {want}")
    for step, (g, c) in enumerate(zip(gm, cm)):
        dl = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        dg = abs(g["grad_norm"] - c["grad_norm"]) / abs(c["grad_norm"])
        print(f"model: train step {step} card loss {g['loss']:.7f} gnorm {g['grad_norm']:.7f}, "
              f"cpu loss {c['loss']:.7f} gnorm {c['grad_norm']:.7f}: rel diff {dl:.2e} "
              f"(tol {MODEL_LOSS_RTOL:g}), {dg:.2e} (tol {MODEL_GNORM_RTOL:g})", flush=True)
        if not (dl <= MODEL_LOSS_RTOL and dg <= MODEL_GNORM_RTOL):
            fail(f"train step {step}: card and CPU disagree on loss or grad_norm")
    cstate = cp.state_dict()
    diff = torch.cat([(v.cpu() - cstate[k]).abs().flatten() for k, v in gp.state_dict().items()])
    perr, share = diff.max().item(), (diff <= MODEL_PARAM_TIGHT).float().mean().item()
    print(f"model: params after 2 steps, card vs cpu: max_abs_err {perr:.3e} (tol "
          f"{MODEL_PARAM_MAX:g}), share within {MODEL_PARAM_TIGHT:g}: {share:.6f} "
          f"(need {MODEL_PARAM_SHARE})", flush=True)
    if not (perr <= MODEL_PARAM_MAX and share >= MODEL_PARAM_SHARE):
        fail(f"params after 2 train steps disagree: max {perr}, share {share}")
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

    def recorded(router_w, cfg, xt, dt, cap):
        r = route(router_w, cfg, xt, dt, cap)
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

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = train_loop(step_fn, params, opt, data.batches(0), num_steps=steps,
                     log_every=1, log_fn=lambda line: print(f"{tag}: {line}", flush=True))
    torch.cuda.synchronize()
    hist = res.history
    run = {"launches": launch_counts(), "peak": torch.cuda.max_memory_allocated(),
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

    run = _train_run("train", step_fn, params, opt, data, TRAIN_STEPS)
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

    mean_ms = run["mean_ms"]
    tokens = TRAIN_B * TRAIN_S
    mfu = 6.0 * n_params * tokens / (mean_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    print(f"train: per-step ms {[round(t, 2) for t in run['step_ms']]}", flush=True)
    print(f"train: steady step {mean_ms:.2f} ms (mean of steps 1-{TRAIN_STEPS - 1}), "
          f"{tokens / (mean_ms / 1e3):.1f} tokens/s, MFU {mfu:.2%} (6 N tokens / step time / "
          f"989 TFLOP/s), max_memory_allocated {run['peak'] / 2**30:.2f} GiB [{smi}]", flush=True)
    return run


def _largest_gap(got: list, want: list) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


@contextlib.contextmanager
def _world_of_one():
    """A (1, 1, 1) ("pod", "data", "model") mesh of one rank through NCCL."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cuda")
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


def main() -> None:
    import torch

    smi = phase_env()
    phase_build()
    kernels = phase_kernel()
    phase_model()
    # each kernel's launches from the phase whose path it serves
    launches = phase_serve(smi)
    torch.cuda.empty_cache()
    launches.update(phase_serve_hybrid(smi))
    torch.cuda.empty_cache()
    launches.update(phase_serve_xlstm(smi))
    torch.cuda.empty_cache()
    phase_serve_moe(smi)
    torch.cuda.empty_cache()
    train = phase_train(smi)
    torch.cuda.empty_cache()
    train_moe = phase_train_moe(smi)
    torch.cuda.empty_cache()
    with _world_of_one() as mesh:
        phase_train_dist(smi, train, mesh)
        torch.cuda.empty_cache()
        phase_train_fsdp(smi, train, mesh)
        torch.cuda.empty_cache()
        phase_train_moe_fsdp(smi, train_moe, mesh)
    launches.update({k: train["launches"][k]
                     for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")})
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
