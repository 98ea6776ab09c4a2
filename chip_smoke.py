#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. env     torch/CUDA versions, the card, its power limit; TF32 off.
2. build   nvcc builds every kernel source of the main path (in parallel),
           with the -Xptxas -v register / shared-memory lines.
3. kernel  each kernel against its plain PyTorch version on the card, case
           by case, then timed at the serving shape beside its bound and
           the library call that computes the same function.
4. model   a small llama-shaped model on the card (flash kernel) against the
           same weights on the CPU (plain path).
5. serve   llama3.2-3b at full width in bf16, random weights from a seed:
           8 requests of 1024-token prompts, 32 new tokens each, in two
           waves of 4 slots; counts the kernel launches of that run.

Then the ``kernels`` JSON line and, last, the ``ok`` JSON line.  It needs a
CUDA device and the rest of the repository: without either it fails before
printing any result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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

    sources = [fa.SOURCE]
    t0 = time.perf_counter()
    build.build_all(sources)
    print(f"build: {len(sources)} source(s) in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        info = build.BUILD_INFO[src]
        print(f"build: {src} nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"build:   {line.strip()}")
    sys.stdout.flush()


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


# name, B, H, Hk, Sq, Skv, Dh, causal, window, q_offset, dtype
FLASH_CASES = [
    ("serve_prefill", 4, 24, 8, 1024, 1024, 128, True, None, 0, "bfloat16"),
    ("ragged_1000", 2, 24, 8, 1000, 1000, 128, True, None, 0, "bfloat16"),
    ("window_256", 2, 24, 8, 1024, 1024, 128, True, 256, 0, "bfloat16"),
    ("q_offset_960", 2, 24, 8, 64, 1024, 128, True, None, 960, "bfloat16"),
    ("mqa_hk1", 2, 48, 1, 512, 512, 128, True, None, 0, "bfloat16"),
    ("non_causal", 2, 8, 4, 384, 320, 64, False, None, 0, "bfloat16"),
    ("head_dim_32", 2, 4, 2, 200, 200, 32, True, None, 0, "bfloat16"),
    ("head_dim_16", 2, 4, 2, 64, 64, 16, True, None, 0, "bfloat16"),
    ("f32", 2, 8, 2, 1000, 1000, 128, True, None, 0, "float32"),
    ("f32_window_d64", 2, 4, 4, 256, 256, 64, True, 48, 0, "float32"),
    # window without causal: rows at q >= 143 see no key and average v
    ("no_visible_key", 1, 4, 2, 64, 128, 64, False, 16, 100, "bfloat16"),
    ("no_visible_key_f32", 1, 4, 2, 64, 128, 64, False, 16, 100, "float32"),
]


def _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dt)

    return randn(B, H, Sq, Dh), randn(B, Hk, Skv, Dh), randn(B, Hk, Skv, Dh)


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_mask, attention_ref

    worst = 0.0
    for i, (name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype) in enumerate(FLASH_CASES):
        q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=i)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
        finite = bool(torch.isfinite(out).all())
        print(f"kernel flash_fwd {name}: B={B} H={H} Hk={Hk} Sq={Sq} Skv={Skv} Dh={Dh} "
              f"causal={causal} window={window} q_offset={q_off} {dtype}: "
              f"max_abs_err {err:.3e} (tol {tol:g})", flush=True)
        if not finite or not err <= tol:
            fail(f"flash_fwd {name} disagrees with attention_ref: {err} > {tol}")
        if name == "serve_prefill":
            worst = err

    # timing at the serving prefill shape
    name, B, H, Hk, Sq, Skv, Dh, causal, window, q_off, dtype = FLASH_CASES[0]
    q, k, v = _flash_inputs(B, H, Hk, Sq, Skv, Dh, dtype, seed=0)
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = _time_ms(lambda: attention_ref(q, k, v, causal=True), iters=5)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    visible = int(attention_mask(Sq, Skv, causal, window, q_off, "cuda").sum())
    flops = 4.0 * Dh * visible * B * H              # QK^T and PV over visible pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))  # q, k, v in; o out
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"kernel flash_fwd timing at {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops:.4g} FLOP, {nbytes:.4g} B), {bound_ms / ms:.1%} of bound", flush=True)
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:35",
        "replaces_fn": "_flash_fwd_kernel",
        "checked": True,
        "launches": None,
        "max_abs_err": worst,
        "max_err": worst,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


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


def phase_serve(smi: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
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
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    waves = serve_waves(zoo, ServeArtifacts(timed_decode, timed_prefill), params, sched, CACHE,
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES

    for r in reqs:
        ok = len(r.generated) == r.max_new or (r.generated and r.generated[-1] == sched.eos_id)
        if not (r.done and ok):
            fail(f"request {r.rid} unanswered: {len(r.generated)} tokens, done={r.done}")
    n_prefill = len(times["prefill"])
    print(f"serve: {len(reqs)} requests answered in {len(waves)} waves; tokens per request "
          f"{[len(r.generated) for r in reqs]}", flush=True)
    if launches != cfg.num_layers * n_prefill or launches == 0:
        fail(f"flash_fwd launched {launches} times, expected {cfg.num_layers} x {n_prefill} prefills")
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


def main() -> None:
    smi = phase_env()
    phase_build()
    kernels = [phase_kernel()]
    phase_model()
    launches = phase_serve(smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
