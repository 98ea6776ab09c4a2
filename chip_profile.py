#!/usr/bin/env python3
"""Where the serving time goes on the card: llama3.2-3b at full width in
bf16 (the ``chip_smoke.py`` serve phase), one wave of 4 x 1024-token
prompts, profiled phase by phase with ``torch.profiler``.

    python3 chip_profile.py

For each phase (prefill through the flash kernel, cache fill, one-token
decode steps) it prints the host time, the device time summed over kernels,
the device busy share, and the kernels that take most device time.  Needs a
CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

STEPS = 8  # one-token decode steps profiled


def _device_us(prof) -> tuple:
    """(sum of kernel time, busy time of the union of kernel intervals) in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA")
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


def main() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
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
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        total, busy = _device_us(prof)
        per = STEPS if name == "decode" else 1
        print(f"profile {name}: host {host_ms / per:.3f} ms, kernels {total / 1e3 / per:.3f} ms, "
              f"device busy {busy / 1e3 / per:.3f} ms ({busy / 1e3 / host_ms:.1%}) per "
              f"{'step' if name == 'decode' else 'call'}")
        table = prof.key_averages().table(sort_by="device_time_total", row_limit=12,
                                          max_name_column_width=70)
        print(table)


if __name__ == "__main__":
    main()
