"""The runner of ``kind: "train"`` configurations: one cell's run.

Set-up builds the one training object that the window drives:
``repro_torch.train.train_step.make_train_step``'s ``step_fn`` with the
configuration's model (``repro_torch.configs.get_config`` of its
``registry`` name, replaced by the file's ``model`` sizes and ``run``
settings), its AdamW state (``repro_torch.train.optimizer.init``) and the
weights made from the seed (``portbench.weights``).  Its first
``checked_steps`` steps go through the window's own call on distinct steps
of the mix; they compile and warm every shape of the cell, and their
readings (each step's loss; each weight's norm of the first gradient as
AdamW takes it, from the first moment after step one, mu / (1 - b1); each
weight's norm of its change over those steps) are what the reference is
compared with.  The window then calls ``step_fn`` step after step as
``train.trainer.train_loop`` does (the step, then ``loss.item()``, which
waits for the card), on the mix's steps in turn, until ``seconds`` have
passed; every step counts whole.  With ``trace`` a few whole steps in the
middle of the window run under the profiler (``portbench.trace``) and are
left out of the step time ``mfu`` reads.  After the window: the peak
memory is read, the program's state freed, and the plain reference
(``reference/<name>.py``) follows the same first steps from the same
weights and batches, and ``portbench.compare`` decides ``correct``.

``fault`` (for the benchmark's own tests and ``readings.py``) breaks the
timed path: ``"unchanged"`` steps return the state as it came,
``"half_batch"`` steps take half the rows and the mean over them.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time
from typing import Any, Dict, List, Optional

import torch

from portbench import compare, counts, tokens, trace, weights

STORED = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sizes(cell) -> Dict[str, Any]:
    return cell.config["model"]


def reference(cell):
    return importlib.import_module(f"portbench.reference.{cell.config['reference']}")


def program_config(cell):
    """The port's ``ModelConfig`` as the configuration file states it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEParams

    run = cell.config["run"]
    base = get_config(run["registry"])
    fields = dict(sizes(cell))
    if fields.get("moe") is not None:
        fields["moe"] = MoEParams(**fields["moe"])
    dtype = STORED[run["dtype"]]
    return dataclasses.replace(base, **fields, param_dtype=dtype, compute_dtype=dtype,
                               remat=run["remat"], attn_impl=run["attn_impl"])


@dataclasses.dataclass
class Program:
    zoo: Any
    step_fn: Any
    params: Any
    opt_state: Any
    opt_cfg: Any
    pool: List[Dict[str, torch.Tensor]]   # the mix's steps, on the device
    layout: Dict[str, Any]                # the reference's parameter layout
    ref: Any                              # the reference's module
    seed: int
    dtype: torch.dtype
    device: torch.device
    build_s: Dict[str, float]             # seconds of the build's parts

    def step(self, i: int) -> torch.Tensor:
        """Step ``i`` of the run (on the mix's step i mod pool); returns the
        loss, read on the host (which waits for the card)."""
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self.pool[i % len(self.pool)])
        return metrics["loss"].item()


def step_batches(cell, seed: int, steps: int, device) -> List[Dict[str, torch.Tensor]]:
    ids = tokens.stream(cell.traffic, sizes(cell)["vocab"], seed, steps)
    out = []
    for rows in ids:
        b = tokens.step_batch(rows)
        out.append({k: torch.as_tensor(v.copy(), device=device) for k, v in b.items()})
    return out


def _faulty(step_fn, fault: Optional[str], zoo, rows: int, microbatches: int, opt_cfg, device):
    """``step_fn`` with the timed path broken as ``fault`` says."""
    from repro_torch.train.train_step import make_train_step

    if fault is None:
        return step_fn
    if fault == "unchanged":
        def unchanged(params, opt_state, batch):
            with torch.no_grad():
                loss, _ = zoo.loss(params, batch)
            return params, opt_state, {"loss": loss}
        return unchanged
    if fault == "half_batch":
        # the first half of the rows, in as many microbatches as divide them
        half_mb = microbatches if (rows // 2) % microbatches == 0 else max(1, microbatches // 2)
        half_step = make_train_step(zoo, opt_cfg, microbatches=half_mb, device=device)

        def half(params, opt_state, batch):
            return half_step(params, opt_state, {k: v[:rows // 2] for k, v in batch.items()})
        return half
    raise ValueError(f"unknown fault {fault!r}")


def build(cell, seed: int, device, fault: Optional[str] = None) -> Program:
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    clock = [("start", time.perf_counter())]
    cfg = program_config(cell)
    zoo = get_model(cfg)
    # the reference's names and shapes; a program that takes others fails
    # its forward or the comparison (``compare.numbers``: other names read inf)
    layout = reference(cell).param_layout(sizes(cell))
    clock.append(("model", time.perf_counter()))
    dtype = STORED[cell.config["run"]["dtype"]]
    params = ParamTree.from_state_dict(weights.make(layout, seed, dtype, device))
    params.requires_grad_(True)
    _sync(device)
    clock.append(("weights", time.perf_counter()))
    opt_cfg = opt_lib.AdamWConfig(**cell.traffic["optimizer"])
    microbatches = int(cell.traffic["microbatches"])
    step_fn = make_train_step(zoo, opt_cfg, microbatches=microbatches, device=device)
    step_fn = _faulty(step_fn, fault, zoo, tokens.rows_per_step(cell.traffic), microbatches,
                      opt_cfg, device)
    opt_state = opt_lib.init(opt_cfg, params)
    _sync(device)
    clock.append(("optimizer", time.perf_counter()))
    pool = step_batches(cell, seed, int(cell.traffic["pool_steps"]), device)
    clock.append(("batches", time.perf_counter()))
    parts = {name: t - clock[i][1] for i, (name, t) in enumerate(clock[1:])}
    return Program(zoo, step_fn, params, opt_state, opt_cfg, pool, layout, reference(cell), seed,
                   dtype, torch.device(device), parts)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def checked_steps(prog: Program, n: int) -> Dict[str, Any]:
    """The first ``n`` steps, with the readings the reference is held to."""
    b1 = prog.opt_cfg.b1
    losses, grad = [], {}
    ref = prog.ref
    for i in range(n):
        losses.append(prog.step(i))
        if i == 0:
            grad = ref.leaf_norms(dict(prog.opt_state.mu), 1.0 / (1.0 - b1))
    change: Dict[str, float] = {}
    with torch.no_grad():
        for name, p in prog.params.named_parameters():
            p0 = weights.make_leaf(prog.layout, name, prog.seed, prog.dtype, prog.device)
            change.update(ref.leaf_norms({name: p.to(torch.float32) - p0.to(torch.float32)}))
            del p0
    return {"loss": losses, "grad": grad, "change": change}


def reference_readings(cell, seed: int, device, steps: int,
                       precision: str = "float32") -> Dict[str, Any]:
    """The reference's readings of the first ``steps`` steps (``precision``
    ``fp8`` is the control)."""
    ref = reference(cell)
    layout = ref.param_layout(sizes(cell))
    stored = STORED[cell.config["run"]["dtype"]]
    w0 = weights.make(layout, seed, stored, device)
    mb = int(cell.traffic["microbatches"])
    batches = []
    for b in step_batches(cell, seed, int(cell.traffic["pool_steps"]), device)[:steps]:
        toks, tgts = b["tokens"].chunk(mb), b["targets"].chunk(mb)
        batches.append(list(zip(toks, tgts)))
    return ref.train(w0, sizes(cell), cell.traffic["optimizer"], batches, precision, stored)


@dataclasses.dataclass
class Record:
    """What the metrics read of one run."""
    chips: int
    setup_s: float
    tokens_per_step: int
    flops_per_step: float
    steps: List[Dict[str, Any]]        # the window's steps: seconds, loss, profiled
    window_s: float
    peak_bytes: int
    trace: Optional[trace.Trace]
    stages: Dict[str, float]           # seconds of set-up's parts and of the reference

    def unprofiled_step_s(self) -> List[float]:
        return [s["seconds"] for s in self.steps if not s["profiled"]]


def free(prog: Program) -> None:
    prog.params = prog.opt_state = prog.step_fn = prog.pool = None
    gc.collect()
    if prog.device.type == "cuda":
        torch.cuda.empty_cache()


def window(prog: Program, first: int, seconds: float, profile_steps: int) -> tuple:
    """Steps from ``first`` on until ``seconds`` have passed (each step
    whole); with ``profile_steps``, that many steps in the middle under the
    profiler.  -> (steps, window seconds, trace)."""
    steps, traced = [], None
    i = first
    t_start = time.perf_counter()
    while True:
        if profile_steps and traced is None and time.perf_counter() - t_start >= seconds / 2:
            t0 = time.perf_counter()
            losses: List[float] = []
            n = i
            traced = trace.profiled(lambda: losses.append(prog.step(n + len(losses))),
                                    profile_steps)
            per = (time.perf_counter() - t0) / profile_steps
            steps += [{"seconds": per, "loss": x, "profiled": True} for x in losses]
            i += profile_steps
        t0 = time.perf_counter()
        loss = prog.step(i)
        t1 = time.perf_counter()
        steps.append({"seconds": t1 - t0, "loss": loss, "profiled": False})
        i += 1
        if t1 - t_start >= seconds:
            return steps, t1 - t_start, traced


def run(cell, seed: int, seconds: float, trace_on: bool, t_start: float,
        device: str = "cuda", fault: Optional[str] = None) -> Dict[str, Any]:
    """One run: -> {"record", "correct", "checks", "numbers"}."""
    run_cfg = cell.traffic
    n_checked = int(run_cfg["checked_steps"])
    t_cuda = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.zeros((), device=device)
        torch.cuda.synchronize()
    t_build = time.perf_counter()
    prog = build(cell, seed, device, fault)
    t_steps = time.perf_counter()
    found = checked_steps(prog, n_checked)
    if prog.device.type == "cuda":
        torch.cuda.synchronize()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    stages = {"imports": t_cuda - t_start, "cuda_init": t_build - t_cuda,
              "build": t_steps - t_build, **{f"build.{k}": v for k, v in prog.build_s.items()},
              "checked_steps": t_window - t_steps}
    steps, window_s, traced = window(prog, n_checked, seconds,
                                     int(run_cfg["profile_steps"]) if trace_on else 0)
    peak = torch.cuda.max_memory_allocated() if prog.device.type == "cuda" else 0
    free(prog)
    if prog.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device, n_checked)
    stages["reference"] = time.perf_counter() - t_ref
    nums = compare.numbers(found, ref)
    correct, checks = compare.verdict(nums, cell.limits)
    finite = all(math.isfinite(s["loss"]) for s in steps)
    sequences = tokens.rows_per_step(run_cfg)
    record = Record(
        chips=cell.chips, setup_s=setup_s, tokens_per_step=tokens.tokens_per_step(run_cfg),
        flops_per_step=counts.train_step_flops(sizes(cell), sequences, int(run_cfg["seq_len"])),
        steps=steps, window_s=window_s, peak_bytes=peak, trace=traced, stages=stages)
    return {"record": record, "correct": bool(correct and finite), "checks": checks,
            "numbers": nums, "program": found, "reference": ref}
