"""The training loop, with checkpoints and straggler detection (counterpart
of ``repro/train/trainer.py``).

The loop is thin: params and optimizer state live on the device, and the
data position is the step counter (the pipeline is counter-based), so
recovery is "restore the latest checkpoint, continue from its step".

  * CheckpointPolicy: every ``every_steps`` steps, keep the last
    ``keep_last``, atomic writes (``checkpoint.save``).  With ``layout``
    (a sharded run) every rank takes the policy: each save gathers whole
    leaves on every rank and rank 0 writes them.
  * StragglerMonitor: EWMA of step time; a step slower than ``threshold``
    times the EWMA for ``patience`` consecutive steps raises StragglerAlert.
  * resume(): restores params and optimizer state; the caller restarts the
    data at the returned step.

A step's time is taken after ``loss.item()``, which waits for the device:
the counterpart of the reference's ``block_until_ready``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..checkpoint import checkpoint as ckpt_lib
from ..parallel.sharding import Layout


class StragglerAlert(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    patience: int = 3
    ewma_alpha: float = 0.1
    _ewma: Optional[float] = None
    _slow_streak: int = 0

    def observe(self, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.threshold * self._ewma:
            self._slow_streak += 1
            if self._slow_streak >= self.patience:
                raise StragglerAlert(
                    f"step {dt:.3f}s > {self.threshold}x EWMA {self._ewma:.3f}s"
                    f" for {self._slow_streak} consecutive steps"
                )
        else:
            self._slow_streak = 0
        self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * dt


@dataclasses.dataclass
class CheckpointPolicy:
    directory: str
    every_steps: int = 100
    keep_last: int = 3
    layout: Optional[Layout] = None


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    last_metrics: Dict[str, float]
    history: List[Dict[str, float]]


def train_loop(
    step_fn: Callable,
    params: Any,
    opt_state: Any,
    batches: Iterator[Dict[str, Any]],
    num_steps: int,
    start_step: int = 0,
    ckpt: Optional[CheckpointPolicy] = None,
    straggler: Optional[StragglerMonitor] = None,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
) -> TrainResult:
    history: List[Dict[str, float]] = []
    metrics_host: Dict[str, float] = {}
    step = start_step
    for step in range(start_step, num_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics["loss"].item()  # waits for the device
        dt = time.perf_counter() - t0
        if straggler is not None:
            straggler.observe(dt)
        if step % log_every == 0 or step == num_steps - 1:
            metrics_host = {k: float(v) for k, v in metrics.items()}
            metrics_host["step_time_s"] = dt
            history.append({"step": step, **metrics_host})
            log_fn(
                f"step {step:6d} loss {metrics_host['loss']:.4f} "
                f"gnorm {metrics_host.get('grad_norm', 0):.3f} {dt*1e3:.0f} ms"
            )
        if ckpt is not None and (step + 1) % ckpt.every_steps == 0:
            ckpt_lib.save(
                ckpt.directory, step + 1,
                {"params": params, "opt": opt_state},
                extra={"step": step + 1}, layout=ckpt.layout,
            )
            if ckpt_lib.is_writer(ckpt.layout):
                _gc_checkpoints(ckpt)
    return TrainResult(step + 1 - start_step, metrics_host, history)


def resume(ckpt_dir: str, params_like: Any, opt_like: Any,
           layout: Optional[Layout] = None) -> Tuple[Any, Any, int]:
    """Restore {params, opt} from the latest checkpoint onto the devices and
    dtypes of the ``*_like`` trees (with ``layout``, this rank's blocks);
    returns (params, opt_state, start_step)."""
    tree, extra = ckpt_lib.restore(ckpt_dir, {"params": params_like, "opt": opt_like},
                                   layout=layout)
    return tree["params"], tree["opt"], int(extra["step"])


def _gc_checkpoints(policy: CheckpointPolicy) -> None:
    steps = sorted(
        int(d.split("_")[-1])
        for d in os.listdir(policy.directory)
        if d.startswith("step_")
    )
    for s in steps[: -policy.keep_last]:
        shutil.rmtree(os.path.join(policy.directory, f"step_{s:08d}"), ignore_errors=True)
