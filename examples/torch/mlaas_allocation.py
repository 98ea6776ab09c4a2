"""MLaaS scenario (paper §6.6 / Figure 20, §7), the PyTorch port's twin of
``examples/mlaas_allocation.py``, driven by the port's ``repro_torch.cluster``
discrete-event scheduler: a heterogeneous multi-job trace — five distinct
model configs — lands on a faulted 16x16 RailX grid, node failures strike
mid-run, and the OCS layer is re-programmed around them (every placement's
circuit plan is validated against the core.topology ring / all-to-all
invariants; see ``ClusterScheduler(validate_circuits=True)``).

Act two demonstrates the policy engine on the same grid: a saturated
cluster of best-effort (tier-0) jobs takes a production (tier-2)
submission — preemption checkpoint-evicts the cheapest victims so the SLO
job starts instantly; a node failure shrinks a job elastically and
re-expansion grows it back once the node recovers; gang scoring steers
repeat shapes onto their old rectangles so the OCS reuses the
still-programmed circuits (near-zero mirror strokes).

    PYTHONPATH=src python examples/torch/mlaas_allocation.py               # the card
    PYTHONPATH=src python examples/torch/mlaas_allocation.py --device cpu
    PYTHONPATH=src python examples/torch/mlaas_allocation.py --trace out.json

Each placement's flow-model goodput is routed on ``--device`` (default
``cuda``) through the flow kernels; the scheduling is plain Python.  The
lines printed are the reference example's on either device.  ``--trace``
records both acts as Chrome trace-event JSON (open it in
https://ui.perfetto.dev).  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
from typing import Callable

from repro_torch.cluster import ClusterScheduler, JobSubmit, NodeFail, NodeRecover, make_job
from repro_torch.core.availability import max_single_allocation
from repro_torch.core.mapping import ParallelismPlan
from repro_torch.core.topology import RailXConfig

N = 16
FAULTS = [(1, 2), (4, 5), (6, 1), (1, 6)]
SERVICE = 10_000.0


def build_trace():
    """Four early node failures, then an over-subscribed heterogeneous job
    mix (the backlog drains as capacity frees), then a failure striking a
    *running* job at t=800 and a repair at t=4000."""
    events = [NodeFail(time=10.0 * (i + 1), node=f) for i, f in enumerate(FAULTS)]
    jid = 0

    def job(arch, plan=None, service=SERVICE):
        nonlocal jid
        j = make_job(jid, arch, plan=plan, service_s=service)
        jid += 1
        return j

    t = 60.0
    mix = []
    mix += [job("paper-llama3-moe")]                                  # 4x16
    mix += [job("qwen3-8b") for _ in range(2)]                         # 2x16
    filler = ParallelismPlan(tp=8, cp=2, ep=1, dp=4, pp=2)             # 2x8
    mix += [job("qwen3-8b", plan=filler) for _ in range(8)]
    mix += [job("llama3.2-3b") for _ in range(6)]                      # 1x8
    mix += [job("gemma3-4b") for _ in range(4)]                        # 2x4
    mix += [job("whisper-large-v3") for _ in range(2)]                 # 1x8
    for i, j in enumerate(mix):
        events.append(JobSubmit(time=t + 5.0 * i, job=j))
    events.append(NodeFail(time=800.0, node=(0, 0)))   # hits a running job
    events.append(NodeRecover(time=4000.0, node=(0, 0)))
    return events


def main(device=None, log_fn: Callable[[str], None] = print):
    """Act one; -> the drained run's ``TimelineMetrics``."""
    cfg = RailXConfig(m=4, n=4, R=64)
    sched = ClusterScheduler(cfg, n=N, policy="best_fit", device=device)

    events = build_trace()
    peak_t = 500.0
    sched.run(events, until=peak_t)

    healthy = sched.healthy_nodes()
    occupied = sched.occupied_nodes()
    single = max_single_allocation(N, FAULTS)
    log_fn(f"{N}x{N} grid, {len(FAULTS)} failed nodes, "
           f"{len(sched.running)} jobs running, {len(sched.backlog)} queued")
    log_fn(sched.render())
    log_fn(f"\nsingle-job baseline (Algorithm 2): {single} nodes "
           f"({single / healthy:.1%} of healthy)")
    log_fn(f"MLaaS multi-job packing at t={peak_t:.0f}: {occupied} nodes "
           f"({occupied / healthy:.1%} of healthy)")
    assert occupied >= single, "multi-job packing fell below single-job baseline"

    metrics = sched.run()  # drain: finishes, failure at t=800, repair, backlog
    log_fn("\nfinal timeline metrics:")
    for k, v in metrics.summary().items():
        log_fn(f"  {k:>22}: {v}")

    log_fn("\nper-job timeline (queueing delay / goodput / recovery events):")
    log_fn(f"  {'job':<28}{'nodes':>6}{'queue_s':>9}{'goodput':>9}"
           f"{'migr':>6}{'shrink':>7}{'reconf_s':>10}")
    for jid, r in sorted(metrics.records.items()):
        q = f"{r.queueing_delay:.0f}" if r.queueing_delay is not None else "-"
        log_fn(f"  {r.job.name:<28}{r.nodes:>6}{q:>9}{r.goodput:>9.3f}"
               f"{r.migrations:>6}{r.shrinks:>7}{r.reconfig_downtime_s:>10.4f}")

    disrupted = [r for r in metrics.records.values()
                 if r.migrations or r.shrinks]
    log_fn(f"\n{len(disrupted)} job(s) rescheduled around failures; every "
           "placement's OCS patch plan was validated against the ring/"
           "all-to-all invariants before programming.")
    return metrics


def policy_demo(device=None, log_fn: Callable[[str], None] = print):
    """Act two: preemption, re-expansion and gang scoring; -> the run's
    ``TimelineMetrics``."""
    cfg = RailXConfig(m=4, n=4, R=64)
    sched = ClusterScheduler(
        cfg, n=N, policy="best_fit",
        preemption=True, gang_scoring=True, re_expansion=True, device=device,
    )
    filler = ParallelismPlan(tp=8, cp=2, ep=1, dp=4, pp=2)     # 2x8 nodes
    big = ParallelismPlan(tp=8, cp=2, ep=1, dp=8, pp=2)        # 2x16 nodes
    events = [
        JobSubmit(time=0.0, job=make_job(0, "qwen3-8b", plan=big,
                                         service_s=30_000.0))
    ]
    # saturate the rest of the grid with best-effort tier-0 jobs
    for i in range(1, 15):
        events.append(JobSubmit(
            time=1.0 + i,
            job=make_job(i, "qwen3-8b", plan=filler, service_s=12_000.0)))
    # a production SLO job arrives on the full grid: preemption territory
    events.append(JobSubmit(
        time=600.0,
        job=make_job(90, "qwen3-8b", plan=filler, service_s=4_000.0,
                     tier=2)))
    sched.run(events, until=700.0)
    m = sched.metrics
    log_fn("\n--- policy engine (preemption / gang / re-expansion) ---")
    log_fn(f"t=700: SLO job queue delay {m.records[90].queueing_delay:.0f} s, "
           f"{m.preemptions} preemption(s), "
           f"{len(sched.backlog)} checkpoint-evicted job(s) requeued")

    # a failure inside job 0's rectangle forces an elastic shrink (the
    # grid is too full to migrate); the repair lets re-expansion restore
    # the original dp degree
    rect = sched.running[0].alloc
    target = (rect.rows[0], rect.cols[0])
    sched.run([NodeFail(time=800.0, node=target)], until=900.0)
    r0 = m.records[0]
    log_fn(f"t=900: failure at {target} -> job 0 shrank x{r0.shrinks} "
           f"to {r0.nodes} nodes (plan dp={r0.job.plan.dp})")
    sched.run([NodeRecover(time=5_000.0, node=target)])
    log_fn(f"drained: job 0 expanded x{r0.expansions} back to "
           f"{r0.nodes} nodes (plan dp={r0.job.plan.dp}), "
           f"finished at t={r0.finish_t:.0f}")
    ps = m.policy_summary()
    log_fn(f"policy summary: {ps['preemptions']} preemptions, "
           f"{ps['expansions']} expansions, "
           f"queue delay by tier {ps['queue_delay_by_tier']}")
    assert m.records[90].queueing_delay == 0.0
    assert r0.expansions >= 1 and r0.job.plan == big
    return m


def run(device=None, log_fn: Callable[[str], None] = print, trace=None):
    """Both acts on ``device``, under a tracer written to ``trace`` if one
    is given; -> (act one's metrics, act two's)."""
    if not trace:
        return main(device, log_fn), policy_demo(device, log_fn)
    from repro_torch.obs import Tracer, tracing

    tracer = Tracer(process="mlaas-allocation")
    with tracing(tracer):
        out = main(device, log_fn), policy_demo(device, log_fn)
    tracer.write(trace)
    log_fn(f"\nwrote trace {trace}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where each placement's goodput is routed (default: cuda)")
    ap.add_argument(
        "--trace", metavar="OUT.json", default=None,
        help="record a Chrome trace-event JSON of both acts "
             "(open in https://ui.perfetto.dev)",
    )
    args = ap.parse_args()
    run(args.device, trace=args.trace)
