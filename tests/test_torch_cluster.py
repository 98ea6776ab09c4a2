"""The port's MLaaS cluster twin (``repro_torch.cluster``) against the
reference's, at equality: the flow-model goodput on all four fabrics with a
``job_network``, and whole scheduler runs — bench_cluster's ``run_grid``
setup at 16 x 16 and 32 x 32 (loop and full), its four ``policy_sweep``
configs, a ``bench_chaos`` scenario with ``TXN_INJECTION``, and
bench_serving's ``run_mixed`` fixed and autoscale at the reference's chip —
each with its summary, per-job records (unrounded goodputs included) and
side summaries equal.  The port runs with ``device="cpu"``, where the flow
kernels' plain versions route; ``chip_smoke.py``'s cluster phase holds the
card to the same runs.  The port's side of ``run_grid`` and ``run_mixed`` is
``chip_smoke.py``'s own setup (``cluster_day``, ``serving_day``)."""

import dataclasses
import importlib.util
import itertools
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.cluster as ref_cluster  # noqa: E402
from repro.core import availability as ref_avail, topology as ref_topo  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.obs import Tracer as RefTracer, tracing as ref_tracing  # noqa: E402
import repro_torch.cluster as cluster  # noqa: E402
from repro_torch.core import availability, compiled_flow as cf, topology  # noqa: E402
from repro_torch.core.mapping import ParallelismPlan  # noqa: E402
from repro_torch.obs import Tracer, tracing, validate_trace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, HERE)
from test_torch_cluster_parts import plain, same  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
import bench_chaos  # noqa: E402
import bench_cluster  # noqa: E402
import bench_serving  # noqa: E402

sys.path.remove(os.path.join(ROOT, "benchmarks"))

FABRICS = ("railx-hyperx", "torus-2d", "torus-3d", "rail-only")
REFERENCE_CHIP = dict(peak_flops=ref_roofline.PEAK_FLOPS, hbm_bw=ref_roofline.HBM_BW,
                      link_bw=ref_roofline.ICI_BW)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _chip_smoke()


def _same_run(port, ref):
    """Two finished schedulers: summaries, every job record (segments and
    unrounded goodputs), mean goodput and the side summaries equal."""
    pm, rm = port.metrics, ref.metrics
    assert pm.summary() == rm.summary()
    same(pm.records, rm.records)
    assert pm.mean_goodput() == rm.mean_goodput()
    assert pm.policy_summary() == rm.policy_summary()
    assert pm.survivability_summary() == rm.survivability_summary()
    assert pm.serving_summary() == rm.serving_summary()
    same(port.running, ref.running)
    same(list(port.backlog), list(ref.backlog))
    assert port.circuits == ref.circuits


# -- the goodput --------------------------------------------------------------


# (arch, plan, R, max_flow_nodes); the last two are trimmed to a
# representative sub-rectangle before routing, as a job over 512 nodes is
GOODPUT_JOBS = [
    ("qwen3-8b", None, 64, 512),
    ("paper-llama3-moe", None, 64, 512),
    ("llama3.2-3b", None, 64, 512),
    ("whisper-large-v3", None, 32, 512),
    ("gemma3-4b", None, 32, 512),
    ("paper-llama3-moe", None, 64, 40),
    ("qwen3-8b", ParallelismPlan(tp=16, cp=1, ep=1, dp=8, pp=16), 64, 64),
]


@pytest.mark.parametrize("fabric", FABRICS)
def test_goodput_matches_the_reference_on_every_fabric(fabric):
    """``estimate_goodput`` on the CPU: the reference's float bit for bit,
    from a job network equal to the reference's (vertices, adjacency order,
    capacities), for jobs on an offset rectangle and one over the trim."""
    from repro.arch import get as ref_get
    from repro_torch.arch import get

    for arch, plan, R, cap in GOODPUT_JOBS:
        cfg, rcfg = topology.RailXConfig(m=4, n=4, R=R), ref_topo.RailXConfig(m=4, n=4, R=R)
        job = cluster.make_job(0, arch, plan=plan)
        rjob = ref_cluster.make_job(0, arch, plan=plan)
        jm, rjm = cluster.plan_job_mapping(cfg, job), ref_cluster.plan_job_mapping(rcfg, rjob)
        off = 1 if jm.rows_req < R // 2 else 0
        rows, cols = tuple(range(off, off + jm.rows_req)), tuple(range(jm.cols_req))
        alloc, ralloc = availability.JobAllocation(rows, cols), ref_avail.JobAllocation(rows, cols)
        net = get(fabric).job_network(cfg, jm.mapping, alloc)
        rnet = ref_get(fabric).job_network(rcfg, rjm.mapping, ralloc)
        assert dict(net.adj) == dict(rnet.adj) and net.capacity == rnet.capacity
        got = cluster.estimate_goodput(cfg, job, jm.mapping, alloc, fabric=fabric,
                                       max_flow_nodes=cap, device="cpu")
        want = ref_cluster.estimate_goodput(rcfg, rjob, rjm.mapping, ralloc, fabric=fabric,
                                            max_flow_nodes=cap)
        assert got == want and 0 < got <= 1, (arch, plan, got, want)
        if cap < 512:
            continue
        cache = cluster.GoodputCache(cfg, fabric=fabric, device="cpu")
        assert cache.goodput_for(job, jm.mapping, alloc) == want
        assert cache.goodput_for(job, jm.mapping, alloc) == want
        assert (cache.hits, cache.misses) == (1, 1)


def test_a_failed_routing_is_raised_not_routed_elsewhere(monkeypatch):
    """No fallback: a failure inside the flow kernels' wrappers reaches the
    caller of the scheduler."""
    from repro_torch.kernels.flow import flow

    def broken(*args, **kw):
        raise RuntimeError("ordered_fold failed")

    monkeypatch.setattr(flow, "ordered_fold", broken)
    cfg = topology.RailXConfig(m=4, n=4, R=32)
    sched = cluster.ClusterScheduler(cfg, n=16, device="cpu")
    with pytest.raises(RuntimeError, match="ordered_fold failed"):
        sched.run([cluster.JobSubmit(time=0.0, job=cluster.make_job(0, "qwen3-8b"))])


def test_the_scheduler_resolves_its_device_once():
    """The card unless the caller passes ``"cpu"``; no card is an error."""
    cfg = topology.RailXConfig(m=4, n=4, R=32)
    sched = cluster.ClusterScheduler(cfg, n=16, device="cpu")
    assert sched.device == torch.device("cpu") == sched._goodput_cache.device
    if torch.cuda.is_available():
        assert cluster.ClusterScheduler(cfg, n=16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cluster.ClusterScheduler(cfg, n=16)


# -- whole runs ---------------------------------------------------------------


def _ref_day(side, full):
    """bench_cluster's ``run_grid(side, full)`` on the reference, keeping
    the scheduler."""
    cfg = ref_topo.RailXConfig(m=4, n=4, R=2 * side)
    sched = ref_cluster.ClusterScheduler(cfg, n=side, policy="best_fit",
                                         goodput_model="flow" if full else "none",
                                         validate_circuits=full)
    sched.enqueue(itertools.chain(
        ref_cluster.iter_poisson_trace(seed=1234, duration_s=24 * 3600.0,
                                       arrival_rate_per_h=12.0, mean_service_s=2 * 3600.0),
        ref_cluster.iter_failure_trace(n=side, seed=1234, duration_s=24 * 3600.0,
                                       mtbf_node_s=5e6 * side / 32, mttr_s=1800.0)))
    sched.run()
    return sched


@pytest.mark.parametrize("full", [False, True], ids=["loop", "full"])
@pytest.mark.parametrize("side", [16, 32])
def test_run_grid_matches_the_reference(side, full):
    port, _ = SMOKE.cluster_day(side, full, "cpu")
    ref = _ref_day(side, full)
    _same_run(port, ref)
    row = bench_cluster.run_grid(side, full) if (side, full) == (16, True) else None
    if row is not None:        # the setup is the benchmark's own
        s = port.metrics.summary()
        assert {k: row[k] for k in s if k in row} == {k: s[k] for k in s if k in row}


def test_cluster_day_constants_are_bench_cluster_json_s_row():
    import json

    with open(os.path.join(ROOT, "BENCH_cluster.json")) as f:
        rows = json.load(f)["rows"]
    row = next(r for r in rows if r["grid"] == f"{SMOKE.CLUSTER_SIDE}x{SMOKE.CLUSTER_SIDE}"
               and r["mode"] == "full")
    assert SMOKE.CLUSTER_DAY == {k: row[k] for k in SMOKE.CLUSTER_DAY}
    assert set(row) - set(SMOKE.CLUSTER_DAY) == {"grid", "mode", "wall_s", "events_per_sec"}


def _policy_runs(C, T, duration_h=8.0, side=16, seed=1234, **kw):
    """bench_cluster's ``policy_sweep`` configs on ``C``'s scheduler, over
    a shortened horizon."""
    duration = duration_h * 3600.0
    events = list(itertools.chain(
        C.iter_poisson_trace(seed=seed, duration_s=duration, arrival_rate_per_h=24.0,
                             mean_service_s=2 * 3600.0, tier_weights=(8, 2, 1)),
        C.iter_failure_trace(n=side, seed=seed, duration_s=duration,
                             mtbf_node_s=2e5, mttr_s=4 * 3600.0)))
    out = []
    for name, opts, strip in bench_cluster.POLICY_CONFIGS:
        evs = events
        if strip:
            evs = [dataclasses.replace(ev, job=dataclasses.replace(ev.job, tier=0))
                   if hasattr(ev, "job") else ev for ev in events]
        sched = C.ClusterScheduler(T.RailXConfig(m=4, n=4, R=2 * side), n=side,
                                   policy="best_fit", goodput_model="flow",
                                   validate_circuits=False, **opts, **kw)
        sched.run(evs, until=duration)
        out.append(sched)
    return out


def test_capped_miss_constant_is_the_references_goodput():
    """``chip_smoke.py``'s capped miss (qwen3-8b at tp 16, dp 32, pp 32 on
    32 x 32 nodes, trimmed to 512) holds the card to ``CLUSTER_MISS``: the
    reference's float, which the port gives on the CPU routing its 1,024
    sources in one forest (ROADMAP Queue 2 item 15)."""
    from repro.core.mapping import ParallelismPlan as RefPlan

    plan = dict(tp=16, cp=1, ep=1, dp=32, pp=32)
    cfg, rcfg = topology.RailXConfig(m=4, n=4, R=64), ref_topo.RailXConfig(m=4, n=4, R=64)
    job = cluster.make_job(0, "qwen3-8b", plan=ParallelismPlan(**plan))
    rjob = ref_cluster.make_job(0, "qwen3-8b", plan=RefPlan(**plan))
    jm, rjm = cluster.plan_job_mapping(cfg, job), ref_cluster.plan_job_mapping(rcfg, rjob)
    rows, cols = tuple(range(jm.rows_req)), tuple(range(jm.cols_req))
    want = ref_cluster.estimate_goodput(rcfg, rjob, rjm.mapping,
                                        ref_avail.JobAllocation(rows, cols))
    assert want == SMOKE.CLUSTER_MISS
    assert cluster.estimate_goodput(cfg, job, jm.mapping, availability.JobAllocation(rows, cols),
                                    device="cpu") == want


def test_policy_sweep_configs_match_the_reference():
    runs = _policy_runs(cluster, topology, device="cpu")
    refs = _policy_runs(ref_cluster, ref_topo)
    for port, ref in zip(runs, refs):
        _same_run(port, ref)
    assert any(r.metrics.preemptions for r in runs) and any(r.metrics.expansions for r in runs)


def _chaos(C, T, name="switch_heavy", **kw):
    """One ``bench_chaos`` scenario, 16 x 16, 12 jobs at full-footprint
    ``min_nodes``, with ``TXN_INJECTION`` and partial migration on."""
    fault_kwargs = dict(bench_chaos.SCENARIOS)[name]
    cfg = T.RailXConfig(m=4, n=4, R=2 * bench_chaos.SIDE)
    footprint = C.plan_job_mapping(cfg, C.make_job(0, bench_chaos.JOB_ARCH)).nodes
    events = [C.JobSubmit(time=i * 300.0, job=C.make_job(
        i, bench_chaos.JOB_ARCH, service_s=(1.0 + (i % 3)) * 3600.0, min_nodes=footprint))
        for i in range(12)]
    events += list(C.iter_fault_domain_trace(
        n=bench_chaos.SIDE, rails=cfg.r, seed=bench_chaos.SEED, duration_s=8 * 3600.0,
        emit_horizon_recoveries=True, **fault_kwargs))
    sched = C.ClusterScheduler(
        cfg, n=bench_chaos.SIDE, policy="best_fit", goodput_model="flow",
        validate_circuits=False, circuit_repair=True, partial_migration=True,
        ocs_txn=C.TxnConfig(**bench_chaos.TXN_INJECTION), checkpoint_interval_s=900.0,
        quarantine=C.QuarantineConfig(threshold=3, base_s=1800.0, factor=2.0), **kw)
    sched.run(events)
    return sched


@pytest.mark.parametrize("scenario", ["switch_heavy", "link_flaky"])
def test_chaos_scenario_with_txn_injection_matches_the_reference(scenario):
    port = _chaos(cluster, topology, scenario, device="cpu")
    ref = _chaos(ref_cluster, ref_topo, scenario)
    _same_run(port, ref)
    sv = port.metrics.survivability_summary()
    assert sv["txn_commits"] and sv["txn_retries"], sv


def _ref_mixed(fabric, autoscale, duration_s, jobs):
    """bench_serving's ``run_mixed`` on the reference, keeping the
    scheduler; -> (scheduler, its fingerprint)."""
    import json

    cfg = ref_topo.RailXConfig(m=4, n=4, R=2 * bench_serving.SIDE)
    services, _ = bench_serving.serving_services()
    sched = ref_cluster.ClusterScheduler(
        cfg, n=bench_serving.SIDE, policy="best_fit", goodput_model="flow",
        validate_circuits=False, fabric=fabric, checkpoint_interval_s=900.0,
        serving=ref_cluster.ServingConfig(services=services, autoscale=autoscale,
                                          preempt_training=autoscale,
                                          headroom_nodes=4 if autoscale else 0))
    m = sched.run(bench_serving._events(cfg, duration_s, jobs))
    srv = sched.serving_summary(until=duration_s)
    return sched, json.dumps({"summary": m.summary(), "serving": srv}, sort_keys=True)


def test_run_mixed_at_the_references_chip_matches_the_reference():
    """Fixed and autoscale on railx-hyperx (bench_serving --smoke's 8 h, 6
    jobs), the port's service model given the reference's chip rates: the
    same fingerprint as ``bench_serving.run_mixed``, the same schedulers, and
    autoscale beating fixed on SLO attainment as the reference's smoke
    asserts."""
    duration, jobs = 8 * 3600.0, 6
    att = {}
    for autoscale in (False, True):
        port, fp, srv, _ = SMOKE.serving_day("railx-hyperx", autoscale, "cpu", duration, jobs,
                                             chip=REFERENCE_CHIP)
        ref, ref_fp = _ref_mixed("railx-hyperx", autoscale, duration, jobs)
        _, bench_fp = bench_serving.run_mixed("railx-hyperx", autoscale=autoscale,
                                              duration_s=duration, jobs=jobs)
        assert fp == ref_fp == bench_fp
        _same_run(port, ref)
        assert port.serving_summary(until=duration) == ref.serving_summary(until=duration)
        att[autoscale] = srv["slo_attainment"]
    assert att[True] > att[False]


def test_run_mixed_at_the_h100_differs_only_in_the_service_model():
    """By default the service model is an H100's: the training side of the
    day is the reference's, the serving figures are the card's own."""
    duration, jobs = 8 * 3600.0, 6
    port, _, srv, _ = SMOKE.serving_day("railx-hyperx", True, "cpu", duration, jobs)
    ref, _ = _ref_mixed("railx-hyperx", True, duration, jobs)
    st = port.services[0].model
    assert (st.peak_flops, st.hbm_bw, st.link_bw) == (989e12, 3.35e12, 50e9)
    assert srv != ref.serving_summary(until=duration)


# -- tracing ------------------------------------------------------------------


def _twin():
    spec = importlib.util.spec_from_file_location(
        "torch_example_mlaas", os.path.join(ROOT, "examples", "torch", "mlaas_allocation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_example_mlaas", os.path.join(ROOT, "examples", "mlaas_allocation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_traced_run_emits_the_references_spans(tmp_path):
    """The MLaaS twin's two acts and a chaos scenario under the port's
    tracer emit the reference's events in its order (phases, names,
    categories, arguments; times aside), in a trace that validates."""
    import contextlib
    import io

    tracer = Tracer(process="mlaas-allocation")
    with tracing(tracer):
        _twin().run("cpu", lambda line: None)
        _chaos(cluster, topology, "switch_heavy", device="cpu")
    ref_tracer = RefTracer(process="mlaas-allocation")
    with ref_tracing(ref_tracer), contextlib.redirect_stdout(io.StringIO()):
        ex = _reference_example()
        ex.main()
        ex.policy_demo()
        _chaos(ref_cluster, ref_topo, "switch_heavy")

    def events(t):
        """(phase, name, category, arguments) of every event but the
        metadata."""
        return [(e["ph"], e["name"], e.get("cat"), e.get("args")) for e in t.events
                if e["ph"] != "M"]

    def in_forests(evs):
        """The reference's events with the per-source ``flow.bfs`` spans of
        each single-path ``flow.route`` grouped as the port routes them, in
        forests of ``ROUTE_KEYS // n`` sources, one span a forest whose
        ``sources`` is its size (ROADMAP Queue 2 item 15)."""
        out, i = [], 0
        while i < len(evs):
            out.append(evs[i])
            i += 1
            if out[-1][:2] != ("B", "flow.route") or out[-1][3]["num_paths"] > 1:
                continue
            spans = []
            while evs[i][:2] == ("B", "flow.bfs") and evs[i + 1][:2] == ("E", "flow.bfs"):
                assert evs[i][3]["sources"] == 1
                spans.append(evs[i:i + 2])
                i += 2
            per = max(1, cf.ROUTE_KEYS // spans[0][0][3]["vertices"]) if spans else 1
            for lo in range(0, len(spans), per):
                (ph, name, cat, args), end = spans[lo]
                out += [(ph, name, cat, {**args, "sources": len(spans[lo:lo + per])}), end]
        return out

    assert events(tracer) == in_forests(events(ref_tracer))
    assert tracer.span_names() == ref_tracer.span_names()
    assert {"goodput.estimate", "placement.attempt", "ocs.txn_apply", "fault.repair",
            "event.SwitchFail"} <= tracer.span_names()
    validate_trace(tracer.to_dict())
    out = tmp_path / "t.json"
    _twin().run("cpu", lambda line: None, trace=str(out))
    assert validate_trace(__import__("json").loads(out.read_text()))["spans"] > 0
