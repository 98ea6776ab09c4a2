"""The port's cluster parts (``repro_torch.core.availability`` and the plain
Python modules of ``repro_torch.cluster``) against the reference's, at
equality: Algorithm 2 and the MLaaS allocators, the bitmask placement
policies (and their frozenset oracles) on seeded fault and occupancy grids,
circuit synthesis, diffs and patch plans, degraded synthesis, the serving
queue and service model at the reference's chip, and every trace generator
event by event.  Floats compare with ``==``; values of the two packages'
dataclasses compare field by field (``plain``)."""

import dataclasses
import itertools
import math
import random

import pytest

pytest.importorskip("torch")

from repro.cluster import (  # noqa: E402
    faults as ref_faults, jobs as ref_jobs, occupancy as ref_occ, placement as ref_place,
    reconfig as ref_reconfig, serving as ref_serving, serving_traces as ref_st,
    trace as ref_trace,
)
from repro.configs.registry import ALL_CONFIGS  # noqa: E402
from repro.core import availability as ref_avail, topology as ref_topo  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.cluster import (  # noqa: E402
    backlog, faults, jobs, occupancy, placement, reconfig, serving, serving_traces, trace,
)
from repro_torch.core import availability, topology  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402


def plain(x):
    """Values of either package as plain data: a dataclass as its class name
    and fields, sets sorted, sequences as lists, so that the two packages'
    values compare with ``==`` (floats bit for bit)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {plain(k) if isinstance(k, tuple) else k: plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    return x


def same(got, want):
    assert plain(got) == plain(want)


# -- core/availability --------------------------------------------------------


def _fault_sets(n, seed, count=40):
    """Seeded fault sets: sparse, clustered in a few lines, and duplicated."""
    rng = random.Random(seed)
    out = []
    for i in range(count):
        k = rng.randrange(0, 2 * n)
        if i % 3 == 0:       # clustered: a few rows and columns
            rows, cols = rng.sample(range(n), 3), rng.sample(range(n), 3)
            out.append([(rng.choice(rows), rng.choice(cols)) for _ in range(min(k, 12))])
        else:
            out.append([(rng.randrange(n), rng.randrange(n)) for _ in range(min(k, 10))])
    out[-1] = out[-1] + out[-1][:2]
    return out


@pytest.mark.parametrize("n", [8, 16, 32])
def test_algorithm2_and_the_bounds_match_the_reference(n):
    for faults_ in _fault_sets(n, n):
        assert availability._classify(n, faults_) == ref_avail._classify(n, faults_)
        if len(ref_avail._classify(n, list(dict.fromkeys(faults_)))[1]) <= 12:
            assert availability.max_single_allocation(n, faults_) == \
                ref_avail.max_single_allocation(n, faults_)
        k = len(faults_)
        assert availability.worst_case_allocation(n, k) == ref_avail.worst_case_allocation(n, k)
        assert availability.best_case_allocation(n, k) == ref_avail.best_case_allocation(n, k)


@pytest.mark.parametrize("n,seed", [(8, 0), (16, 7)])
def test_availability_curve_matches_the_reference(n, seed):
    rates = (0.0, 0.005, 0.02, 0.1)
    assert availability.availability_curve(n, rates, samples=12, seed=seed) == \
        ref_avail.availability_curve(n, rates, samples=12, seed=seed)


@pytest.mark.parametrize("n", [16, 32])
def test_multi_job_allocators_match_the_reference(n):
    for faults_ in _fault_sets(n, 100 + n, count=12):
        got = availability.allocate_multi_jobs(n, faults_)
        same(got, ref_avail.allocate_multi_jobs(n, faults_))
        same(availability.allocate_multi_jobs_ref(n, faults_), got)
        assert availability.utilization(n, faults_, got) == \
            ref_avail.utilization(n, faults_, ref_avail.allocate_multi_jobs(n, faults_))
    mask = random.Random(n).getrandbits(n)
    assert list(availability.iter_bits(mask)) == list(ref_avail.iter_bits(mask))
    assert availability.lowest_bits(mask, 5) == ref_avail.lowest_bits(mask, 5)
    assert availability.mask_of([0, 3, 9]) == ref_avail.mask_of([0, 3, 9])


# -- jobs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ALL_CONFIGS))
def test_job_mapping_and_volumes_match_the_reference(arch):
    """Every registry arch: its Table-4 model spec, default train / serve
    plans, the §5 footprint on a RailX of 16 x 16 nodes and the per-dim
    volumes."""
    from repro_torch.configs.registry import get_config
    from repro.configs.registry import get_config as ref_get_config

    same(jobs.model_spec_from_config(get_config(arch)),
         ref_jobs.model_spec_from_config(ref_get_config(arch)))
    same(jobs.default_plan(arch), ref_jobs.default_plan(arch))
    same(jobs.default_serve_plan(arch), ref_jobs.default_serve_plan(arch))
    job, ref_job = jobs.make_job(3, arch, service_s=77.0), ref_jobs.make_job(3, arch, service_s=77.0)
    same(job, ref_job)
    assert jobs.job_comm_volumes(job) == ref_jobs.job_comm_volumes(ref_job)
    try:
        want = ref_jobs.plan_job_mapping(ref_topo.RailXConfig(m=4, n=4, R=32), ref_job)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            jobs.plan_job_mapping(topology.RailXConfig(m=4, n=4, R=32), job)
        return
    same(jobs.plan_job_mapping(topology.RailXConfig(m=4, n=4, R=32), job), want)


def test_tiered_backlog_keeps_the_references_order():
    from repro.cluster.backlog import TieredBacklog as RefBacklog

    ours, ref = backlog.TieredBacklog(), RefBacklog()
    rng = random.Random(5)
    for i in range(40):
        tier = rng.randrange(3)
        op = rng.random()
        for b, mod in ((ours, jobs), (ref, ref_jobs)):
            j = mod.make_job(i, "qwen3-8b", tier=tier)
            (b.push_front if op < 0.3 else b.push)(j)
        if op > 0.8:
            for b in (ours, ref):
                b.remove(next(iter(b)))
        same(list(ours), list(ref))
        assert (len(ours), ours.tiers()) == (len(ref), ref.tiers())


# -- occupancy and placement --------------------------------------------------


def _grid(n, seed):
    """A seeded free set: faults, a few placed rectangles, and noise."""
    rng = random.Random(seed)
    taken = set()
    for _ in range(rng.randrange(0, 4)):
        rows = rng.sample(range(n), rng.randrange(1, n // 2))
        cols = rng.sample(range(n), rng.randrange(1, n // 2))
        taken |= {(r, c) for r in rows for c in cols}
    taken |= {(rng.randrange(n), rng.randrange(n)) for _ in range(rng.randrange(0, 3 * n))}
    return {(r, c) for r in range(n) for c in range(n)} - taken


SHAPES = [(1, 1), (1, 4), (2, 8), (4, 4), (2, 16), (4, 16), (8, 2), (3, 5), (8, 12), (12, 14),
          (16, 16), (30, 30)]


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("policy", sorted(placement.POLICIES))
def test_placement_policies_match_the_reference_and_their_oracles(n, policy):
    for seed in range(12):
        free = _grid(n, 1000 * n + seed)
        occ, ref = occupancy.OccupancyIndex.from_free_set(n, free), \
            ref_occ.OccupancyIndex.from_free_set(n, free)
        assert occ.free_set() == free == ref.free_set()
        for rows, cols in SHAPES:
            assert occ.can_fit(rows, cols) == ref.can_fit(rows, cols)
            got = placement.POLICIES[policy](n, occ, rows, cols)
            same(got, ref_place.POLICIES[policy](n, ref, rows, cols))
            same(placement.REFERENCE_POLICIES[policy](n, set(free), rows, cols), got)


@pytest.mark.parametrize("n", [16, 32])
def test_gang_scoring_and_partial_refit_match_the_reference(n):
    for seed in range(8):
        free = _grid(n, 7000 + seed)
        rng = random.Random(seed)
        rw = {r: rng.randrange(4) for r in rng.sample(range(n), n // 3)}
        cw = {c: rng.randrange(4) for c in rng.sample(range(n), n // 3)}
        occ, ref = occupancy.OccupancyIndex.from_free_set(n, free), \
            ref_occ.OccupancyIndex.from_free_set(n, free)
        for rows, cols in SHAPES:
            got = placement.gang_scored_fit(n, occ, rows, cols, rw, cw)
            same(got, ref_place.gang_scored_fit(n, ref, rows, cols, rw, cw))
            if got is None:
                continue
            occ.occupy(got.rows, got.cols)
            ref.occupy(got.rows, got.cols)
            bad_r = frozenset(got.rows[:1])
            bad_c = frozenset(got.cols[-1:]) if seed % 2 else frozenset()
            p = placement.partial_refit(n, occ, got, bad_r, bad_c)
            same(p, ref_place.partial_refit(
                n, ref, ref_avail.JobAllocation(got.rows, got.cols), bad_r, bad_c))
            assert occ.version == ref.version and occ.free_count == ref.free_count


# -- reconfig -----------------------------------------------------------------


def _placed(cfg_mod, jobs_mod, avail_mod, arch, plan=None, offset=0):
    cfg = cfg_mod.RailXConfig(m=4, n=4, R=64)
    job = jobs_mod.make_job(0, arch, plan=plan)
    jm = jobs_mod.plan_job_mapping(cfg, job)
    alloc = avail_mod.JobAllocation(
        tuple(range(offset, offset + jm.rows_req)),
        tuple(range(2 * offset, 2 * offset + jm.cols_req)))
    return cfg, job, jm, alloc


RECONFIG_JOBS = [("qwen3-8b", None, 0), ("paper-llama3-moe", None, 3), ("llama3.2-3b", None, 5),
                 ("gemma3-4b", None, 1), ("whisper-large-v3", None, 9)]


@pytest.mark.parametrize("arch,plan,offset", RECONFIG_JOBS, ids=[j[0] for j in RECONFIG_JOBS])
def test_circuit_targets_diffs_and_plans_match_the_reference(arch, plan, offset):
    cfg, job, jm, alloc = _placed(topology, jobs, availability, arch, plan, offset)
    rcfg, _, rjm, ralloc = _placed(ref_topo, ref_jobs, ref_avail, arch, plan, offset)
    target = reconfig.job_target_circuits(cfg, jm.mapping, alloc)
    rtarget = ref_reconfig.job_target_circuits(rcfg, rjm.mapping, ralloc)
    same(target, rtarget)
    same(reconfig.validate_job_reconfig(cfg, jm.mapping, alloc),
         ref_reconfig.validate_job_reconfig(rcfg, rjm.mapping, ralloc))
    # a second job's target beside it, a diff between them and back
    _, _, jm2, alloc2 = _placed(topology, jobs, availability, "llama3.2-3b", None, offset + 2)
    _, _, rjm2, ralloc2 = _placed(ref_topo, ref_jobs, ref_avail, "llama3.2-3b", None, offset + 2)
    other = reconfig.job_target_circuits(cfg, jm2.mapping, alloc2)
    rother = ref_reconfig.job_target_circuits(rcfg, rjm2.mapping, ralloc2)
    for cur, tgt, rcur, rtgt in (({}, target, {}, rtarget), (target, other, rtarget, rother)):
        plan_ = reconfig.diff_circuits(cur, tgt)
        rplan = ref_reconfig.diff_circuits(rcur, rtgt)
        same(plan_, rplan)
        assert (plan_.circuits_flipped, plan_.switches_touched) == \
            (rplan.circuits_flipped, rplan.switches_touched)
        assert reconfig.ReconfigCostModel().downtime(plan_) == \
            ref_reconfig.ReconfigCostModel().downtime(rplan)
        applied = reconfig.apply_plan(cur, plan_)
        same(applied, ref_reconfig.apply_plan(rcur, rplan))
        assert {k: v for k, v in applied.items() if v} == {k: v for k, v in tgt.items() if v}
        same(reconfig.apply_plan(applied, plan_.inverted()),
             ref_reconfig.apply_plan(ref_reconfig.apply_plan(rcur, rplan), rplan.inverted()))
        keys = sorted(tgt)[::2]
        same(reconfig.diff_circuits(cur, tgt, keys), ref_reconfig.diff_circuits(rcur, rtgt, keys))
    same(reconfig.merge_circuits(target, other), ref_reconfig.merge_circuits(rtarget, rother))
    same(reconfig.canonical_allocation(alloc), ref_reconfig.canonical_allocation(ralloc))
    cache = reconfig.CircuitShapeCache(cfg, validate=True)
    rcache = ref_reconfig.CircuitShapeCache(rcfg, validate=True)
    moved = availability.JobAllocation(tuple(r + 1 for r in alloc.rows),
                                       tuple(c + 1 for c in alloc.cols))
    rmoved = ref_avail.JobAllocation(moved.rows, moved.cols)
    for a, ra in ((alloc, ralloc), (moved, rmoved), (alloc, ralloc)):
        same(cache.target_for(jm.mapping, a), rcache.target_for(rjm.mapping, ra))
    assert (cache.hits, cache.misses) == (rcache.hits, rcache.misses)


# -- faults -------------------------------------------------------------------


@pytest.mark.parametrize("arch,plan,offset", RECONFIG_JOBS, ids=[j[0] for j in RECONFIG_JOBS])
def test_degraded_synthesis_and_irreparable_lines_match_the_reference(arch, plan, offset):
    cfg, job, jm, alloc = _placed(topology, jobs, availability, arch, plan, offset)
    rcfg, _, rjm, ralloc = _placed(ref_topo, ref_jobs, ref_avail, arch, plan, offset)
    target = reconfig.job_target_circuits(cfg, jm.mapping, alloc)
    switches = sorted(target)
    rng = random.Random(len(switches))
    cases = [(frozenset(), frozenset())]
    for i in range(10):
        sw = frozenset(rng.sample(switches, min(len(switches), i % 4)))
        links = frozenset(
            ((rng.choice(alloc.rows), rng.choice(alloc.cols)), rng.choice("XY"),
             rng.randrange(cfg.r)) for _ in range(i % 3))
        cases.append((sw, links))
    for sw, links in cases:
        got = faults.synthesize_degraded(cfg, jm.mapping, alloc, sw, links)
        same(got, ref_faults.synthesize_degraded(rcfg, rjm.mapping, ralloc, sw, links))
        same(faults.irreparable_lines(cfg, jm.mapping, alloc, sw, links),
             ref_faults.irreparable_lines(rcfg, rjm.mapping, ralloc, sw, links))
        assert faults.faults_hit_target(target, sw, links) == \
            ref_faults.faults_hit_target(target, sw, links)
        for link in links:
            assert faults.link_hits_circuits(link, target) == \
                ref_faults.link_hits_circuits(link, target)
    ours, ref = faults.FlapTracker(faults.QuarantineConfig(2, 60.0, 3.0)), \
        ref_faults.FlapTracker(ref_faults.QuarantineConfig(2, 60.0, 3.0))
    for e in [1, 2, 1, 1, 3, 1, 2]:
        assert ours.record_fail(e) == ref.record_fail(e)
        assert ours.quarantine_s(e) == ref.quarantine_s(e)


# -- serving ------------------------------------------------------------------


def test_the_queue_figures_match_the_reference():
    for c in (1, 2, 3, 8, 17, 64):
        for a in (0.0, 0.3, 0.99 * c, 0.5 * c, c, 1.5 * c):
            assert serving.erlang_c(c, a) == ref_serving.erlang_c(c, a)
            mu = 2.5
            lam = a * mu
            if lam < c * mu:
                assert serving.mmc_wait_profile(lam, mu, c) == \
                    ref_serving.mmc_wait_profile(lam, mu, c)
            for slo in (0.1, 0.5, 2.0):
                assert serving.slo_attainment(lam, mu, c, slo) == \
                    ref_serving.slo_attainment(lam, mu, c, slo)
    with pytest.raises(ValueError, match="at least one server"):
        serving.erlang_c(0, 1.0)


REFERENCE_CHIP = dict(peak_flops=ref_roofline.PEAK_FLOPS, hbm_bw=ref_roofline.HBM_BW,
                      link_bw=ref_roofline.ICI_BW)


@pytest.mark.parametrize("arch", ["qwen3-8b", "llama3.2-3b", "paper-llama3-moe",
                                  "qwen3-moe-235b-a22b", "gemma3-4b"])
def test_service_model_at_the_references_chip_matches_the_reference(arch):
    """Given the reference's chip rates (imported from ``repro.launch.roofline``,
    never written in the port), the port's service model prices decode as the
    reference's; by default it prices an H100 (``launch/roofline.py``)."""
    spec = serving.make_service(0, arch, batch_size=4)
    rspec = ref_serving.make_service(0, arch, batch_size=4)
    same(spec, rspec)
    model = serving.ServiceModel.for_spec(spec, **REFERENCE_CHIP)
    rmodel = ref_serving.ServiceModel.for_spec(rspec)
    assert serving.INTRA_NODE_K == ref_roofline.INTRA_NODE_K
    for factor in (1.0, 0.75, 0.5):
        for ctx in (128.0, 4096.0):
            assert model.decode_step_s(4, ctx, factor) == rmodel.decode_step_s(4, ctx, factor)
            assert model.tokens_per_s(8, ctx, factor) == rmodel.tokens_per_s(8, ctx, factor)
        assert model.kv_stream_s(1024.0, factor) == rmodel.kv_stream_s(1024.0, factor)
        assert model.request_service_s(spec, factor) == rmodel.request_service_s(rspec, factor)
        rate = model.replica_rate_rps(spec, factor)
        assert rate == rmodel.replica_rate_rps(rspec, factor)
        for rps in (0.0, rate, 3.3 * rate):
            assert serving.desired_replicas(spec, rps, rate, 0.7) == \
                ref_serving.desired_replicas(rspec, rps, rate, 0.7)
    h100 = serving.ServiceModel.for_spec(spec)
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == \
        (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NIC_BW)
    assert serving.ServingConfig(**REFERENCE_CHIP).model_for(spec) == model
    assert serving.ServingConfig().model_for(spec) == h100
    assert h100.decode_step_s(4, 1024.0) != model.decode_step_s(4, 1024.0)


# -- traces -------------------------------------------------------------------


TRACES = {
    "poisson": ("iter_poisson_trace", dict(seed=3, duration_s=36 * 3600.0,
                                           arrival_rate_per_h=9.0)),
    "poisson_tiers": ("iter_poisson_trace", dict(seed=4, duration_s=12 * 3600.0,
                                                 tier_weights=(8, 2, 1), start_id=5)),
    "failure": ("iter_failure_trace", dict(n=16, seed=5, duration_s=24 * 3600.0,
                                           mtbf_node_s=2e5, mttr_s=1800.0)),
    "fault_domains": ("iter_fault_domain_trace", dict(
        n=16, rails=8, seed=6, duration_s=12 * 3600.0, mtbf_node_s=2e5, mtbf_switch_s=1e5,
        mtbf_link_s=5e6, mtbf_row_power_s=2e4)),
    "fault_domains_no_horizon": ("iter_fault_domain_trace", dict(
        n=8, seed=7, duration_s=4 * 3600.0, mtbf_node_s=5e4,
        emit_horizon_recoveries=False)),
    "fig20": ("fig20_trace", dict(stagger_s=30.0, start_id=2)),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_generators_match_the_reference_event_by_event(name):
    fn, kw = TRACES[name]
    got = list(getattr(trace, fn)(**kw))
    want = list(getattr(ref_trace, fn)(**kw))
    assert got and len(got) == len(want)
    same(got, want)
    same(trace.replay_trace(got), ref_trace.replay_trace(want))


def test_failure_trace_matches_its_own_reference_generator():
    kw = dict(n=16, seed=9, duration_s=24 * 3600.0, mtbf_node_s=1e5, mttr_s=3600.0)
    same(list(trace.iter_failure_trace(**kw)), list(trace._iter_failure_trace_ref(**kw)))
    same(trace.failure_trace(**kw), ref_trace.failure_trace(**kw))
    same(trace.poisson_trace(seed=1), ref_trace.poisson_trace(seed=1))
    same(trace.fault_domain_trace(n=8, seed=2, mtbf_switch_s=1e5),
         ref_trace.fault_domain_trace(n=8, seed=2, mtbf_switch_s=1e5))


@pytest.mark.parametrize("bursts", [0.0, 0.2])
def test_diurnal_traces_match_the_reference(bursts):
    prof = serving_traces.DiurnalProfile(base_rps=13.0, harmonics=(
        (0.5, 86400.0, -math.pi / 4.0), (0.2, 43200.0, math.pi / 2.0)))
    rprof = ref_st.DiurnalProfile(base_rps=13.0, harmonics=(
        (0.5, 86400.0, -math.pi / 4.0), (0.2, 43200.0, math.pi / 2.0)))
    for t in (0.0, 1234.5, 43200.0, 86399.0):
        assert serving_traces.diurnal_rate(prof, t) == ref_st.diurnal_rate(rprof, t)
        assert serving_traces.cumulative_requests(prof, t) == ref_st.cumulative_requests(rprof, t)
    assert serving_traces.mean_diurnal_rate(prof, 7e4) == ref_st.mean_diurnal_rate(rprof, 7e4)
    kw = dict(service_id=1, seed=102027, duration_s=24 * 3600.0, interval_s=600.0,
              burst_prob=bursts)
    got = list(serving_traces.iter_diurnal_trace(profile=prof, **kw))
    same(got, list(ref_st.iter_diurnal_trace(profile=rprof, **kw)))
    same(serving_traces.diurnal_trace(profile=prof, **kw), got)


WEIBULL = dict(n=16, rails=16, seed=72026, duration_s=8 * 3600.0, mtbf_node_s=3e6,
               mtbf_switch_s=4.0e5, mtbf_link_s=1.5e7, mttr_s=1800.0, shape=1.6, burst_mean=2.0)


@pytest.mark.parametrize("suffix", [".csv", ".jsonl"])
def test_availability_records_cross_between_the_packages(tmp_path, suffix):
    """Weibull records equal the reference's; a file written by either
    package is read by the other, and both replay to the same events."""
    got = trace.generate_weibull_records(**WEIBULL)
    want = ref_trace.generate_weibull_records(**WEIBULL)
    assert got
    same(got, want)
    same(trace.replay_availability_trace(got), ref_trace.replay_availability_trace(want))
    ours, theirs = tmp_path / f"port{suffix}", tmp_path / f"ref{suffix}"
    trace.dump_availability_records(got, ours)
    ref_trace.dump_availability_records(want, theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    same(trace.load_availability_records(theirs), ref_trace.load_availability_records(ours))
    same(trace.replay_availability_trace(trace.load_availability_records(theirs)),
         ref_trace.replay_availability_trace(want))
    trace.validate_availability_records(got)
    bad = got[:1] + [dataclasses.replace(got[0], down_t=-1.0)]
    with pytest.raises(ValueError) as e:
        trace.validate_availability_records(bad)
    with pytest.raises(ValueError, match=str(e.value)[:30]):
        ref_trace.validate_availability_records(
            [ref_trace.AvailabilityRecord(**dataclasses.asdict(r)) for r in bad])


def test_every_package_name_is_the_references():
    import repro.cluster as ref_cluster
    import repro_torch.cluster as cluster

    assert cluster.__all__ == ref_cluster.__all__
    for name in cluster.__all__:
        assert hasattr(cluster, name), name
    assert list(itertools.chain(trace.DEFAULT_MIX)) == list(ref_trace.DEFAULT_MIX)
