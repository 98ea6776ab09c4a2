"""The per-layer metrics that read the port's own spans and counter: none
without a trace or without the program's process-level tracer, and, on a
CPU run of the tiny cell with its trace, the routing counter's recount."""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from portbench_cells import cell  # noqa: E402

from portbench import bench  # noqa: E402

TIMED = ("fwd_ms", "bwd_ms", "grad_sum_ms", "moe_bwd_ms", "moe_shared_ms")
READERS = TIMED + ("moe_slot_fill",)


@dataclasses.dataclass
class _Trace:
    steps: int = 2


@dataclasses.dataclass
class _Record:
    trace: object = None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_a_trace(name):
    assert bench.metric_reader(name).read(_Record()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_in_a_program_without_the_tracer(name, monkeypatch):
    """A parent without ``obs.profiled_tracer`` reads None and does not
    raise; so does a run in which no profiler switched the spans on."""
    from repro_torch import obs
    from repro_torch.obs import tracer as tracer_mod

    monkeypatch.setattr(tracer_mod, "_profiled", None)
    assert bench.metric_reader(name).read(_Record(_Trace())) is None
    monkeypatch.delattr(obs, "profiled_tracer")
    assert bench.metric_reader(name).read(_Record(_Trace())) is None


def test_a_traced_cpu_run_reads_the_routing_recount(monkeypatch):
    """The tiny cell run with its trace on the CPU (the trace's synchronise
    made a no-op): ``moe_slot_fill`` is the kept share of the slots that
    the profiled steps' routings recount; the spans carry no device time
    there, so the timed readers find nothing."""
    from repro_torch.models import moe
    from repro_torch.obs import tracer as tracer_mod

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tracer_mod, "_profiled", None)
    torch.set_num_threads(2)
    routings = []
    real = moe._route

    def recorded(*args, **kwargs):
        r = real(*args, **kwargs)
        if tracer_mod.profiling():
            routings.append(r)
        return r

    monkeypatch.setattr(moe, "_route", recorded)
    out = bench.runner("train").run(cell(), 2 ** 31 + 11, 0.2, True, 0.0, device="cpu")
    record = out["record"]
    assert out["correct"] and record.trace is not None
    # two profiled steps of two microbatches, each layer routed in the
    # forward and again in remat's recompute
    assert len(routings) == 2 * 2 * 2 * 2
    slots = sum(r.num_experts * r.capacity for r in routings)
    kept = sum(int((r.slot < r.num_experts * r.capacity).sum()) for r in routings)
    assert 0 < kept < slots
    fill = bench.metric_reader("moe_slot_fill").read(record)
    assert fill == pytest.approx(100.0 * kept / slots, rel=1e-12)
    for name in TIMED:
        assert bench.metric_reader(name).read(record) is None
