"""The train step's and the MoE layer's spans and routing counter
(``repro_torch.obs``): how often each span runs, how they nest, their
profiler ranges, the step with tracing off, and the counter against a
recount of the routing."""

import contextlib
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import DTypes  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.obs import tracer as tracer_mod  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

MOE_FWD = ("moe.fwd.route", "moe.fwd.dispatch", "moe.fwd.experts", "moe.fwd.combine",
           "moe.fwd.shared")


def _zoo(remat: bool = True, capacity_factor: float = 1.25):
    """moonshot-smoke (2 MoE layers) with one shared expert."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    return get_model(dataclasses.replace(
        cfg, remat=remat,
        moe=dataclasses.replace(cfg.moe, num_shared_experts=1, capacity_factor=capacity_factor)))


def _run(tracer, remat: bool = True, microbatches: int = 2, steps: int = 1, mesh=None):
    """``steps`` AdamW steps of moonshot-smoke on 4 x 16 tokens under
    ``tracer`` (None: nothing installed) -> (params, losses, zoo)."""
    zoo = _zoo(remat)
    params = zoo.init(0, device="cpu")
    opt_cfg = opt_lib.AdamWConfig(warmup_steps=1)
    opt_state = opt_lib.init(opt_cfg, params)
    step = make_train_step(zoo, opt_cfg, microbatches=microbatches, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    losses = []
    with obs.tracing(tracer) if tracer is not None else contextlib.nullcontext():
        for _ in range(steps):
            tok = torch.randint(0, zoo.cfg.vocab, (4, 17), generator=gen)
            params, opt_state, m = step(params, opt_state,
                                        {"tokens": tok[:, :-1], "targets": tok[:, 1:]})
            losses.append(m["loss"])
    return params, losses, zoo


def _expected_counts(layers: int, microbatches: int, remat: bool):
    """Spans a step: the forward's MoE parts run again in remat's recompute;
    the f32 sum spans the accumulator's fill, each add and the division."""
    counts = {"train.fwd": microbatches, "train.bwd": microbatches, "train.optimizer": 1,
              "moe.bwd": layers * microbatches}
    counts.update({n: layers * microbatches * (2 if remat else 1) for n in MOE_FWD})
    if microbatches > 1:
        counts["train.grad_sum"] = microbatches + 2
    return counts


@pytest.mark.parametrize("remat,microbatches", [(True, 2), (False, 2), (True, 1)])
def test_a_step_emits_each_span_as_often_as_it_runs_the_part(remat, microbatches):
    tracer = obs.Tracer(process="train")
    _, _, zoo = _run(tracer, remat, microbatches)
    want = _expected_counts(zoo.cfg.num_layers, microbatches, remat)
    got = {n: t["count"] for n, t in tracer.phase_totals().items()}
    assert got == want
    assert set(got) <= obs.known_span_names() and not set(got) & set(
        n for names in obs.KNOWN_SPANS.values() for n in names)
    assert obs.validate_trace(tracer.to_dict())["spans"] == sum(want.values())


def _nesting(events):
    """(span, the spans open around it) for every span, per thread."""
    out, stacks = [], {}
    for e in events:
        stack = stacks.setdefault(e["tid"], [])
        if e["ph"] == "B":
            out.append((e["name"], tuple(stack)))
            stack.append(e["name"])
        elif e["ph"] == "E":
            assert stack.pop() == e["name"]
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_moe_bwd_nests_in_train_bwd_and_holds_no_forward_span(remat):
    """Remat's recompute (which runs the ``moe.fwd.*`` spans again) runs
    before ``moe.bwd`` opens, and nothing of the forward opens inside it."""
    tracer = obs.Tracer(process="train")
    _run(tracer, remat)
    nesting = _nesting(tracer.events)
    bwd = [outer for name, outer in nesting if name == "moe.bwd"]
    assert bwd and all(outer == ("train.bwd",) for outer in bwd)
    assert not [name for name, outer in nesting if "moe.bwd" in outer]
    recomputed = [outer for name, outer in nesting if name in MOE_FWD and "train.bwd" in outer]
    assert len(recomputed) == (len(MOE_FWD) * 2 * 2 if remat else 0)
    for name, outer in nesting:
        if name.startswith("train."):
            assert outer == ()


def test_spans_under_a_profiler_are_host_ops_in_the_process_tracer(monkeypatch):
    """With no tracer installed a ``torch.profiler`` session switches the
    spans on: each is a host event that is no user annotation (so it gets
    no device-side twin), and the process-level tracer holds them."""
    monkeypatch.setattr(tracer_mod, "_profiled", None)
    assert obs.profiled_tracer() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.profiling()
        _, _, zoo = _run(None)
    assert not obs.profiling() and obs.get_tracer() is obs.NULL_TRACER
    want = _expected_counts(zoo.cfg.num_layers, 2, True)
    held = obs.profiled_tracer()
    assert {n: t["count"] for n, t in held.phase_totals().items()} == want
    ranges = {}
    for e in prof.events():
        if e.name in want:
            ranges.setdefault(e.name, []).append(e.is_user_annotation)
    assert {n: len(v) for n, v in ranges.items()} == want
    assert not any(any(v) for v in ranges.values())
    # on the CPU the spans carry no device time, and reading it fails nothing
    assert held.device_totals() == {}
    assert held.counter_totals()["moe.routing"]["slots"] > 0


class _StrictDisabledTracer:
    """A disabled tracer whose every emit raises: tracing off must call
    straight through."""

    enabled = False

    def __getattr__(self, name):
        raise AssertionError(f"{name} used while tracing is off")


def test_tracing_off_touches_no_tracer_and_changes_nothing():
    """Two steps with a strict disabled tracer, with nothing installed and
    with a tracer: bit-identical params and losses."""
    runs = [_run(t, steps=2)[:2] for t in (_StrictDisabledTracer(), None, obs.Tracer())]
    (p0, l0) = runs[0]
    for params, losses in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(l0, losses))
        for (n, a), (_, b) in zip(p0.named_parameters(), params.named_parameters()):
            assert torch.equal(a, b), n


class _Ops(TorchDispatchMode):
    """The operators a region runs, views left out (they launch nothing)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [True, False])
def test_tracing_runs_the_same_operators_as_a_step_without_it(remat):
    """The spans, the counter and the backward's two identity nodes run no
    operator of their own, in the forward or in remat's recompute (a save
    at the layer's end would make the early-stopped recompute run the
    layer's last products: two more a layer)."""
    seen = []
    for tracer in (_StrictDisabledTracer(), obs.Tracer()):
        with _Ops() as mode:
            _run(tracer, remat)
        seen.append(mode.ops)
    assert len(seen[0]) > 1000 and seen[0] == seen[1]


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_the_routing_counter_equals_a_recount_of_the_routing(capacity_factor, monkeypatch):
    """``moe.routing`` on the dense path: T * K assignments, E * C slots and
    the kept ones, as recounted from each ``Routing``'s slots; at capacity
    factor 0.5 the routing drops assignments."""
    cfg = moe.MoEConfig(d_model=64, d_ff=96, num_experts=4, top_k=2,
                        capacity_factor=capacity_factor, num_shared_experts=1)
    dt = DTypes()
    p = moe.init_moe(torch.Generator().manual_seed(1), cfg, dt, "cpu")
    routings = []
    real = moe._route

    def recorded(*args, **kwargs):
        r = real(*args, **kwargs)
        routings.append(r)
        return r

    monkeypatch.setattr(moe, "_route", recorded)
    tracer = obs.Tracer()
    x = torch.randn(3, 24, 64, generator=torch.Generator().manual_seed(2))
    with obs.tracing(tracer):
        for rows in (x, x[:1]):
            moe.moe_ffn_dense(p, cfg, rows, dt)
    got = tracer.counter_totals()["moe.routing"]
    want = {"assigned": sum(r.slot.numel() for r in routings),
            "slots": sum(r.num_experts * r.capacity for r in routings),
            "kept": sum(int((r.slot < r.num_experts * r.capacity).sum()) for r in routings)}
    assert len(routings) == 2 and got == want
    assert got["kept"] <= min(got["assigned"], got["slots"])
    if capacity_factor < 1:
        assert got["kept"] < got["assigned"]
    json.dumps(tracer.to_dict())  # the counters' values are numbers once read


def test_a_counter_value_that_is_callable_is_called_once_when_read():
    calls = []

    def later():
        calls.append(1)
        return 5

    tracer = obs.Tracer()
    tracer.counter("c", now=2, later=later)
    tracer.counter("c", now=3, later=later)
    assert calls == []
    assert tracer.counter_totals() == {"c": {"now": 5, "later": 10}}
    assert tracer.to_dict()["traceEvents"][-1]["args"] == {"now": 3, "later": 5}
    assert tracer.counter_totals() == {"c": {"now": 5, "later": 10}} and len(calls) == 2


def test_device_timing_is_absent_without_cuda_and_fails_nothing():
    tracer = obs.Tracer(device=True)
    assert tracer.device is torch.cuda.is_available()
    with tracer.span("train.fwd"):
        pass
    assert tracer.phase_totals()["train.fwd"]["count"] == 1
    if not tracer.device:
        assert tracer.device_totals() == {}


def test_a_mesh_step_reduces_its_gradients_in_one_span():
    """``gspmd_fsdp`` on a gloo world of one, (1, 1, 1): the MoE layers run
    expert-parallel (``moe_ffn_ep``) with the same spans, and the gradient
    collectives and norm run in one ``train.grad_reduce`` a step."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_mesh

    if dist.is_initialized():
        pytest.fail("a process group is already set up in this test process")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        tracer = obs.Tracer(process="train")
        _, losses, zoo = _run(tracer, mesh=make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu"))
    finally:
        dist.destroy_process_group()
    want = dict(_expected_counts(zoo.cfg.num_layers, 2, True), **{"train.grad_reduce": 1})
    assert {n: t["count"] for n, t in tracer.phase_totals().items()} == want
    assert obs.validate_trace(tracer.to_dict())["spans"] == sum(want.values())
    assert torch.isfinite(losses[0])


def _graph_names(t):
    """The autograd node names the graph of ``t`` holds."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(fn for fn, _ in node.next_functions)
    return names


@pytest.mark.parametrize("remat", [True, False])
def test_the_moe_bwd_nodes_are_in_the_graph_only_while_tracing(remat):
    zoo = _zoo(remat)
    params = zoo.init(0, device="cpu")
    params.requires_grad_(True)
    tok = torch.randint(0, zoo.cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    marks = {}
    for name, tracer in (("off", _StrictDisabledTracer()), ("on", obs.Tracer())):
        with obs.tracing(tracer):
            loss, _ = zoo.loss(params, batch)
        marks[name] = sorted(n for n in _graph_names(loss) if n.startswith("_Bwd"))
    assert marks["off"] == []
    if not remat:  # under remat the layers are checkpoint nodes, their insides recomputed
        assert marks["on"] == ["_BwdCloseBackward"] * 2 + ["_BwdOpenBackward"] * 2
