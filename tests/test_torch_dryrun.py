"""The port's dry run and roofline (``launch/dryrun.py``,
``launch/roofline.py``) and the registry pieces they read, against the JAX
package's; a smoke cell traced on the meta device in a fake world of 8
against the same step run for real in a gloo world of 8
(``torch_dist_worlds.dry``)."""

import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402


@pytest.fixture(autouse=True)
def _no_world_left():
    """A cell on the production mesh sets up a fake world in this process:
    it is torn down after each test."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_dryrun():
    """The reference's dry-run module; its import sets XLA_FLAGS to 512
    host devices for the process, which is put back (no JAX backend of this
    process reads it, the module's functions need none)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def test_registry_matches_the_reference():
    """``ALL_CONFIGS`` and the dry run's names are the reference's
    ``ALL_CONFIGS`` and ``ARCHS``; ``supports_decode`` /
    ``supports_long_context`` agree for every name; the port's ``ARCHS``
    keeps all eleven."""
    assert set(configs.ALL_CONFIGS) == set(jax_registry.ALL_CONFIGS)
    assert configs.DRYRUN_ARCHS == jax_registry.ARCHS
    assert set(configs.ARCHS) == set(jax_registry.ALL_CONFIGS)
    for arch in jax_registry.ALL_CONFIGS:
        assert configs.supports_decode(arch) == jax_registry.supports_decode(arch), arch
        assert configs.supports_long_context(arch) == \
            jax_registry.supports_long_context(arch), arch


def test_run_config_matches_the_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(base.RunConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jax_base.RunConfig)]
    assert got == want
    rc = base.RunConfig(model=configs.get_config("qwen3-8b"), shape=configs.SHAPES["train_4k"])
    assert rc.dp_schedule == "hierarchical" and rc.microbatches == 1 and rc.remat and rc.fsdp


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("shape", list(jax_base.SHAPES))
@pytest.mark.parametrize("arch", jax_registry.ALL_CONFIGS)
def test_input_specs_and_skips_match_the_reference(arch, shape):
    """Every arch x shape: the same input names, shapes and dtypes (at the
    dry run's bf16 numerics), the same skip and its reason."""
    ref = _jax_dryrun()
    assert dryrun.cell_is_skipped(arch, shape) == ref.cell_is_skipped(arch, shape)
    jcfg = ref.dryrun_model_config(jax_registry.get_config(arch))
    cfg = dryrun.dryrun_model_config(configs.get_config(arch))
    assert cfg.param_dtype == cfg.compute_dtype == torch.bfloat16 and cfg.remat
    want = ref.input_specs(jcfg, jax_base.SHAPES[shape])
    got = dryrun.input_specs(cfg, configs.SHAPES[shape])
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert got[k].dtype == _DTYPES[str(v.dtype)], k
        assert got[k].device.type == "meta", k


def test_build_report_terms_from_given_counts():
    """The three terms at the H100 constants, the dominant one, the useful
    FLOP ratio and the roofline fraction, from counts given by hand."""
    stats = roofline.TraceStats(flops=2 * 989e12, hbm_bytes=3.35e12,
                                intra_collective_bytes=450e9, inter_collective_bytes=100e9,
                                collective_bytes=550e9, collective_detail={"all_reduce@model": 1})
    rep = roofline.build_report("a", "s", "pod1", 4, stats, {"peak_bytes": 1.0},
                                model_flops_global=4 * 989e12, default_trip=28,
                                extra_flops_global=4 * 989e12)
    assert rep.compute_s == pytest.approx(3.0)          # 2 + 4/4 PFLOP at 989 TFLOP/s
    assert rep.memory_s == pytest.approx(1.0)
    assert rep.collective_s == pytest.approx(1.0 + 2.0)  # NVLink 1 s + NIC 2 s
    assert rep.dominant == "compute"
    assert rep.model_flops_per_dev == pytest.approx(989e12)
    assert rep.useful_flop_ratio == pytest.approx(1 / 3)
    assert rep.roofline_fraction == pytest.approx(1 / 3)
    d = rep.as_dict()
    assert d["trip_counts"] == {"layers": 28} and d["dominant"] == "compute"
    assert roofline.model_train_flops(10, 3) == 180.0
    assert roofline.model_decode_flops(10, 3) == 60.0
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW, roofline.NIC_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)


def test_trace_counter_counts_flops_bytes_and_the_peak():
    """A matmul, a tanh and a product on the meta device, then a backward:
    the matmuls' FLOPs (the forward's and w's gradient's: x needs none),
    every op's
    inputs plus outputs, and the live bytes' peak."""
    w = torch.zeros(64, 32, device="meta", requires_grad=True)
    x = torch.zeros(16, 64, device="meta")

    def step():
        h = torch.tanh(x @ w)        # 16 x 32 f32: 2 KiB each
        (h * 2).sum().backward()

    _, st = roofline.trace(step, external=[w, x])
    assert st.flops == 2 * 2 * 16 * 64 * 32
    assert st.flop_table == {"aten.mm": 2 * 2 * 16 * 64 * 32}
    assert st.peak_bytes >= 64 * 32 * 4       # w.grad
    assert st.hbm_bytes > 2 * (16 * 64 + 64 * 32 + 16 * 32) * 4
    assert st.collective_bytes == 0


def test_a_full_size_cell_runs_and_counts_its_arguments():
    """llama3.2-3b's train_4k cell on the 16 x 16 mesh: OK, its argument
    bytes are its layout's parameter and moment blocks and its batch rows,
    and it reports whether its peak fits 80 GB."""
    res = dryrun.run_cell("llama3.2-3b", "train_4k")
    assert res["status"] == "OK"
    rep = res["report"]
    m = rep["memory_stats"]
    cfg = dryrun.dryrun_model_config(configs.get_config("llama3.2-3b"))
    from repro_torch.models.model_zoo import get_model

    n = sum(int(np.prod(s)) for s in get_model(cfg).param_shapes().values())
    # the blocks cut every leaf a rank's share, or keep it whole where the
    # mesh does not divide it: at least 1/256 of the params a rank
    assert n * 2 / 256 <= m["param_bytes"] <= n * 2
    assert m["moment_bytes"] == 4 * m["param_bytes"]          # f32 mu and nu of bf16 params
    # tokens + targets: 16 rows, and under seq -> "model" (24 heads over 16)
    # a rank's 4096 / 16 positions of them
    assert m["batch_bytes"] == 2 * 16 * (4096 // 16) * 4
    assert m["argument_bytes"] == m["param_bytes"] + m["moment_bytes"] + m["batch_bytes"]
    assert m["peak_bytes"] > m["argument_bytes"]
    assert res["fits_80GB"] == (m["peak_bytes"] <= 80e9)
    assert rep["chips"] == 256 and rep["trip_counts"] == {"layers": 28}
    assert rep["hlo_flops_per_dev"] > rep["model_flops_per_dev"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma3-4b", "qwen2-vl-2b", "whisper-large-v3"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_sequence_parallel_train_cells_fit_one_card(arch, multi_pod):
    """The archs whose heads do not divide 16 train under the reference's
    ``seq -> "model"`` (``attention_overrides``): the rank cuts its batch
    rows by position and reckons a peak under 80 GiB with "ref" attention
    on both production meshes (with the activations whole on every
    "model" rank they reckoned 90.15, 43.62, 44.83 and 97.09 GiB on (16,
    16))."""
    res = dryrun.run_cell(arch, "train_4k", multi_pod=multi_pod)
    assert res["status"] == "OK" and res["overrides"]["seq"] == "model"
    m = res["report"]["memory_stats"]
    assert m["peak_bytes"] < 80 * 2 ** 30
    rows = 256 // (32 if multi_pod else 16)
    # tokens + targets (whisper: + bf16 frames; vlm: bf16 embeds, positions3
    # for tokens) of the rank's rows at 4096 / 16 positions
    per_position = {"whisper-large-v3": 8 + 2 * 1280, "qwen2-vl-2b": 4 + 2 * 1536 + 12}
    assert m["batch_bytes"] == rows * 256 * per_position.get(arch, 8)


def test_skipped_cells_are_skipped():
    res = dryrun.run_cell("llama3.2-3b", "long_500k")
    assert res["status"] == "SKIP" and "long_500k" in res["reason"]
    assert dryrun.cell_is_skipped("zamba2-7b", "long_500k") is None


@pytest.fixture(scope="module")
def real_world(tmp_path_factory):
    work = tmp_path_factory.mktemp("dry")
    rng = np.random.RandomState(0)
    np.savez(work / "inputs.npz", **{"dry.tokens": rng.randint(0, 128, (8, 16)),
                                     "dry.targets": rng.randint(0, 128, (8, 16))})
    cmds = {"dry": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "dry",
                    "8", str(work)]}
    worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, 8))
    return dict(np.load(work / "dry_0.npz"))


def test_fake_world_trace_matches_a_real_world(real_world):
    """The dry run's smoke cell (llama3.2-3b-smoke, gspmd_fsdp on (2, 2, 2),
    8 x 16 tokens, f32) traced on the meta device as rank 0 of a fake world
    of 8 counts the FLOPs that ``FlopCounterMode`` counts for the same step
    run with values on rank 0 of a gloo world of 8, records the same
    collectives (op, axes, bytes, in order) and the same argument bytes."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.mesh import make_mesh

    if dist.is_initialized():
        pytest.fail("a process group is already set up in this test process")
    dryrun.fake_world(8)
    try:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
        res = dryrun.run_cell("llama3.2-3b", "train_4k", mesh=mesh, shape=shape,
                              cfg=get_smoke_config("llama3.2-3b"), tag="smoke")
    finally:
        dist.destroy_process_group()
    rep = res["report"]
    assert rep["hlo_flops_per_dev"] == float(real_world["flops"])
    m = rep["memory_stats"]
    assert m["param_bytes"] == int(real_world["param_bytes"])
    assert m["moment_bytes"] == int(real_world["moment_bytes"])
    want = {}
    for op, axes, n in zip(real_world["ledger.op"], real_world["ledger.axes"],
                           real_world["ledger.bytes"]):
        key = f"{op}@{axes}"
        want[key] = want.get(key, 0) + int(n)
    assert rep["collectives"] == pytest.approx(want)
    assert rep["collective_bytes_per_dev"] == sum(int(n) for n in real_world["ledger.bytes"])
