"""The benchmark finds each configuration, mix, metric, limit and runner by
the name BENCHMARK.json gives it, and takes a new set as new files alone."""

from __future__ import annotations

import re
import shutil

import pytest

from portbench_cells import ROOT, write_set

from portbench import bench

SPEC = bench.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = bench.find_cell(workload)
    assert cell.config["kind"] == "train"
    assert bench.runner(cell.config["kind"]).run
    assert cell.limits, "a cell's limits for correct are set"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(bench.metric_reader(metric).read)


def test_names_units_and_bounds_keep_the_contract():
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_a_new_set_is_found_from_new_files_alone(tmp_path):
    """A configuration, a mix, an end-to-end and a per-layer metric, limits
    and a cell added as new files and entries (in a copy) run through the
    runner unchanged."""
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(bench.HERE / sub, bench_dir / sub)
    write_set(bench_dir, tmp_path)
    cell = bench.find_cell("tiny-moe-cell", tmp_path, bench_dir)
    assert [m["name"] for m in cell.end_to_end][-1] == "window_steps"
    for workload in (w["name"] for w in SPEC["workloads"]):
        assert bench.find_cell(workload, tmp_path, bench_dir).config == \
            bench.find_cell(workload).config
    out = bench.runner(cell.config["kind"]).run(cell, 5, 0.2, False, 0.0, device="cpu")
    assert out["correct"], out["numbers"]
    metrics = bench.read_metrics(cell.end_to_end, out["record"], bench_dir)
    assert metrics["window_steps"]["value"] >= 1
    # train_tokens_per_s names its cells; off the card there is no peak
    assert set(metrics) == {"setup_s", "window_steps"}
    assert [m["name"] for m in cell.per_layer] == ["window_s"]
    layer = bench.read_metrics(cell.per_layer, out["record"], bench_dir)
    assert layer["window_s"]["value"] > 0
