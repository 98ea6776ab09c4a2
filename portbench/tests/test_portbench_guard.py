"""The import guard, each case in a fresh process: other test files in the
same worker import jax and the JAX package, so this process proves nothing."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from portbench_cells import ROOT


def _python(body: str) -> subprocess.CompletedProcess:
    """``body`` after the guard's installation, in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", PRELUDE + textwrap.dedent(body)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


PRELUDE = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
from portbench import guard
guard.install({str(ROOT)!r})
"""


def test_a_tiny_run_of_the_harness_and_the_port_loads_no_jax():
    done = _python("""
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(2)
    from portbench_cells import cell
    from portbench import bench
    out = bench.runner("train").run(cell(), 1, 0.1, False, 0.0, device="cpu")
    print("correct", out["correct"])
    print("problems", guard.problems())
    print("repro_torch", "repro_torch" in sys.modules)
    """.format(tests=str(ROOT / "portbench" / "tests")))
    assert done.returncode == 0, done.stderr[-2000:]
    assert "problems []" in done.stdout and "repro_torch True" in done.stdout, done.stdout


def test_the_guard_names_jax_the_jax_package_and_its_files():
    done = _python("""
    import types
    import repro_torch.configs
    assert guard.problems() == [], guard.problems()
    sys.modules["jax"] = types.ModuleType("jax")
    sys.modules["repro.models"] = types.ModuleType("repro.models")
    sys.modules["jaxtyping"] = types.ModuleType("jaxtyping")
    open({path!r}).close()
    open({ok!r}).close()
    print("\\n".join(guard.problems()))
    """.format(path=str(ROOT / "benchmarks" / "run.py"),
               ok=str(ROOT / "src" / "repro_torch" / "__init__.py")))
    assert done.returncode == 0, done.stderr[-2000:]
    lines = done.stdout.strip().splitlines()
    assert lines == ["module jax is loaded", "module repro.models is loaded",
                     f"opened {ROOT / 'benchmarks' / 'run.py'}"], lines


def test_the_command_prints_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command runs the cell")
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "moe-train-8k",
                           "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert done.returncode != 0 and done.stdout.strip() == "" and "CUDA" in done.stderr
