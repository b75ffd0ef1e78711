"""The harness end to end at small sizes on the CPU (the look for a GPU skipped),
through the same code paths a chip run takes, and ``perf/run.py`` refusing the CPU."""

import json
import os
import subprocess
import sys

import pytest

import run
from conftest import CPU_PEAKS, PERF, ROOT, SMALL

SEED = 2**31 + 4242


def small_run(bench, cell, seconds=0.5, seed=SEED):
    return run.run_cell(bench, cell, seed, seconds, False, require_gpu=False,
                        overrides=SMALL[cell.split(".")[0]], peaks=CPU_PEAKS)


@pytest.mark.parametrize("cell", ["bickley_q.scan10", "gyre_q_z10.scan10", "bickley_q.sim"])
def test_cell_runs_and_is_correct(bench, cell):
    r = small_run(bench, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    expect = {m["name"] for m in bench.metrics(bench.cell(cell), "end_to_end")}
    assert set(r["metrics"]) == expect - {"peak_mem_gb"}  # the CPU reports no peak
    rate = "gridpts_per_s.sim" if cell.endswith(".sim") else "gridpts_per_s"
    assert r["metrics"][rate]["value"] > 0


def test_run_py_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(PERF, "run.py"), "--workload",
                        "bickley_q.scan10", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_run_py_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and perf/, the run fails."""
    import shutil

    shutil.copytree(PERF, tmp_path / "perf")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "perf/run.py", "--workload", "bickley_q.scan10",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
