"""CPU tests of the benchmark harness:

    JAX_PLATFORMS=cpu python -m pytest perf/tests -q

They run the harness's own code paths at small sizes on the CPU, with the look for
a GPU skipped where a test says so."""

import os
import sys

import pytest

PERF = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERF)
for p in (PERF, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes at which the CPU runs a cell in seconds; the pole masks still cover
# the grid's singularities at 96 x 48
SMALL = {"bickley_q": {"build": {"nx": 96, "ny": 48, "substeps": 30}},
         "gyre_q_z10": {"build": {"nx": 96, "ny": 48, "nz": 3, "substeps": 30}}}
CPU_PEAKS = {"cpu": {"hbm_bytes_per_s": 1e11, "float32_flops": 1e12, "float64_flops": 5e11}}


@pytest.fixture(scope="session")
def bench():
    import run

    return run.Bench(ROOT)
