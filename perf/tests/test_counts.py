"""The algorithmic counts at a tiny shape against a count made by hand."""

import run
from conftest import PERF


def counts(name):
    return run.load_module(f"{PERF}/counts/{name}.py", f"counts_{name}")


def test_bickley_counts_by_hand():
    # 4 x 2 interior points, 30 substeps -> 21 weighted substeps
    cfg = {"build": {"nx": 4, "ny": 2, "substeps": 30}}
    c = counts("bickley_q")
    # per point: 6 + 12 + 140 + 8 + 10 + 140 + 11 + 14 + 4 = 345 flops, plus the
    # subcycle's 28 x 21 = 588
    assert c.step(cfg)["flops"] == (345 + 588) * 8
    # 9 prognostic planes read and written, 15 + 9 static planes, 4 bytes
    assert c.step(cfg)["bytes"] == (18 + 24) * 4 * 8
    assert c.baro(cfg) == {"flops": 588 * 8, "bytes": (5 + 9 + 3) * 4 * 8}


def test_gyre_counts_by_hand():
    cfg = {"build": {"nx": 4, "ny": 2, "nz": 3, "substeps": 30}}
    c = counts("gyre_q_z10")
    layer = 7 + 12 + 140 + 8 + 8 + 10 + 14 + 18 + 16 + 26 + 28 + 2 + 358 + 12 + 4 + 10 + 6
    assert c.step(cfg)["flops"] == layer * 8 * 3 + 588 * 8
    # 3 levels of (8 prognostic read + written, 5 static) + 3 2-D prognostic read and
    # written + 16 + 9 2-D statics
    assert c.step(cfg)["bytes"] == (3 * (16 + 5) + 6 + 16 + 9) * 4 * 8
    assert c.baro(cfg)["bytes"] == 17 * 4 * 8
