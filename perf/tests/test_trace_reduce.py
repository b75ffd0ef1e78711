"""The reduction from trace to busy time, per-op time and attributed idle gaps, on
hand-made planes and on a trace recorded on the H100 (perf/testdata)."""

import os

import pytest

import run
import trace_reduce as tr
from conftest import PERF

W = run.WINDOW_SPAN


def test_union_gaps_and_attribution():
    planes = [
        ("/host:CPU", [("python", [(W, 100, 1100), ("sync", 300, 600),
                                   ("output", 700, 1000), ("dispatch", 150, 160)])]),
        ("/device:GPU:0", [
            ("Stream #1", [("fusion_a", 50, 250), ("k__1", 400, 500)]),
            ("Stream #2", [("fusion_a", 200, 300), ("k", 480, 650), ("late", 1200, 1300)]),
        ]),
    ]
    red = tr.reduce_planes(planes, W, run.HOST_SPANS)
    assert red["window_s"] == pytest.approx(1000e-9)
    # busy: [100, 300] clipped at the window, [400, 650]
    assert red["busy_s"] == pytest.approx(450e-9)
    assert red["ops"] == pytest.approx({"fusion_a": 250e-9, "k": 270e-9})
    gaps = dict((round(s * 1e9), n) for n, s in red["gaps"])
    assert gaps == {100: "sync", 450: "output"}
    assert red["gaps"][0] == ("output", pytest.approx(450e-9))
    bd = tr.breakdown(red)
    assert bd["device_ops"][0][0] == "k" and len(bd["idle_gaps"]) == 2


def test_missing_window_or_device_is_an_error():
    host = ("/host:CPU", [("python", [(W, 0, 10)])])
    with pytest.raises(ValueError):
        tr.reduce_planes([host], W, ())
    with pytest.raises(ValueError):
        tr.reduce_planes([("/device:GPU:0", [])], W, ())


# (trace, busy_s, window_s) of two 10-step windows at 96 x 48, recorded on an H100
# 80GB HBM3 (700 W) through the harness's loops and tracing
RECORDED = [("bickley_q_scan10", 0.001416118, 0.0030456130000000004),
            ("bickley_q_sim", 0.001606723, 0.06401961)]


@pytest.mark.parametrize("name,busy,window", RECORDED)
def test_recorded_h100_trace(name, busy, window):
    path = os.path.join(PERF, "testdata", name + ".xplane.pb")
    red = tr.reduce_trace(path, W, run.HOST_SPANS)
    assert red["devices"] == 1
    assert red["busy_s"] == pytest.approx(busy, rel=1e-12)
    assert red["window_s"] == pytest.approx(window, rel=1e-12)
    assert 0 < red["busy_s"] <= red["window_s"]
    assert "barotropic_substeps" in red["ops"]
    assert not any(n.startswith("barotropic_substeps__") for n in red["ops"])
    assert sum(red["ops"].values()) >= red["busy_s"] * (1 - 1e-9)
    assert {n for n, _ in red["gaps"]} <= set(run.HOST_SPANS) | {"loop"}
