"""Every name in BENCHMARK.json leads to its files, a new entry with new files is
picked up with no edit to the harness, and the file keeps the shape the harness and
its readers rely on (names, units, bounds, which cell reports what)."""

import json
import os
import re
import shutil
import types

import pytest

import run
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_resolves(bench):
    spec = bench.spec
    for c in spec["configs"]:
        cfg, ref = bench.config(c["name"])
        assert os.path.exists(ref) and hasattr(run.load_module(ref, "r_" + c["name"]), "LIMITS")
        for kind in ("init", "counts"):
            assert bench.module(kind, c["name"])
    for w in spec["workloads"]:
        assert bench.traffic(w["traffic"])["loop"] in ("scan", "simulation")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.module("metrics", m["name"]).read)


def test_benchmark_file_shape(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in cells.values():
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        reported = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert len(reported) >= 2
    for m in spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_new_entries_need_only_new_files(tmp_path, bench):
    spec = json.loads(json.dumps(bench.spec))
    shutil.copytree(os.path.join(ROOT, "perf"), tmp_path / "perf")
    (tmp_path / "perf/configs/dummy_cfg.json").write_text(json.dumps({"build": {}}))
    (tmp_path / "perf/configs/dummy_cfg.py").write_text("LIMITS = {}\n")
    (tmp_path / "perf/traffic/dummy_mix.json").write_text(json.dumps({"loop": "scan"}))
    (tmp_path / "perf/metrics/dummy_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.window['steps']\n")
    spec["configs"].append({"name": "dummy_cfg", "source": "x",
                            "file": "perf/configs/dummy_cfg.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "1", "better": "higher",
                              "source": "host_clock", "layer": "x", "moves": "setup_s",
                              "workloads": ["dummy_cfg.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = run.Bench(str(tmp_path))
    cell = b.cell("dummy_cfg.dummy_mix")
    cfg, ref = b.config(cell["config"])
    assert cfg == {"build": {}} and ref.endswith("dummy_cfg.py")
    assert b.traffic(cell["traffic"]) == {"loop": "scan"}
    names = [m["name"] for m in b.metrics(cell, "per_layer")]
    assert "dummy_metric" in names and "callback_ms_per_step" not in names
    ctx = types.SimpleNamespace(window={"steps": 3})
    assert b.module("metrics", "dummy_metric").read(ctx) == 6.0
    with pytest.raises(KeyError):
        b.cell("nope")
