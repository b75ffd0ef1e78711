"""chip_smoke.py on the CPU: its phase functions at tiny size, called directly, and
the script itself, which must refuse to run (non-zero exit, no result line) where
JAX finds no GPU or where the rest of the repository is missing."""

import json
import pathlib
import shutil
import subprocess
import sys
from functools import partial

import pytest

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

import chip_smoke as cs  # noqa: E402
from examples.bickley_jet import build as build_bickley  # noqa: E402
from examples.wind_driven_ts_gyre import build as build_gyre  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models.hydrostatic import multi_step  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models.layered import layered_multi_step  # noqa: E402


def test_bickley_phase_and_kernel_phase_tiny():
    model, state = cs.run_model("bickley", partial(build_bickley, nx=64, ny=40, substeps=12),
                                multi_step, 60.0, 64 * 40)
    assert cs.kernel_vs_scan(model, state, tile=(16, 64), k=3,
                             interpret=True) <= cs.KERNEL_RTOL
    fns = {impl: cs.step_with(model, state, multi_step, 60.0, impl)
           for impl in ("xla", "kernel")}
    times, _ = cs.time_in_turns(model, state, multi_step, 60.0, fns,
                                ["xla", "kernel"], blocks=1)
    assert set(times) == {"xla", "kernel"} and all(len(t) == 1 for t in times.values())


def test_gyre_phase_tiny():
    cs.run_model("gyre", partial(build_gyre, nx=64, ny=40, nz=3, substeps=12),
                 layered_multi_step, 40.0, 64 * 40 * 3)


def test_four_card_phase_tiny():
    """The sharded phase on four of the virtual CPU devices."""
    cs.four_card_phase(
        (partial(build_bickley, nx=64, ny=48, substeps=6), multi_step, 60.0, 0),
        (partial(build_gyre, nx=64, ny=48, nz=3, substeps=6), layered_multi_step, 40.0, 0))


def test_compare_fields_rejects_a_wrong_field():
    model, state = build_bickley(nx=48, ny=32, substeps=8)
    bad = type(state)(**{**state.__dict__, "c": state.c * 1.01})
    with pytest.raises(AssertionError, match="field c"):
        cs.compare_fields(bad, state, model, cs.FIELD_RTOL, "tiny")


def _run_script(cwd, args=()):
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": str(cwd), "PYTHONNOUSERSITE": "1"}
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_script_fails_without_gpu(args):
    out = _run_script(_ROOT, args)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    _no_result(out)


def test_script_fails_alone(tmp_path):
    shutil.copy(_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_script(tmp_path)
    assert out.returncode != 0
    _no_result(out)
