"""``correct`` comes out false when the timed path is broken underneath a run, once
for each fault a cell can have, and when the control (the reference in bfloat16,
below the configuration's float32) takes the program's place. The look for a GPU
is skipped; everything else is a whole run at a small size on the CPU."""

import jax
import jax.numpy as jnp
import pytest

import calibrate
import run
from conftest import CPU_PEAKS, SMALL

SEED = 3_000_000_019
# the function each loop drives: scan cells the configuration's multi_step, the
# simulation cell the package's step as its Simulation jits it
TIMED = {
    "bickley_q.scan10": ("orthogonalsphericalshellgrids_tpu.models.hydrostatic", "multi_step"),
    "gyre_q_z10.scan10": ("orthogonalsphericalshellgrids_tpu.models.layered",
                          "layered_multi_step"),
    "bickley_q.sim": ("orthogonalsphericalshellgrids_tpu.utils.simulation", "step"),
}


def unchanged(real):
    def f(model, state, dt, **kw):
        return state
    return f


def half_left_out(real):
    """Every field's rows in the northern half of the array keep their old values."""
    def f(model, state, dt, **kw):
        new = real(model, state, dt, **kw)

        def keep(a, b):
            if getattr(a, "ndim", 0) < 2:
                return a
            n = a.shape[-2] // 2
            return a.at[..., n:, :].set(b[..., n:, :])
        return jax.tree_util.tree_map(keep, new, state)
    return f


def answer_altered(real):
    """One interior u value off by 1% of the field's largest."""
    def f(model, state, dt, **kw):
        new = real(model, state, dt, **kw)
        u = new.u
        j, i = u.shape[-2] // 3, u.shape[-1] // 3
        return type(new)(**{**vars(new), "u": u.at[..., j, i].add(
            0.01 * jnp.max(jnp.abs(u)) + 1e-3)})
    return f


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("cell", sorted(TIMED))
def test_fault_makes_the_run_incorrect(bench, monkeypatch, cell, fault):
    import importlib

    mod = importlib.import_module(TIMED[cell][0])
    real = getattr(mod, TIMED[cell][1])
    monkeypatch.setattr(mod, TIMED[cell][1], fault(real))
    r = run.run_cell(bench, cell, SEED, 0.3, False, require_gpu=False,
                     overrides=SMALL[cell.split(".")[0]], peaks=CPU_PEAKS)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", ["bickley_q.scan10", "gyre_q_z10.scan10"])
def test_control_fails_and_program_passes(bench, cell):
    out = calibrate.readings(bench, cell, [SEED], [SEED], SMALL[cell.split(".")[0]])
    cfg, ref_path = bench.config(bench.cell(cell)["config"])
    limits = run.load_module(ref_path, "ref_" + cell).LIMITS
    program, control = out["program"][SEED], out["control"][SEED]
    assert all(program[f] <= limits[f] for f in limits), program
    assert any(control[f] > limits[f] for f in limits), control
