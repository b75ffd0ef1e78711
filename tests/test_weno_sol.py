"""Guards for the WENO-5 work accounting (benchmarks/weno_sol.py): the analytic
flop total and the equivalence of the timed body to the production reconstruction."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_weno_sol():
    spec = importlib.util.spec_from_file_location(
        "weno_sol", _ROOT / "benchmarks" / "weno_sol.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_analytic_totals_match_docs():
    # docs/performance.md pins 70 flops per upwind reconstruction; if the table
    # changes, the documented count must be re-derived.
    mod = _load_weno_sol()
    rows, F = mod.analytic_table()
    assert F == 70
    assert all(f >= 0 for _, f in rows)


def test_xla_body_matches_production_reconstruction():
    # the XLA-fused rate measures the real `_weno5_left` on rolled taps: check the
    # tap layout against the production face reconstruction away from wrap edges
    from orthogonalsphericalshellgrids_tpu.ops.advection import (
        _weno5_left, weno5_faces_from_centers)

    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.standard_normal((8, 64)), jnp.float32)
    m1 = jnp.roll(c, 1, 1)
    m2 = jnp.roll(c, 2, 1)
    m3 = jnp.roll(c, 3, 1)
    p1 = jnp.roll(c, -1, 1)
    probe_left = _weno5_left(m3, m2, m1, c, p1)
    left, _ = weno5_faces_from_centers(c, axis=1)
    np.testing.assert_allclose(np.asarray(probe_left)[:, 4:-4],
                               np.asarray(left)[:, 4:-4], rtol=0, atol=0)
