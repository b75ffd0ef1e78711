"""The GPU barotropic kernel (ops/baro_triton.py), in the Pallas interpreter on the
CPU: parity with the XLA scan on the valid region, its behaviour under shard_map,
and where the model picks it (lowered for CUDA only)."""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import orthogonalsphericalshellgrids_tpu as osg
from orthogonalsphericalshellgrids_tpu.models import (
    SplitExplicitFreeSurface, initial_state, make_model, step)
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as H
from orthogonalsphericalshellgrids_tpu.ops.baro_triton import barotropic_substeps_triton
from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC


def _setup(shape, substeps):
    nx, ny = shape
    grid = osg.TripolarGrid.make((nx, ny, 1), dtype=jnp.float32,
                                 first_pole_longitude=45.0, north_poles_latitude=35.0)
    model = make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
                       bottom_height=lambda lam, phi: np.where(phi < -78, 1.0, 0.0))
    state = initial_state(
        model,
        u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
        v=lambda lam, phi: 0.1 * np.sin(np.deg2rad(lam) * 3),
        eta=lambda lam, phi: 0.01 * np.cos(np.deg2rad(lam) * 2) * np.cos(np.deg2rad(phi) * 3),
    )
    ge = model.grid_ext
    args = (H._fill(ge, state.eta, CC, 1), H._fill(ge, state.U, FC, -1),
            H._fill(ge, state.V, CF, -1),
            H._fill(ge, H.embed_ext(model.grid, ge, model.ib.h_u * 1e-6), FC, -1),
            H._fill(ge, H.embed_ext(model.grid, ge, model.ib.h_v * -2e-6), CF, -1))
    return model, args


def _kernel(model, tile, k, dt=120.0):
    return jax.jit(partial(
        barotropic_substeps_triton, statics=H.baro_statics(model),
        dtau=model.fractional_dt * dt, weights=model.weights, g=model.g,
        tile=tile, k=k, interpret=True))


# the (16, 32) window leaves ragged last tiles in both directions on both grids;
# k = 1 and k = 4 cover one launch per substep and several substeps per launch
# (with a shorter last launch). The kernel never wraps x: on the widened x-halo
# that ``make_model`` builds, the scan with and without its per-substep x-wrap
# agree on the interior, and the kernel matches both.
@pytest.mark.parametrize("shape,substeps", [((48, 40), 12), ((64, 96), 6)])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_barotropic_pallas_matches_xla(shape, substeps, wrap, k):
    """Same operations in the same order as the scan: agreement to float32 FMA
    contraction on the extended interior (which every substep's validity covers)."""
    model, args = _setup(shape, substeps)
    ge = model.grid_ext
    ref = H.barotropic_substeps_xla(model, *args, 120.0, wrap_x_each_substep=wrap)
    out = _kernel(model, (16, 32), k)(*args)
    for name, a, b in zip(["eta", "U", "V"], ref, out):
        a, b = np.asarray(ge.interior(a)), np.asarray(ge.interior(b))
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6 * np.max(np.abs(a)),
                                   err_msg=name)


def test_barotropic_kernel_rejects_tile_without_centre():
    model, args = _setup((48, 40), 12)
    with pytest.raises(ValueError, match="no output centre"):
        _kernel(model, (16, 32), 8)(*args)


def test_barotropic_kernel_under_shard_map():
    """Under shard_map each shard runs the kernel on its own block: the same result
    as calling it on each block alone (interpreted, so without varying-axes checks,
    which the interpreter's gathers do not carry), and the sharded step, with the
    checks on, lowers for CUDA with the kernel inside."""
    from orthogonalsphericalshellgrids_tpu.parallel import (
        distribute, make_mesh, sharded_step_fn)

    model, args = _setup((48, 40), 12)
    kern = _kernel(model, (16, 32), 4)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("s",))
    stacked = [jnp.stack([a, 2.0 * a]) for a in args]
    f = jax.shard_map(lambda *a: tuple(x[None] for x in kern(*(y[0] for y in a))),
                      mesh=mesh, in_specs=(P("s"),) * 5, out_specs=(P("s"),) * 3,
                      check_vma=False)
    got = jax.jit(f)(*stacked)
    for shard in range(2):
        want = kern(*(a[shard] for a in stacked))
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g_[shard]), np.asarray(w_))

    mesh = make_mesh(2)
    dm, ds = distribute(model, initial_state(model), mesh)
    lowered = sharded_step_fn(mesh, dm).trace(ds, 60.0).lower(
        lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()


def test_step_lowers_kernel_only_for_cuda():
    """The subcycle is chosen once, by the platform the step is lowered for: the
    Triton kernel for CUDA, the XLA scan for the CPU."""
    model, _ = _setup((48, 40), 12)
    state = initial_state(model)
    traced = jax.jit(step).trace(model, state, 60.0)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda
    assert "triton" not in cpu
