"""Layered (Nz > 1) hydrostatic model tests.

The reference's workloads are all Nz = 1, so there is no Julia oracle here; the pins
are internal-consistency and physics invariants instead:

- Nz = 1 layered trajectory == the single-layer model's trajectory (the layered code
  must *reduce* to the optimized barotropic configuration);
- z-uniform initial conditions on Nz = 3 evolve each layer identically to the
  single-layer run (vertical terms vanish; the split-explicit corrector must not
  introduce spurious shear);
- total tracer content Σ c·Az·dz is conserved to round-off (zero-flux surface/floor +
  telescoping interior fluxes, incl. across the zipper fold);
- a horizontally-uniform stable stratification stays exactly at rest (the baroclinic
  pressure-gradient discretization has no spurious forcing);
- a lock-exchange buoyancy front develops the correct baroclinic shear (dense water
  intrudes at depth toward the light side).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import orthogonalsphericalshellgrids_tpu as osg
from orthogonalsphericalshellgrids_tpu.models import (
    SplitExplicitFreeSurface,
    initial_state,
    layered_initial_state,
    layered_multi_step,
    layered_step,
    make_layered_model,
    make_model,
    step,
    vertical_velocity,
)

LAM_P, PHI_P = 45.0, 25.0


def bottom(lam, phi):
    land = (
        ((np.abs(lam - LAM_P) < 10) & (np.abs(PHI_P - phi) < 10))
        | ((np.abs(lam - (LAM_P + 180.0)) < 10) & (np.abs(PHI_P - phi) < 10))
        | (phi < -78)
    )
    return np.where(land, 1.0, -1000.0)


def make_grid(nz):
    return osg.TripolarGrid.make((48, 32, nz), dtype=jnp.float64, z=(-1000.0, 0.0),
                                 first_pole_longitude=LAM_P,
                                 north_poles_latitude=PHI_P)


def ui(lam, phi):
    return 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2


def vi(lam, phi):
    return 0.05 * np.sin(np.deg2rad(lam) * 3)


def ci(lam, phi):
    return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0)


def layered_bickley(nz, substeps=8, **kw):
    model = make_layered_model(
        make_grid(nz), free_surface=SplitExplicitFreeSurface(substeps=substeps),
        bottom_height=bottom, **kw)
    state = layered_initial_state(
        model,
        u=lambda lam, phi, z: ui(lam, phi),
        v=lambda lam, phi, z: vi(lam, phi),
        c=lambda lam, phi, z: ci(lam, phi),
    )
    return model, state


def single_layer_bickley(substeps=8):
    model = make_model(
        make_grid(1), free_surface=SplitExplicitFreeSurface(substeps=substeps),
        bottom_height=bottom)
    state = initial_state(model, u=ui, v=vi, c=ci)
    return model, state


def run_layered(model, state, n, dt=60.0):
    return jax.jit(layered_multi_step, static_argnums=(3,))(model, state, dt, n)


def test_nz1_reduces_to_single_layer():
    lmodel, lstate = layered_bickley(nz=1)
    smodel, sstate = single_layer_bickley()

    ls = run_layered(lmodel, lstate, 5)
    ss = jax.jit(lambda m, s: s, static_argnums=())(smodel, sstate)
    for _ in range(5):
        ss = jax.jit(step)(smodel, ss, 60.0)

    g = lmodel.grid
    np.testing.assert_allclose(np.asarray(ls.u[0][g.interior2d]),
                               np.asarray(ss.u[g.interior2d]), rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ls.v[0][g.interior2d]),
                               np.asarray(ss.v[g.interior2d]), rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ls.c[0][g.interior2d]),
                               np.asarray(ss.c[g.interior2d]), rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ls.eta), np.asarray(ss.eta),
                               rtol=0, atol=1e-11)


def test_z_uniform_columns_stay_uniform():
    """z-uniform ICs on Nz=3: momentum/η match the single-layer run to round-off
    (vertical terms vanish and the corrector adds no shear). The tracer convention of
    static z-levels: the free-surface volume divergence lands entirely in the SURFACE
    layer (zero-flux surface + continuity puts all of w's column integral there), so
    subsurface layers stay mutually uniform and the COLUMN MEAN tracks the
    single-layer (depth-integrated) run to round-off."""
    lmodel, lstate = layered_bickley(nz=3)
    smodel, sstate = single_layer_bickley()

    n = 10
    ls = run_layered(lmodel, lstate, n)
    ss = sstate
    sj = jax.jit(step)
    for _ in range(n):
        ss = sj(smodel, ss, 60.0)

    g = lmodel.grid
    su = np.asarray(ss.u[g.interior2d])
    for k in range(3):
        np.testing.assert_allclose(np.asarray(ls.u[k][g.interior2d]), su,
                                   rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ls.eta), np.asarray(ss.eta), rtol=0, atol=1e-9)
    # subsurface layers stay mutually uniform (only the surface layer absorbs the
    # O(∂η/∂t) concentration change of the fixed-volume top cell)
    np.testing.assert_allclose(np.asarray(ls.c[1]), np.asarray(ls.c[2]), rtol=0, atol=1e-7)
    # the column-mean tracer IS the single-layer tracer
    cmean = np.asarray(jnp.mean(ls.c, axis=0)[g.interior2d])
    np.testing.assert_allclose(cmean, np.asarray(ss.c[g.interior2d]), rtol=0, atol=1e-10)


def test_layered_tracer_conservation():
    """Exact conservation of the seam-aware content functional — even though the
    initial v = 0.05·sin(3λ) drives flow THROUGH the fold seam continuously (the
    straight full-interior sum drifts at ~1e-9/step in this setup; the half-weighted
    seam row makes the fold fluxes telescope exactly)."""
    from orthogonalsphericalshellgrids_tpu.models.diagnostics import layered_tracer_content

    model, state = layered_bickley(nz=4)
    c0 = float(layered_tracer_content(model, state))
    out = run_layered(model, state, 20)
    c1 = float(layered_tracer_content(model, out))
    assert np.isfinite(np.asarray(out.c)).all()
    assert abs(c1 - c0) <= 1e-12 * abs(c0)


def test_stratification_at_rest_stays_at_rest():
    """Horizontally-uniform stable stratification, no flow: every prognostic must stay
    exactly zero (no spurious baroclinic pressure gradient, no spurious w)."""
    model = make_layered_model(
        make_grid(4), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bottom, buoyancy=True)
    N2 = 1e-5
    state = layered_initial_state(model, b=lambda lam, phi, z: N2 * z)

    out = run_layered(model, state, 10)
    assert float(jnp.max(jnp.abs(out.u))) == 0.0
    assert float(jnp.max(jnp.abs(out.v))) == 0.0
    assert float(jnp.max(jnp.abs(out.eta))) == 0.0
    # buoyancy field unchanged (advection of b by zero flow)
    np.testing.assert_allclose(np.asarray(out.b), np.asarray(state.b), rtol=0, atol=1e-12)


def test_lock_exchange_baroclinic_shear():
    """A buoyancy front in longitude drives the classic two-cell adjustment: at depth,
    flow runs from the dense side toward the light side (down the deep pressure
    gradient); the near-surface return flow is opposite — i.e. the vertical shear
    du/dz at the front has a definite sign."""
    model = make_layered_model(
        make_grid(6), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bottom, buoyancy=True, nu_v=1e-4)

    # light water (b > 0) where sin(λ) > 0, dense where < 0 — smooth front
    db = 1e-3
    state = layered_initial_state(
        model, b=lambda lam, phi, z: db * np.sin(np.deg2rad(lam)))

    out = run_layered(model, state, 20, dt=30.0)
    g = model.grid
    assert np.isfinite(np.asarray(out.u)).all()

    # sample a mid-latitude band away from poles/land: equatorial strip
    phi_u = np.asarray(g.phi_fc, np.float64)
    lam_u = np.asarray(g.lam_fc, np.float64)
    mask = np.asarray(model.mask_u3, np.float64)
    band = ((np.abs(phi_u) < 30.0)
            & (np.abs(np.cos(np.deg2rad(lam_u))) > 0.5))[None] * mask
    band[:, : g.Hy] = 0; band[:, g.Hy + g.Ny:] = 0
    band[:, :, : g.Hx] = 0; band[:, :, g.Hx + g.Nx:] = 0

    # at the front, -dxf(p) at depth points toward the light side: u_deep has the sign
    # of d(b)/dx ~ cos(λ); the surface layer carries the return flow (opposite sign).
    cosl = np.cos(np.deg2rad(lam_u))[None]
    u = np.asarray(out.u, np.float64)
    deep = (u[-1] * cosl * band[-1]).sum() / max(band[-1].sum(), 1)
    surf = (u[0] * cosl * band[0]).sum() / max(band[0].sum(), 1)
    assert deep > 0, f"deep flow should run dense->light, got mean {deep:.3e}"
    assert surf < deep, f"surface return flow should lag deep flow ({surf:.3e} vs {deep:.3e})"


def test_vertical_velocity_continuity():
    """w from continuity: each layer's interface divergence matches the horizontal
    flux divergence identically, and w vanishes on the sea floor."""
    model, state = layered_bickley(nz=4)
    g = model.grid
    from orthogonalsphericalshellgrids_tpu.ops import zipper
    from orthogonalsphericalshellgrids_tpu.ops.location import CF, FC
    from orthogonalsphericalshellgrids_tpu.ops.operators import dxc, dyc
    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import _inv

    u = zipper.fill_halos(state.u, FC, -1, g.Nx, g.Ny, g.Hx, g.Hy, xp=jnp)
    v = zipper.fill_halos(state.v, CF, -1, g.Nx, g.Ny, g.Hx, g.Hy, xp=jnp)
    w = vertical_velocity(model, u, v)
    assert w.shape == (model.nz + 1,) + g.shape2d
    np.testing.assert_allclose(np.asarray(w[-1]), 0.0, atol=0)
    hdiv = (dxc(g.dy_fc * model.dzu * u) + dyc(g.dx_cf * model.dzv * v)) * _inv(g.az_cc)
    np.testing.assert_allclose(np.asarray(w[:-1] - w[1:]), np.asarray(-hdiv), atol=1e-15)


def test_corrector_consistency_unaligned_bottom():
    """Split-explicit consistency with a bottom NOT aligned to layer interfaces:
    after a step, the quantized depth integral of the layer velocities must equal the
    subcycle-averaged barotropic transport exactly (Σ u·dzu == U_a). Regression for
    the continuous-vs-quantized corrector-depth bug (ADVICE r1)."""
    def bumpy_bottom(lam, phi):
        land = (
            ((np.abs(lam - LAM_P) < 10) & (np.abs(PHI_P - phi) < 10))
            | ((np.abs(lam - (LAM_P + 180.0)) < 10) & (np.abs(PHI_P - phi) < 10))
            | (phi < -78)
        )
        # 4 layers of 250 m over (-1000, 0): depths like 920/630 are mid-layer
        depth = -1000.0 + 370.0 / np.cosh(np.deg2rad(phi - 10) * 6) ** 2
        return np.where(land, 1.0, depth)

    model = make_layered_model(
        make_grid(4), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bumpy_bottom)
    state = layered_initial_state(
        model,
        u=lambda lam, phi, z: ui(lam, phi),
        v=lambda lam, phi, z: vi(lam, phi),
        c=lambda lam, phi, z: ci(lam, phi),
    )
    out = run_layered(model, state, 3, dt=60.0)

    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import crop_ext

    g = model.grid
    I = g.interior2d
    Ubar = np.asarray(crop_ext(g, model.grid_ext, out.U))[I]
    Uq = np.asarray(jnp.sum(out.u * model.dzu, axis=0))[I]
    # only compare where the quantized column is wet (sub-half-layer columns carry no
    # resolved layers by full-cell GridFittedBottom construction)
    wet = np.asarray(jnp.sum(model.dzu, axis=0))[I] > 0
    np.testing.assert_allclose(Uq[wet], Ubar[wet], rtol=0, atol=1e-12)
    Vbar = np.asarray(crop_ext(g, model.grid_ext, out.V))[I]
    Vq = np.asarray(jnp.sum(out.v * model.dzv, axis=0))[I]
    wetv = np.asarray(jnp.sum(model.dzv, axis=0))[I] > 0
    np.testing.assert_allclose(Vq[wetv], Vbar[wetv], rtol=0, atol=1e-12)


# --------------------------------------------------------------------------------------
# Multi-tracer + linear seawater EOS (Oceananigans tracers=(:T,:S) + SeawaterBuoyancy)
# --------------------------------------------------------------------------------------

def test_layered_multi_tracer_matches_single():
    """Each tracer of a two-tracer layered run must match the corresponding
    single-tracer run (passive planes, identical flow; allclose at round-off — the
    stacked program fuses differently)."""
    def c2(lam, phi):
        return np.cos(np.deg2rad(lam) * 2) * np.exp(-((np.deg2rad(phi) * 3) ** 2))

    m2 = make_layered_model(
        make_grid(3), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bottom, tracers=("T", "S"))
    s2 = layered_initial_state(
        m2, u=lambda l, p, z: ui(l, p), v=lambda l, p, z: vi(l, p),
        c={"T": lambda l, p, z: ci(l, p), "S": lambda l, p, z: c2(l, p)})
    assert s2.c.shape[0] == 2 * m2.nz
    s2 = run_layered(m2, s2, 4)

    for k, cfun in enumerate([ci, c2]):
        m1, _ = layered_bickley(nz=3)
        s1 = layered_initial_state(
            m1, u=lambda l, p, z: ui(l, p), v=lambda l, p, z: vi(l, p),
            c=lambda l, p, z: cfun(l, p))
        s1 = run_layered(m1, s1, 4)
        np.testing.assert_allclose(
            np.asarray(s2.c[k * 3 : (k + 1) * 3]), np.asarray(s1.c),
            rtol=1e-12, atol=1e-18, err_msg=f"tracer {k}")
        np.testing.assert_array_equal(np.asarray(s2.u), np.asarray(s1.u))


def test_layered_per_tracer_content_conserved():
    from orthogonalsphericalshellgrids_tpu.models.diagnostics import (
        layered_tracer_content)

    m = make_layered_model(
        make_grid(3), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bottom, tracers=("T", "S"))
    s0 = layered_initial_state(
        m, u=lambda l, p, z: ui(l, p), v=lambda l, p, z: vi(l, p),
        c=[lambda l, p, z: 1.0 + ci(l, p), lambda l, p, z: 2.0 - ci(l, p)])
    q0 = np.asarray(layered_tracer_content(m, s0))
    assert q0.shape == (2,)
    s = run_layered(m, s0, 5)
    q1 = np.asarray(layered_tracer_content(m, s))
    np.testing.assert_allclose(q1, q0, rtol=1e-12)


def test_linear_eos_matches_buoyancy_tracer():
    """With α·g = 1, T0 = 0 and no S tracer, b = T identically, so a
    buoyancy="linear_eos" run must reproduce the prognostic-BuoyancyTracer run
    (same planes advected, same pressure) to round-off."""
    g_b = 9.80665

    def b0(lam, phi, z):
        return 1e-4 * (z + 500.0) / 500.0 + 1e-5 * np.cos(np.deg2rad(lam))

    m_eos = make_layered_model(
        make_grid(4), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bottom, tracers=("c", "T"), buoyancy="linear_eos",
        gravitational_acceleration=g_b, thermal_expansion=1.0 / g_b,
        reference_temperature=0.0)
    s_eos = layered_initial_state(
        m_eos, u=lambda l, p, z: ui(l, p),
        c={"c": lambda l, p, z: ci(l, p), "T": b0})
    s_eos = run_layered(m_eos, s_eos, 5)

    m_bt = make_layered_model(
        make_grid(4), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bottom, buoyancy=True)
    s_bt = layered_initial_state(
        m_bt, u=lambda l, p, z: ui(l, p),
        c=lambda l, p, z: ci(l, p), b=b0)
    s_bt = run_layered(m_bt, s_bt, 5)

    nz = m_eos.nz
    np.testing.assert_allclose(np.asarray(s_eos.u), np.asarray(s_bt.u),
                               rtol=1e-10, atol=1e-16)
    np.testing.assert_allclose(np.asarray(s_eos.eta), np.asarray(s_bt.eta),
                               rtol=1e-10, atol=1e-16)
    np.testing.assert_allclose(np.asarray(s_eos.c[nz:]), np.asarray(s_bt.b),
                               rtol=1e-10, atol=1e-18)


def test_layered_tracer_validation():
    with pytest.raises(ValueError, match="unique"):
        make_layered_model(make_grid(2),
                           free_surface=SplitExplicitFreeSurface(substeps=8),
                           bottom_height=bottom, tracers=("T", "T"))
    with pytest.raises(ValueError, match='requires a "T"'):
        make_layered_model(make_grid(2),
                           free_surface=SplitExplicitFreeSurface(substeps=8),
                           bottom_height=bottom, buoyancy="linear_eos")
    m = make_layered_model(make_grid(2),
                           free_surface=SplitExplicitFreeSurface(substeps=8),
                           bottom_height=bottom, tracers=("T", "S"))
    with pytest.raises(ValueError, match="unknown tracer"):
        layered_initial_state(m, c={"X": lambda l, p, z: 0.0})


# --------------------------------------------------------------------------------------
# Stretched vertical coordinate (z as an interface array)
# --------------------------------------------------------------------------------------

def make_stretched_grid(z_faces):
    return osg.TripolarGrid.make((48, 32, len(z_faces) - 1), dtype=jnp.float64,
                                 z=z_faces, first_pole_longitude=LAM_P,
                                 north_poles_latitude=PHI_P)


def test_z_interface_validation():
    with pytest.raises(ValueError, match="strictly increasing"):
        osg.TripolarGrid.make((8, 8, 2), z=[0.0, -500.0, -1000.0])
    with pytest.raises(ValueError, match="interfaces"):
        osg.TripolarGrid.make((8, 8, 3), z=[-1000.0, -500.0, 0.0])  # Nz+1=4 needed


def test_uniform_interfaces_match_bounds():
    """z given as uniform interfaces must build the identical model/trajectory as the
    (z0, z1) tuple form."""
    ga = make_grid(4)
    gb = make_stretched_grid(np.linspace(-1000.0, 0.0, 5))
    assert gb.z_interfaces is not None
    ma = make_layered_model(ga, free_surface=SplitExplicitFreeSurface(substeps=8),
                            bottom_height=bottom, buoyancy=True)
    mb = make_layered_model(gb, free_surface=SplitExplicitFreeSurface(substeps=8),
                            bottom_height=bottom, buoyancy=True)
    np.testing.assert_allclose(ma.dz, mb.dz, rtol=0, atol=1e-12)

    def init(m):
        return layered_initial_state(
            m, u=lambda l, p, z: ui(l, p), c=lambda l, p, z: ci(l, p),
            b=lambda l, p, z: 1e-4 * (z + 500.0) / 500.0)

    sa = run_layered(ma, init(ma), 3)
    sb = run_layered(mb, init(mb), 3)
    np.testing.assert_array_equal(np.asarray(sa.u), np.asarray(sb.u))
    np.testing.assert_array_equal(np.asarray(sa.c), np.asarray(sb.c))


def test_stretched_rest_state_and_conservation():
    """On STRETCHED layers (thin near the surface), a horizontally uniform
    stratification must stay exactly at rest, tracer content must be conserved under
    flow, and with_halo must preserve the stretching."""
    from orthogonalsphericalshellgrids_tpu.models.diagnostics import (
        layered_tracer_content)

    z_faces = np.array([-1000.0, -700.0, -450.0, -250.0, -100.0, 0.0])
    grid = make_stretched_grid(z_faces)
    model = make_layered_model(grid, free_surface=SplitExplicitFreeSurface(substeps=8),
                               bottom_height=bottom, buoyancy=True)
    # per-layer thickness, surface-first: 100, 150, 200, 250, 300
    np.testing.assert_allclose(model.dz, [100.0, 150.0, 200.0, 250.0, 300.0])
    assert model.grid_ext.z_interfaces == grid.z_interfaces  # with_halo preserved it

    # resting, horizontally uniform stable stratification
    s = layered_initial_state(model, b=lambda l, p, z: 1e-4 * (z + 1000.0) / 1000.0)
    s = run_layered(model, s, 5)
    assert float(jnp.max(jnp.abs(s.u))) < 1e-14
    assert float(jnp.max(jnp.abs(s.v))) < 1e-14

    # flowing state conserves per-layer-weighted content
    s = layered_initial_state(
        model, u=lambda l, p, z: ui(l, p), v=lambda l, p, z: vi(l, p),
        c=lambda l, p, z: 1.0 + ci(l, p),
        b=lambda l, p, z: 1e-4 * (z + 1000.0) / 1000.0)
    q0 = float(layered_tracer_content(model, s))
    s = run_layered(model, s, 5)
    q1 = float(layered_tracer_content(model, s))
    assert abs(q1 - q0) <= 1e-12 * abs(q0), (q0, q1)
    assert float(jnp.max(jnp.abs(s.u))) < 5.0


# --------------------------------------------------------------------------------------
# Implicit vertical mixing (VerticallyImplicitTimeDiscretization analog)
# --------------------------------------------------------------------------------------

def test_implicit_vertical_solve_unit():
    """Direct solver pins: (I - r·Lz)·solve(q) == q with the SAME flux-form Lz the
    explicit path uses; column content Σ dz·x conserved exactly; land columns are
    identities."""
    from orthogonalsphericalshellgrids_tpu.models.layered import (
        _implicit_vertical_solve, _vertical_laplacian)

    rng = np.random.default_rng(7)
    nz, ny, nx = 5, 6, 8
    dz = (100.0, 150.0, 200.0, 250.0, 300.0)
    dzc = tuple(0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1))
    # wet from the surface down to a random depth; some fully-dry land columns
    kbot = rng.integers(0, nz + 1, size=(ny, nx))
    mask = (np.arange(nz)[:, None, None] < kbot[None]).astype(np.float64)
    q = rng.normal(size=(nz, ny, nx)) * mask
    r = 1e4 * 3600.0  # strongly implicit: r/dz² ~ 360

    qj = jnp.asarray(q)
    mj = jnp.asarray(mask)
    x = _implicit_vertical_solve(qj, r, dz, dzc, mj)

    # residual of the linear system, using the explicit operator as the oracle
    dz3 = jnp.asarray(dz).reshape(-1, 1, 1)
    dzc3 = jnp.asarray(dzc).reshape(-1, 1, 1)
    resid = x - r * _vertical_laplacian(x, dz3, dzc3, mj) - qj
    np.testing.assert_allclose(np.asarray(resid), 0.0, atol=1e-10)

    # exact column-content conservation
    np.testing.assert_allclose(np.asarray(jnp.sum(x * dz3, axis=0)),
                               np.sum(q * np.asarray(dz3), axis=0), rtol=1e-12)

    # land cells untouched (identity rows)
    np.testing.assert_array_equal(np.asarray(x) * (1 - mask), 0.0)

    # leading tracer axis broadcasts identically
    q4 = jnp.stack([qj, 2.0 * qj])
    x4 = _implicit_vertical_solve(q4, r, dz, dzc, mj)
    np.testing.assert_allclose(np.asarray(x4[0]), np.asarray(x), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(x4[1]), 2.0 * np.asarray(x), rtol=1e-12)


def test_implicit_matches_explicit_small_r():
    """For κ·dt/dz² << 1 the backward-Euler and AB2-explicit treatments integrate the
    same diffusion operator, so their trajectory difference (a) is small and (b)
    scales LINEARLY with κ (it is the first-order time-discretization difference of
    the diffusion term itself). With κ = ν = 0 the two modes must be bitwise equal."""

    def pair(kappa, nu):
        kw = dict(kappa_v=kappa, nu_v=nu, buoyancy=True)
        out = []
        for disc in ("explicit", "implicit"):
            m, _ = layered_bickley(nz=4, vertical_time_discretization=disc, **kw)
            s = layered_initial_state(
                m, u=lambda l, p, z: ui(l, p) * (1 + z / 2000.0),
                b=lambda l, p, z: 1e-5 * z)
            out.append(run_layered(m, s, 10))
        return out

    oe, oi = pair(0.0, 0.0)
    np.testing.assert_array_equal(np.asarray(oe.u), np.asarray(oi.u))
    np.testing.assert_array_equal(np.asarray(oe.b), np.asarray(oi.b))

    oe, oi = pair(0.05, 0.05)
    d1 = float(jnp.max(jnp.abs(oi.u - oe.u)))
    scale = float(jnp.max(jnp.abs(oe.u)))
    assert d1 < 2e-4 * scale, (d1, scale)
    np.testing.assert_allclose(np.asarray(oi.b), np.asarray(oe.b), atol=5e-6, rtol=0)

    oe2, oi2 = pair(0.005, 0.005)
    d2 = float(jnp.max(jnp.abs(oi2.u - oe2.u)))
    assert d2 < 0.2 * d1, (d1, d2)  # ~10x smaller at 10x smaller κ


def test_implicit_stable_and_homogenizing_at_huge_kappa():
    """κ·dt/dz² ≈ 58 — far past the explicit stability limit (1/2): the implicit run
    must stay finite, conserve tracer content exactly, and drive each wet column
    toward its thickness-weighted mean (vertical homogenization)."""
    from orthogonalsphericalshellgrids_tpu.models.diagnostics import layered_tracer_content

    kappa = 6.0e4  # m²/s; dz = 250 m, dt = 60 s -> κ·dt/dz² ≈ 57.6
    model, state = layered_bickley(
        nz=4, kappa_v=kappa, vertical_time_discretization="implicit")
    state = layered_initial_state(model, c=lambda l, p, z: 1.0 + z / 1000.0)

    q0 = float(layered_tracer_content(model, state))
    out = run_layered(model, state, 10)
    assert np.isfinite(np.asarray(out.c)).all()
    q1 = float(layered_tracer_content(model, out))
    assert abs(q1 - q0) <= 1e-12 * abs(q0)

    # interior wet columns (uniform depth -> all 4 layers wet): c -> column mean 0.5
    c = np.asarray(out.c)
    mask = np.asarray(model.mask_c3)
    g = model.grid
    full = mask.sum(0)[g.interior2d] == 4
    spread = (c.max(0) - c.min(0))[g.interior2d][full]
    assert float(spread.max()) < 0.02, float(spread.max())  # from initial spread 0.75

    # the same configuration run EXPLICITLY must blow up — the unstable mode grows
    # ~|1 - 4κΔt/dz²| ≈ 230x per step (documents why the implicit solver exists)
    me, se = layered_bickley(nz=4, kappa_v=kappa)
    se = layered_initial_state(me, c=lambda l, p, z: 1.0 + z / 1000.0)
    oe = run_layered(me, se, 10)
    assert float(jnp.max(jnp.abs(oe.c))) > 1e6


def test_layered_fill_modes_bitwise_equal():
    """The serial per-group broadcast fill ('per', the serial default) must write
    bitwise the same halos as the concatenated batch fill ('batch', the SPMD
    layout), for every fill group (u, v, c-stack, b); buoyancy + multi-tracer so all
    groups exist. Stepped under jit, the two modes hand XLA differently shaped
    operands (group arrays vs slices of one stack), and XLA:CPU fuses the tendency
    arithmetic around them differently: FMA contraction moves the last bit of a few
    near-cancelling cells (observed: <= 3.5e-18 on fields of size 5e-2 in float64).
    So the stepped states are held to a float64 round-off band, 1e-14 of each
    field's magnitude, which a wrong halo (O(1) of the field) cannot pass."""
    from orthogonalsphericalshellgrids_tpu.models import layered as L
    from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC

    m = make_layered_model(
        make_grid(3), free_surface=SplitExplicitFreeSurface(substeps=8),
        bottom_height=bottom, tracers=("T", "S"), buoyancy=True)
    s0 = layered_initial_state(
        m, u=lambda l, p, z: ui(l, p), v=lambda l, p, z: vi(l, p),
        c={"T": lambda l, p, z: ci(l, p)}, b=lambda l, p, z: 1e-4 * ci(l, p))

    nz, ncp = m.nz, s0.c.shape[0]
    groups = [(s0.u, FC, -1), (s0.v, CF, -1), (s0.c, CC, 1), (s0.b, CC, 1)]
    per = [L._fill3(m, a, loc, sign) for a, loc, sign in groups]
    locs = [loc for a, loc, _ in groups for _ in range(a.shape[0])]
    signs = [sign for a, _, sign in groups for _ in range(a.shape[0])]
    S = L._fill_batch(m.grid, jnp.concatenate([a for a, _, _ in groups]), locs, signs)
    batch = [S[:nz], S[nz:2 * nz], S[2 * nz:2 * nz + ncp], S[2 * nz + ncp:]]
    for name, a, b in zip("uvcb", per, batch):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)

    run = jax.jit(layered_multi_step, static_argnums=(3, 4, 5))
    s_per = run(m, s0, 60.0, 4, None, "per")
    s_bat = run(m, s0, 60.0, 4, None, "batch")
    for name in ("u", "v", "c", "b", "eta", "U", "V"):
        a = np.asarray(getattr(s_per, name))
        b = np.asarray(getattr(s_bat, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14 * np.max(np.abs(b)),
                                   err_msg=name)
