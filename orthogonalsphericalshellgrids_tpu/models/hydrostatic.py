"""Hydrostatic free-surface model on a tripolar grid (barotropic configuration).

JAX build of the model engine the reference's Bickley-jet workloads exercise
through Oceananigans (SURVEY.md O5/O6/O7, call stack §3.4):

- vector-invariant momentum with upwinded WENO-5 vorticity reconstruction
  (``WENOVectorInvariant(vorticity_order=5)``, examples/bickley_jet.jl:49),
- flux-form WENO-5 tracer advection (examples/bickley_jet.jl:48),
- split-explicit free surface with SM05-averaged forward-backward substeps integrated
  in *widened* y-halos so the substep loop is communication-free
  (pinned by test/runtests.jl:52-71),
- quasi-Adams-Bashforth-2 time stepping (χ = 0.1, forward Euler on the first step),
- grid-fitted immersed boundary masking (examples/bickley_jet.jl:26-29).

Design (SURVEY.md §7): the model is a frozen pytree of precomputed device arrays
(metric reciprocals, masks, column depths — on both the base grid and the
extended-halo free-surface grid); the state is an immutable pytree of halo-inclusive
2-D fields ``(u, v, η, U, V, tracers, previous tendencies)``; ``step`` is one pure
jitted function; all halo logic is fused data movement (ops/zipper.py). The current
implementation is the depth-integrated (single-layer) configuration — exactly the
regime of every reference workload (Nz = 1 everywhere in examples and tests).

Exact numerical parity caveat: the reference's scheme internals live in Oceananigans
(not in the reference repo); the discretizations here follow the standard published
forms (Arakawa C-grid vector invariant, WENO-Z, SM05 averaging) and are pinned by
physics tests (fold symmetry, conservation, vortex transport) rather than bitwise
comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..grids.immersed import ImmersedBoundary, make_immersed_boundary
from ..grids.tripolar import TripolarGrid, with_halo
from ..ops import zipper
from ..ops.spmd import Spmd, fill_halos_spmd, fill_halos_spmd_batch
from ..ops.spmd2d import Spmd2D, fill_halos_spmd2d_batch
from ..ops.advection import (centered_faces_from_centers, tracer_faces,
                             weno5_upwind_centers_from_faces,
                             weno5_upwind_faces_from_centers)
from ..ops.location import CC, CF, FC
from ..ops.operators import dxc, dxf, dyc, dyf, ixc, ixf, iyc, iyf
from .split_explicit import SplitExplicitFreeSurface

__all__ = ["HydrostaticModel", "State", "make_model", "step", "multi_step", "compute_cfl_dt", "vorticity"]

_CHI = 0.1  # quasi-AB2 parameter (Oceananigans default)


# --------------------------------------------------------------------------------------
# State and model pytrees
# --------------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class State:
    """Prognostic state. u/v/c on base-halo arrays; η/U/V on extended-halo arrays
    (the free-surface fields live on the widened grid — reference ``with_halo`` path)."""

    u: Any
    v: Any
    eta: Any
    U: Any
    V: Any
    c: Any
    Gu: Any
    Gv: Any
    Gc: Any
    t: Any
    iteration: Any


@dataclasses.dataclass(frozen=True)
class HydrostaticModel:
    """Static model configuration + precomputed device arrays (a frozen pytree)."""

    grid: TripolarGrid
    grid_ext: TripolarGrid
    ib: ImmersedBoundary          # on the base grid
    # reciprocal metrics, base grid (0 where the metric degenerates at the poles)
    inv_dx_fc: Any
    inv_dy_cf: Any
    inv_az_ff: Any
    inv_vol_c: Any                # mask_c / (Az_cc * h_c)
    # extended (free-surface) grid arrays
    inv_dx_fc_e: Any
    inv_dy_cf_e: Any
    inv_az_cc_e: Any
    dy_fc_e: Any
    dx_cf_e: Any
    h_u_e: Any
    h_v_e: Any
    mask_u_e: Any
    mask_v_e: Any
    # barotropic averaging weights (device array)
    weights: Any
    # coriolis frequency at FF points (0 array when disabled)
    f_ff: Any
    # kinematic surface wind stress at u/v points (0 arrays when disabled)
    taux: Any
    tauy: Any
    # static metadata
    substeps: int
    fractional_dt: float
    g: float
    coriolis: bool
    tracer_advection: str
    momentum_advection: str
    tracer_names: tuple      # ("c",) -> State.c is (Ye, Xe); else (n, Ye, Xe) stacked
    forcing: tuple           # ((target, fn), ...): user forcing terms added to G
    wind: bool
    drag_type: str      # "none" | "linear" | "quadratic"
    drag_coeff: float
    nu_h: float         # horizontal viscosity (m^2/s; 0 disables)
    kappa_h: float      # horizontal tracer diffusivity (m^2/s; 0 disables)
    nu4_h: float        # horizontal biharmonic viscosity (m^4/s; 0 disables)
    kappa4_h: float     # horizontal biharmonic tracer diffusivity (m^4/s; 0 disables)

    # convenience
    @property
    def dtype(self):
        return self.grid.dtype


_MODEL_ARRAYS = [
    "grid", "grid_ext", "ib",
    "inv_dx_fc", "inv_dy_cf", "inv_az_ff", "inv_vol_c",
    "inv_dx_fc_e", "inv_dy_cf_e", "inv_az_cc_e", "dy_fc_e", "dx_cf_e",
    "h_u_e", "h_v_e", "mask_u_e", "mask_v_e", "weights", "f_ff",
    "taux", "tauy",
]
_MODEL_META = ["substeps", "fractional_dt", "g", "coriolis",
               "tracer_advection", "momentum_advection", "tracer_names", "forcing",
               "wind", "drag_type", "drag_coeff", "nu_h", "kappa_h", "nu4_h",
               "kappa4_h"]

for _cls, _data, _meta in [
    (State, [f.name for f in dataclasses.fields(State)], []),
    (HydrostaticModel, _MODEL_ARRAYS, _MODEL_META),
]:
    jax.tree_util.register_dataclass(_cls, data_fields=_data, meta_fields=_meta)


# --------------------------------------------------------------------------------------
# Halo fill helpers
# --------------------------------------------------------------------------------------

def _fill(grid: TripolarGrid, A, loc, sign, spmd=None):
    """Serial or SPMD halo fill; ``spmd`` (ops.spmd.Spmd) selects the sharded path
    with ppermute neighbor exchange inside shard_map."""
    if spmd is None or spmd.n_shards == 1:
        return zipper.fill_halos(A, loc, sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
                                 south="zero_gradient", xp=jnp)
    return fill_halos_spmd(A, loc, sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy, spmd)


def _fill_batch(grid: TripolarGrid, S, locs, signs, spmd=None):
    """Batched halo fill of a (K, y, x) stack — one shared op set / one collective
    pair (1-D) or a 2-phase exchange + fold gather (2-D) for all planes."""
    if isinstance(spmd, Spmd2D):
        return fill_halos_spmd2d_batch(S, locs, signs, grid.Nx, grid.Ny, grid.Hx,
                                       grid.Hy, spmd)
    if spmd is None or spmd.n_shards == 1:
        return zipper.fill_halos_batch(S, locs, signs, grid.Nx, grid.Ny, grid.Hx,
                                       grid.Hy, south="zero_gradient", xp=jnp)
    return fill_halos_spmd_batch(S, locs, signs, grid.Nx, grid.Ny, grid.Hx, grid.Hy, spmd)


def _stack_uvc(u, v, c):
    """Stack (u, v, tracers) into one (2 + n_tracers, Ye, Xe) fill batch; a 2-D c is
    a single plane, a 3-D c contributes its planes."""
    uv = jnp.stack([u, v])
    return jnp.concatenate([uv, c[None] if c.ndim == 2 else c], axis=0)


def _uvc_locs_signs(c):
    n = 1 if c.ndim == 2 else c.shape[0]
    return [FC, CF] + [CC] * n, [-1, -1] + [1] * n


def _unstack_uvc(S, c_like):
    """Inverse of _stack_uvc: (u, v, c) with c matching c_like's layout."""
    return S[0], S[1], (S[2] if c_like.ndim == 2 else S[2:])


def embed_ext(grid: TripolarGrid, grid_ext: TripolarGrid, A):
    """Pad a base-halo array into the extended-halo layout (y always; x too when the
    free-surface grid carries widened x-halos — the 2-D decomposition path)."""
    dy = grid_ext.Hy - grid.Hy
    dx = grid_ext.Hx - grid.Hx
    return jnp.pad(A, ((dy, dy), (dx, dx)))


def crop_ext(grid: TripolarGrid, grid_ext: TripolarGrid, A):
    dy = grid_ext.Hy - grid.Hy
    dx = grid_ext.Hx - grid.Hx
    return A[dy : dy + grid.Ny + 2 * grid.Hy, dx : dx + grid.Nx + 2 * grid.Hx]


# --------------------------------------------------------------------------------------
# Model construction
# --------------------------------------------------------------------------------------

def _inv(m):
    return jnp.where(m > 0, 1.0 / jnp.where(m > 0, m, 1.0), 0.0)


def make_model(
    grid: TripolarGrid,
    free_surface: SplitExplicitFreeSurface | None = None,
    bottom_height=None,
    coriolis: bool = False,
    rotation_rate: float = 7.292115e-5,
    tracer_advection: str = "weno5",
    momentum_advection: str = "weno_vector_invariant",
    tracers: tuple = ("c",),  # tracer names (the reference's ``tracers=(:c, ...)``);
                              # >1 name stacks State.c as (n_tracers, Ye, Xe)
    forcing=None,           # {target: fn} user forcing (Oceananigans ``Forcing``):
                            # target in {"u","v"} | tracers; fn(λ°, φ°, t, fields) ->
                            # tendency contribution [per s]; fields has .u/.v/.c
                            # (halo-filled) for field-dependent terms (sponges,
                            # relaxation). Must be jnp-traceable (jitted with t traced).
    wind_stress=None,       # callable (λ°, φ°) -> (τx, τy) kinematic stress [m²/s²]
    bottom_drag=None,       # ("linear", r [m/s]) or ("quadratic", Cd [-])
    nu_h: float = 0.0,      # horizontal viscosity [m²/s]
    kappa_h: float = 0.0,   # horizontal tracer diffusivity [m²/s]
    nu4_h: float = 0.0,     # horizontal biharmonic viscosity [m⁴/s]
    kappa4_h: float = 0.0,  # horizontal biharmonic tracer diffusivity [m⁴/s]
) -> HydrostaticModel:
    """Assemble the model: widen the free-surface grid's y-halo per the split-explicit
    rule (with_halo; Hy_ext = len(weights)+1, test/runtests.jl:58-71), precompute
    reciprocal metrics, masks and column depths on both grids.

    A tripolar-grid model *requires* an explicit free-surface configuration — mirroring
    the reference pin that a plain model throws (test/runtests.jl:50).
    """
    if free_surface is None:
        raise ValueError(
            "A tripolar-grid model requires an explicit SplitExplicitFreeSurface "
            "configuration (the reference rejects the default free surface too)."
        )
    tracers = tuple(str(t) for t in tracers)
    if len(tracers) == 0 or len(set(tracers)) != len(tracers):
        raise ValueError(f"tracers must be a non-empty tuple of unique names, got {tracers!r}")
    from ..ops.advection import SCHEME_RADIUS, TRACER_SCHEMES

    if tracer_advection not in TRACER_SCHEMES:
        raise ValueError(
            f"unknown tracer_advection {tracer_advection!r}; options: {TRACER_SCHEMES}")
    radius = SCHEME_RADIUS[tracer_advection]
    if min(grid.Hx, grid.Hy) < radius:
        raise ValueError(
            f"tracer_advection={tracer_advection!r} consumes {radius} halo cells per "
            f"side but the grid halo is ({grid.Hx}, {grid.Hy}) — rebuild the grid "
            f"with halo >= {radius} (the reference widens halos the same way)")
    if (nu4_h > 0.0 or kappa4_h > 0.0) and min(grid.Hx, grid.Hy) < 2:
        # biharmonic = laplacian∘laplacian: 2 halo cells of validity per side; the
        # advection-radius check above doesn't cover this when the scheme radius is 1
        raise ValueError(
            f"biharmonic closures (nu4_h/kappa4_h) consume 2 halo cells per side but "
            f"the grid halo is ({grid.Hx}, {grid.Hy}) — rebuild the grid with halo >= 2")
    forcing = dict(forcing or {})
    valid_targets = {"u", "v", *tracers}
    unknown = set(forcing) - valid_targets
    if unknown:
        raise ValueError(f"forcing targets {sorted(unknown)} not in {sorted(valid_targets)}")
    forcing = tuple(forcing.items())
    hy_ext = max(free_surface.required_y_halo, grid.Hy)
    # The x-halo is widened like y so the barotropic loop is communication- AND
    # wrap-free in both directions (validity shrinks one row/column per substep).
    # Mandatory for 2-D decompositions (x is sharded, no local wrap exists); for
    # serial/1-D runs it drops the per-substep x-wrap strip writes, with
    # bitwise-equal results.
    hx_ext = max(free_surface.required_y_halo, grid.Hx)
    grid_ext = with_halo(grid, (hx_ext, hy_ext, grid.Hz))

    if bottom_height is None:
        bottom_height = lambda lam, phi: np.full_like(lam, grid.z_bounds[0] - 1.0)  # all ocean
    ib = make_immersed_boundary(grid, bottom_height)
    ib_e = make_immersed_boundary(grid_ext, bottom_height)

    # Footgun guard: at the two fictitious poles the cell width degenerates (dx -> 0),
    # so an UNMASKED pole cell makes the barotropic substeps CFL-unstable there (seen
    # as eta blowing up at phi = north_poles_latitude within ~10 steps in float64).
    # The reference's workloads always mask the poles with an immersed boundary
    # (examples/bickley_jet.jl:26-29) — warn if this model does not.
    dx_i = np.asarray(grid.interior(grid.dx_cc), np.float64)
    wet = np.asarray(grid.interior(ib.mask_c), np.float64) > 0
    if wet.any():
        dx_wet = dx_i[wet]
        if dx_wet.min() < 1e-3 * np.median(dx_wet):
            import warnings

            warnings.warn(
                "Tripolar pole singularities are not masked: the smallest wet cell is "
                f"{dx_wet.min():.3g} m wide (median {np.median(dx_wet):.3g} m). The "
                "barotropic substeps will violate CFL there and blow up; mask the two "
                "poles with bottom_height (see examples/bickley_jet.py).",
                stacklevel=2,
            )

    dt = grid.dtype

    # One fused jit for every derived array instead of an eager op (and a
    # compile) per array.
    @jax.jit
    def _derived(g_dx_fc, g_dy_cf, g_az_ff, g_az_cc, h_c, mask_c,
                 ge_dx_fc, ge_dy_cf, ge_az_cc, phi_ff):
        f_ff = (
            2.0 * rotation_rate * jnp.sin(jnp.deg2rad(phi_ff))
            if coriolis else jnp.zeros_like(phi_ff)
        ).astype(dt)
        inv_dx_fc = _inv(g_dx_fc)
        inv_dy_cf = _inv(g_dy_cf)
        inv_az_ff = _inv(g_az_ff)
        inv_vol_c = mask_c * _inv(g_az_cc * h_c)
        return (
            inv_dx_fc, inv_dy_cf, inv_az_ff, inv_vol_c,
            _inv(ge_dx_fc), _inv(ge_dy_cf), _inv(ge_az_cc), f_ff,
        )

    (inv_dx_fc, inv_dy_cf, inv_az_ff, inv_vol_c,
     inv_dx_fc_e, inv_dy_cf_e, inv_az_cc_e, f_ff) = _derived(
        grid.dx_fc, grid.dy_cf, grid.az_ff, grid.az_cc, ib.h_c, ib.mask_c,
        grid_ext.dx_fc, grid_ext.dy_cf, grid_ext.az_cc, grid.phi_ff)

    # kinematic wind stress sampled at the staggered velocity points (masked: no
    # stress on land)
    zero2 = jnp.zeros(grid.shape2d, dt)
    taux = tauy = zero2
    wind = wind_stress is not None
    if wind:
        lam_u = np.asarray(grid.lam_fc, np.float64)
        phi_u = np.asarray(grid.phi_fc, np.float64)
        lam_v = np.asarray(grid.lam_cf, np.float64)
        phi_v = np.asarray(grid.phi_cf, np.float64)
        tx_u, _ = wind_stress(lam_u, phi_u)
        _, ty_v = wind_stress(lam_v, phi_v)
        taux = jnp.asarray(np.broadcast_to(tx_u, grid.shape2d), dt) * ib.mask_u
        tauy = jnp.asarray(np.broadcast_to(ty_v, grid.shape2d), dt) * ib.mask_v

    drag_type, drag_coeff = "none", 0.0
    if bottom_drag is not None:
        drag_type, drag_coeff = bottom_drag
        if drag_type not in ("linear", "quadratic"):
            raise ValueError(f"bottom_drag type must be linear|quadratic, got {drag_type!r}")

    return HydrostaticModel(
        grid=grid,
        grid_ext=grid_ext,
        ib=ib,
        inv_dx_fc=inv_dx_fc,
        inv_dy_cf=inv_dy_cf,
        inv_az_ff=inv_az_ff,
        inv_vol_c=inv_vol_c,
        inv_dx_fc_e=inv_dx_fc_e,
        inv_dy_cf_e=inv_dy_cf_e,
        inv_az_cc_e=inv_az_cc_e,
        dy_fc_e=grid_ext.dy_fc,
        dx_cf_e=grid_ext.dx_cf,
        h_u_e=ib_e.h_u,
        h_v_e=ib_e.h_v,
        mask_u_e=ib_e.mask_u,
        mask_v_e=ib_e.mask_v,
        weights=jnp.asarray(free_surface.weights, dtype=dt),
        f_ff=f_ff,
        substeps=free_surface.substeps,
        fractional_dt=float(free_surface.fractional_dt),
        g=float(free_surface.gravitational_acceleration),
        coriolis=coriolis,
        tracer_advection=tracer_advection,
        momentum_advection=momentum_advection,
        tracer_names=tracers,
        forcing=forcing,
        taux=taux,
        tauy=tauy,
        wind=wind,
        drag_type=drag_type,
        drag_coeff=float(drag_coeff),
        nu_h=float(nu_h),
        kappa_h=float(kappa_h),
        nu4_h=float(nu4_h),
        kappa4_h=float(kappa4_h),
    )


def initial_state(model: HydrostaticModel, u=None, v=None, c=None, eta=None) -> State:
    """Build the initial state from functions of (λ, φ) in degrees evaluated at the
    proper staggered locations (the reference's ``set!(model, u=uᵢ, ...)`` semantics,
    examples/bickley_jet.jl:70-73).

    With multiple tracers (``make_model(..., tracers=("T", "S"))``), ``c`` may be a
    dict ``{name: fn}`` (missing names start at 0) or a sequence of fns in
    ``tracer_names`` order; ``State.c`` is then the (n_tracers, Ye, Xe) stack."""
    g = model.grid
    dt = model.dtype

    def sample_full(fn, lam, phi):
        if fn is None:
            return jnp.zeros(g.shape2d, dt)
        out = np.broadcast_to(
            np.asarray(fn(np.asarray(lam, np.float64), np.asarray(phi, np.float64))), g.shape2d
        )
        full = np.zeros(g.shape2d)
        full[g.interior2d] = out[g.interior2d]
        return jnp.asarray(full, dt)

    names = model.tracer_names
    if len(names) == 1 and not isinstance(c, (dict, list, tuple)):
        c_raw = sample_full(c, g.lam_cc, g.phi_cc)
    else:
        if c is None:
            fns = [None] * len(names)
        elif isinstance(c, dict):
            unknown = set(c) - set(names)
            if unknown:
                raise ValueError(f"unknown tracer names {sorted(unknown)}; "
                                 f"model tracers are {names}")
            fns = [c.get(nm) for nm in names]
        else:
            if len(c) != len(names):
                raise ValueError(f"got {len(c)} tracer initializers for "
                                 f"{len(names)} tracers {names}")
            fns = list(c)
        c_raw = jnp.stack([sample_full(fn, g.lam_cc, g.phi_cc) for fn in fns])
        if len(names) == 1:
            c_raw = c_raw[0]

    u_raw = sample_full(u, g.lam_fc, g.phi_fc)
    v_raw = sample_full(v, g.lam_cf, g.phi_cf)
    eta_raw = sample_full(eta, g.lam_cc, g.phi_cc)

    @jax.jit
    def _assemble(u_raw, v_raw, c_raw, eta_raw, mask_u, mask_v, mask_c, h_u, h_v):
        u0 = u_raw * mask_u
        v0 = v_raw * mask_v
        c0 = c_raw * mask_c
        eta0 = eta_raw * mask_c
        U0 = embed_ext(g, model.grid_ext, h_u * u0)
        V0 = embed_ext(g, model.grid_ext, h_v * v0)
        eta_e = embed_ext(g, model.grid_ext, eta0)
        zero = jnp.zeros(g.shape2d, dt)
        return State(
            u=u0, v=v0, eta=eta_e, U=U0, V=V0, c=c0,
            Gu=zero, Gv=zero, Gc=jnp.zeros_like(c0),
            t=jnp.zeros((), dt), iteration=jnp.zeros((), jnp.int32),
        )

    return _assemble(u_raw, v_raw, c_raw, eta_raw,
                     model.ib.mask_u, model.ib.mask_v, model.ib.mask_c,
                     model.ib.h_u, model.ib.h_v)


# --------------------------------------------------------------------------------------
# Dynamics
# --------------------------------------------------------------------------------------

def vorticity(model: HydrostaticModel, u, v):
    """ζ at FF: (δxᶠ(Δyᶜᶠ v) − δyᶠ(Δxᶠᶜ u)) / Azᶠᶠ — the reference's
    VerticalVorticityField diagnostic (SURVEY.md O9). Inputs must be halo-filled."""
    g = model.grid
    return (dxf(g.dy_cf * v) - dyf(g.dx_fc * u)) * model.inv_az_ff


class ForcingFields(NamedTuple):
    """Halo-filled prognostics handed to user forcing functions (Oceananigans's
    ``field_dependencies``): relaxation/sponge terms read these. ``b`` is the
    prognostic buoyancy in the layered tracer_b mode (None elsewhere)."""

    u: Any
    v: Any
    c: Any
    b: Any = None


def tendencies(model: HydrostaticModel, u, v, c, t=0.0):
    """Interior tendencies G_u, G_v (vector-invariant, no surface-pressure term — that
    is barotropic) and G_c (flux-form WENO). Inputs must be halo-filled; ``t`` is the
    model time handed to user forcing functions."""
    g = model.grid
    ib = model.ib

    # vorticity reconstruction scheme (the reference's WENOVectorInvariant upwinds the
    # vorticity stencil; 'vector_invariant' uses centered/enstrophy-style interpolation)
    upwind_q = model.momentum_advection == "weno_vector_invariant"
    zeta = vorticity(model, u, v)
    q = zeta + model.f_ff if model.coriolis else zeta

    # --- u-equation (FC): + q̃ v̂ − δxᶠ(K)/Δxᶠᶜ
    v_hat = ixf(iyc(g.dx_cf * v)) * model.inv_dx_fc
    if upwind_q:
        q_at_u = weno5_upwind_centers_from_faces(q, v_hat, axis=-2)
    else:
        q_at_u = iyc(q)
    ke = 0.5 * (ixc(u * u) + iyc(v * v))
    Gu = (q_at_u * v_hat - dxf(ke) * model.inv_dx_fc) * ib.mask_u

    # --- v-equation (CF): − q̃ û − δyᶠ(K)/Δyᶜᶠ
    u_hat = iyf(ixc(g.dy_fc * u)) * model.inv_dy_cf
    if upwind_q:
        q_at_v = weno5_upwind_centers_from_faces(q, u_hat, axis=-1)
    else:
        q_at_v = ixc(q)
    Gv = (-q_at_v * u_hat - dyf(ke) * model.inv_dy_cf) * ib.mask_v

    # --- tracer (CC): flux-form advection (WENO-5 upwind or centered, the reference's
    # FluxFormAdvection(WENO/Centered) options); transports carry the column depth so
    # the advected content is conserved against the free-surface divergence
    cx = tracer_faces(c, u, axis=-1, scheme=model.tracer_advection)
    cy = tracer_faces(c, v, axis=-2, scheme=model.tracer_advection)
    fx = u * ib.h_u * g.dy_fc * cx
    fy = v * ib.h_v * g.dx_cf * cy
    Gc = -(dxc(fx) + dyc(fy)) * model.inv_vol_c

    # --- optional forcing / closures (compiled out when disabled — static flags).
    # In the depth-integrated configuration, surface stress and bottom drag act on the
    # whole column: force/h (so the barotropic forcing h·G recovers the raw stress).
    if model.wind or model.drag_type != "none":
        inv_h_u = _inv(ib.h_u)
        inv_h_v = _inv(ib.h_v)
        if model.wind:
            Gu = Gu + model.taux * inv_h_u
            Gv = Gv + model.tauy * inv_h_v
        if model.drag_type == "linear":
            Gu = Gu - model.drag_coeff * u * inv_h_u * ib.mask_u
            Gv = Gv - model.drag_coeff * v * inv_h_v * ib.mask_v
        elif model.drag_type == "quadratic":
            sp_u = jnp.sqrt(u * u + ixf(iyc(v)) ** 2)
            sp_v = jnp.sqrt(v * v + iyf(ixc(u)) ** 2)
            Gu = Gu - model.drag_coeff * sp_u * u * inv_h_u * ib.mask_u
            Gv = Gv - model.drag_coeff * sp_v * v * inv_h_v * ib.mask_v
    if model.nu_h > 0.0:
        from ..ops.closures import laplacian_u, laplacian_v

        Gu = Gu + model.nu_h * laplacian_u(g, u, ib.mask_u, ib.mask_c)
        Gv = Gv + model.nu_h * laplacian_v(g, v, ib.mask_v, ib.mask_c)
    if model.kappa_h > 0.0:
        from ..ops.closures import laplacian_c

        Gc = Gc + model.kappa_h * laplacian_c(g, c, ib.mask_c, ib.mask_u, ib.mask_v)
    if model.nu4_h > 0.0:
        from ..ops.closures import biharmonic_u, biharmonic_v

        Gu = Gu - model.nu4_h * biharmonic_u(g, u, ib.mask_u, ib.mask_c)
        Gv = Gv - model.nu4_h * biharmonic_v(g, v, ib.mask_v, ib.mask_c)
    if model.kappa4_h > 0.0:
        from ..ops.closures import biharmonic_c

        Gc = Gc - model.kappa4_h * biharmonic_c(g, c, ib.mask_c, ib.mask_u, ib.mask_v)

    # --- user forcing (Oceananigans ``Forcing``): pointwise, so the interior/boundary
    # overlap split stays exact (strip passes see row-sliced λ/φ and strip fields)
    if model.forcing:
        fields = ForcingFields(u=u, v=v, c=c)
        for name, fn in model.forcing:
            if name == "u":
                Gu = Gu + fn(g.lam_fc, g.phi_fc, t, fields) * ib.mask_u
            elif name == "v":
                Gv = Gv + fn(g.lam_cf, g.phi_cf, t, fields) * ib.mask_v
            else:
                contrib = fn(g.lam_cc, g.phi_cc, t, fields) * ib.mask_c
                if c.ndim == 2:
                    Gc = Gc + contrib
                else:
                    idx = model.tracer_names.index(name)
                    Gc = Gc.at[idx].add(contrib)

    return Gu, Gv, Gc


def _model_rows(model: HydrostaticModel, r0: int, r1: int) -> HydrostaticModel:
    """Row-sliced view of the model for boundary-strip tendency recompute: every
    BASE-layout array leaf keeps rows [r0, r1); extended-halo and replicated leaves
    pass through untouched (``tendencies`` never reads them). Layout tags come from
    parallel/layouts.py (imported lazily — parallel imports this module)."""
    from ..parallel import layouts

    def sl(path, leaf):
        if layouts.leaf_layout(path) != layouts.BASE or getattr(leaf, "ndim", 0) < 2:
            return leaf
        return leaf[..., r0:r1, :]

    return jax.tree_util.tree_map_with_path(sl, model)


def _model_cols(model, c0: int, c1: int):
    """Column-sliced model view — the x-direction analog of ``_model_rows`` for the
    2-D decomposition's west/east boundary strips."""
    from ..parallel import layouts

    def sl(path, leaf):
        if layouts.leaf_layout(path) != layouts.BASE or getattr(leaf, "ndim", 0) < 2:
            return leaf
        return leaf[..., :, c0:c1]

    return jax.tree_util.tree_map_with_path(sl, model)


def overlap_radius(model) -> int:
    """Effective horizontal stencil radius of one tendency evaluation (rows/columns a
    tendency at cell j can read beyond j). Tracer flux form: G at cell j reads faces
    j..j+1, and face j+1's reconstruction reads cells up to j+SCHEME_RADIUS (3 for
    WENO-5) — the outer divergence adds nothing beyond the reconstruction radius.
    Momentum (vector-invariant, WENO-5 vorticity): q_at_u at row j reconstructs from
    q faces j-2..j+3, each a radius-1 curl reading u/v rows jf-1..jf — radius 3.
    Closures (biharmonic: 2) and vertical terms (radius 1) are smaller for every
    supported configuration."""
    from ..ops.advection import SCHEME_RADIUS

    r_mom = 3 if model.momentum_advection == "weno_vector_invariant" else 2
    return max(r_mom, SCHEME_RADIUS[model.tracer_advection])


def overlap_supported(model, grid) -> bool:
    """Static check that the interior/boundary split is exact on this grid.

    Bitwise equality of the split requires every KEPT bulk cell to read only cells
    where the stale local array equals the exchanged one. In y that means
    radius <= Hy - 1 — strictly less than Hy, because the zipper fold rewrites the
    redundant half of the LAST INTERIOR ROW itself (ops/zipper.py, reference
    ``src/zipper_boundary_condition.jl:95-104``), so the top kept row must not reach
    row Ny. In x (2-D decomposition) radius <= Hx suffices (no interior column is
    rewritten). The default halo (5) supports every radius-<=4 configuration; e.g.
    weno7 on its minimum halo-4 grid does NOT split exactly and falls back to the
    unsplit path."""
    r = overlap_radius(model)
    # Ny >= Hy keeps the 3*Hy-row strips in bounds; if the two patches overlap
    # (Ny < 2*Hy) both write identical S_full-derived values, so exactness holds.
    return r <= grid.Hy - 1 and r <= grid.Hx and grid.Ny >= grid.Hy


def split_tendencies(model, groups, locs, signs, spmd, tend_from_groups, t):
    """Generic interior/boundary-split tendency evaluation (SURVEY.md §2.3's
    comm/compute overlap; reference context ``src/distributed_tripolar_grid.jl:171``).

    The unsplit path makes the WHOLE tendency compute data-dependent on the halo
    exchange (the stencils read the concatenated exchanged rows/columns), so XLA
    cannot overlap them. Here the dependency is cut by construction:

    - the bulk tendency pass runs on the LOCAL stack with no collective dependence
      (1-D mesh: only the local periodic x-wrap applied; 2-D mesh: no fill at all —
      x halos are remote), so the scheduler is free to run the ppermute/all_gather
      exchange concurrently with it;
    - cells whose stencils reach exchanged data — the Hy interior rows at each y end
      and, on a 2-D mesh, the Hx interior columns at each x end — are recomputed on
      thin strips of the fully exchanged stack and patched in.

    Patched cells are computed from exactly the same exchanged data as the unsplit
    path, and kept cells read only local interior data the exchange never touches
    (guarded statically by ``overlap_supported``) — the result is bitwise-equal to
    the unsplit step (tests/test_distributed{,2d}.py).

    ``groups``: list of (K_i, y, x) plane stacks, each with a UNIFORM (loc, sign)
    from ``locs``/``signs``. On BOTH mesh shapes the exchange is STRIP-BASED
    (ops/spmd.fill_halos_spmd_groups / ops/spmd2d.fill_halos_spmd2d_groups):
    no full-plane concatenation is ever materialized — the round-4 verdict's
    layered concat-tax item.

    ``tend_from_groups(model_view, group_views, t)`` maps a (row- or column-
    sliced) model view and matching slices of the filled groups to a tuple of
    tendency arrays. Returns (G_tuple, groups_full)."""
    from ..ops.spmd import fill_halos_spmd_groups
    from ..ops.spmd2d import fill_halos_spmd2d_groups

    g = model.grid
    Hy, ny = g.Hy, g.Ny  # local sizes inside shard_map
    two_d = isinstance(spmd, Spmd2D)

    if two_d:
        groups_full = fill_halos_spmd2d_groups(groups, locs, signs, g.Nx, ny,
                                               g.Hx, Hy, spmd)
        groups_stale = groups  # x halos are remote under an x-partition
    else:
        groups_full = fill_halos_spmd_groups(groups, locs, signs, g.Nx, ny,
                                             g.Hx, Hy, spmd)
        # each 1-D shard holds the full x extent: the x-wrap is local
        groups_stale = [zipper.wrap_x(gr, g.Nx, g.Hx, xp=jnp) for gr in groups]

    G = tend_from_groups(model, groups_stale, t)

    def ystrip(r0):
        m_s = _model_rows(model, r0, r0 + 3 * Hy)
        views = [gr[..., r0 : r0 + 3 * Hy, :] for gr in groups_full]
        return tend_from_groups(m_s, views, t)

    G_lo = ystrip(0)        # patches interior rows [Hy, 2Hy)
    G_hi = ystrip(ny - Hy)  # patches interior rows [ny, ny+Hy) (incl. the fold row)

    def merge_rows(bulk, lo, hi):
        # row indexing on axis -2: Gc may carry a leading tracer/layer axis
        bulk = bulk.at[..., Hy : 2 * Hy, :].set(lo[..., Hy : 2 * Hy, :])
        return bulk.at[..., ny : ny + Hy, :].set(hi[..., Hy : 2 * Hy, :])

    G = tuple(merge_rows(b, l, h) for b, l, h in zip(G, G_lo, G_hi))

    if two_d:
        Hx, nx = g.Hx, g.Nx

        def xstrip(c0):
            m_s = _model_cols(model, c0, c0 + 3 * Hx)
            views = [gr[..., :, c0 : c0 + 3 * Hx] for gr in groups_full]
            return tend_from_groups(m_s, views, t)

        G_w = xstrip(0)        # patches interior columns [Hx, 2Hx)
        G_e = xstrip(nx - Hx)  # patches interior columns [nx, nx+Hx)

        def merge_cols(acc, w, e):
            acc = acc.at[..., :, Hx : 2 * Hx].set(w[..., :, Hx : 2 * Hx])
            return acc.at[..., :, nx : nx + Hx].set(e[..., :, Hx : 2 * Hx])

        # column strips are computed from S_full over ALL rows, so corner cells are
        # correct regardless of the row/column patch order
        G = tuple(merge_cols(a, w, e) for a, w, e in zip(G, G_w, G_e))

    return G, groups_full


def tendencies_overlapped(model: HydrostaticModel, state: State, spmd):
    """Interior/boundary-split single-layer tendencies (see ``split_tendencies``).
    Works on both the 1-D y mesh (``Spmd``) and the 2-D (x, y) mesh (``Spmd2D``).
    Returns (Gu, Gv, Gc, groups_filled); bitwise-equal to the unsplit path
    (tests/test_distributed.py::test_overlap_split_bitwise and the 2-D variants)."""
    c3 = state.c[None] if state.c.ndim == 2 else state.c
    groups = [state.u[None], state.v[None], c3]
    locs, signs = [FC, CF, CC], [-1, -1, 1]

    def tend(m_view, views, t):
        cv = views[2][0] if state.c.ndim == 2 else views[2]
        return tendencies(m_view, views[0][0], views[1][0], cv, t=t)

    (Gu, Gv, Gc), groups_full = split_tendencies(
        model, groups, locs, signs, spmd, tend, state.t)
    return Gu, Gv, Gc, groups_full


def barotropic_substeps(model: HydrostaticModel, eta, U, V, GU, GV, dt,
                        wrap_x_each_substep=True):
    """SM05-averaged forward-backward substepping of (η, U, V) on the extended-halo
    grid (see ``barotropic_substeps_xla``). Lowered for CUDA, the wrap-free loop
    (the only one ``step`` runs: ``make_model`` widens the x-halo) runs as the
    temporally blocked kernel of ops/baro_triton.py; every other platform runs the
    XLA scan, which is also the kernel's reference."""
    from ..ops.baro_triton import barotropic_substeps_triton

    def xla(eta, U, V, GU, GV, dt):
        return barotropic_substeps_xla(model, eta, U, V, GU, GV, dt,
                                       wrap_x_each_substep)

    if wrap_x_each_substep:
        return xla(eta, U, V, GU, GV, dt)

    def kernel(eta, U, V, GU, GV, dt):
        return barotropic_substeps_triton(
            eta, U, V, GU, GV, baro_statics(model), model.fractional_dt * dt,
            model.weights, model.g)

    return jax.lax.platform_dependent(eta, U, V, GU, GV, dt,
                                      cuda=kernel, default=xla)


def baro_statics(model: HydrostaticModel):
    """The extended-grid planes the barotropic kernel reads, by its names."""
    return dict(dy_fc=model.dy_fc_e, dx_cf=model.dx_cf_e, inv_az=model.inv_az_cc_e,
                h_u=model.h_u_e, inv_dx=model.inv_dx_fc_e, h_v=model.h_v_e,
                inv_dy=model.inv_dy_cf_e, mask_u=model.mask_u_e,
                mask_v=model.mask_v_e)


def barotropic_substeps_xla(model: HydrostaticModel, eta, U, V, GU, GV, dt,
                            wrap_x_each_substep=True):
    """SM05-averaged forward-backward substepping of (η, U, V) as an XLA scan. No
    y-halo communication inside the loop — validity shrinks one row per substep
    into the widened halo (the reference's 1:Ny+Hy−1 kernel-range trick,
    test/runtests.jl:66). The x-wrap is local and re-applied every substep."""
    ge = model.grid_ext
    dtau = model.fractional_dt * dt
    gH_u = model.g * model.h_u_e
    gH_v = model.g * model.h_v_e

    def wrapx(A):
        if not wrap_x_each_substep:
            return A  # 2-D decomposition: x-validity shrinks into the widened halo
        return zipper.wrap_x(A, ge.Nx, ge.Hx, xp=jnp)

    def substep(carry, w):
        eta, U, V, eta_a, U_a, V_a = carry
        div = (dxc(model.dy_fc_e * U) + dyc(model.dx_cf_e * V)) * model.inv_az_cc_e
        eta = wrapx(eta - dtau * div)
        U = wrapx((U - dtau * (gH_u * dxf(eta) * model.inv_dx_fc_e - GU)) * model.mask_u_e)
        V = wrapx((V - dtau * (gH_v * dyf(eta) * model.inv_dy_cf_e - GV)) * model.mask_v_e)
        return (eta, U, V, eta_a + w * eta, U_a + w * U, V_a + w * V), None

    zero = jnp.zeros_like(eta)
    init = (eta, U, V, zero, jnp.zeros_like(U), jnp.zeros_like(V))
    # Fully unrolled: the loop is short (≈0.73·substeps) and unrolling lets XLA fuse
    # across substep boundaries instead of paying a loop-carried barrier per substep.
    (_, _, _, eta_a, U_a, V_a), _ = jax.lax.scan(
        substep, init, model.weights, unroll=True
    )
    return eta_a, U_a, V_a


def step(model: HydrostaticModel, state: State, dt, spmd=None,
         fill_mode=None, overlap=None) -> State:
    """One full time step (reference call stack SURVEY.md §3.4): halo fills, WENO
    tendencies, quasi-AB2 extrapolation, communication-free barotropic subcycling,
    barotropic-velocity corrector (single-layer: u = U/H), tracer update.

    With ``spmd`` set (inside shard_map over a y mesh) the halo fills become ppermute
    neighbor exchanges; everything else — including the comm-free barotropic loop —
    is unchanged local code (model metadata carries the LOCAL Ny). On both mesh
    shapes (1-D ``Spmd`` and 2-D ``Spmd2D``) the tendency evaluation is
    interior/boundary-split by default when the halo width statically supports it
    (``overlap``/``overlap_supported``): the exchange and the bulk stencil compute
    are data-independent so they can run concurrently; results stay bitwise-equal
    to the unsplit path."""
    g = model.grid
    ge = model.grid_ext
    dt = jnp.asarray(dt, model.dtype)

    if overlap is None:
        sharded = (isinstance(spmd, Spmd) and spmd.n_shards > 1) or \
                  (isinstance(spmd, Spmd2D) and spmd.n_x * spmd.n_y > 1)
        overlap = sharded and overlap_supported(model, g)
    elif overlap and not overlap_supported(model, g):
        raise ValueError(
            f"overlap split is not exact for this configuration: effective stencil "
            f"radius {overlap_radius(model)} needs Hy >= radius+1 and Hx >= radius "
            f"(grid halo is ({g.Hx}, {g.Hy})) — widen the halo or pass overlap=False")

    # Halo-fill mode: per-field strip writes for serial runs (no stack/unstack
    # round-trip), batched for SPMD runs (one collective pair for all planes
    # beats per-field ppermutes). With `overlap` the prognostic fill happens
    # inside tendencies_overlapped.
    if fill_mode is None:
        fill_mode = "per" if spmd is None else "batch"
    if fill_mode not in ("per", "batch"):
        raise ValueError(f"unknown fill_mode {fill_mode!r}; options: per|batch")
    if overlap:
        SB = None
    elif fill_mode == "batch" or spmd is not None:
        locs_uvc, signs_uvc = _uvc_locs_signs(state.c)
        S = _fill_batch(g, _stack_uvc(state.u, state.v, state.c),
                        locs_uvc, signs_uvc, spmd)
        SB = _unstack_uvc(S, state.c)
    else:
        SB = (_fill(g, state.u, FC, -1), _fill(g, state.v, CF, -1),
              _fill(g, state.c, CC, 1))  # leading tracer axis rides along

    # The free-surface state fill depends only on `state`, not on the tendencies —
    # issue it BEFORE the tendency compute so that on a device mesh XLA's
    # latency-hiding scheduler can overlap this exchange with the WENO stencils
    # (the comm/compute-overlap item of SURVEY.md §2.3; on one chip the order is
    # neutral). GU/GV are exchanged separately after the tendencies.
    if fill_mode == "batch" or spmd is not None:
        SE3 = _fill_batch(ge, jnp.stack([state.eta, state.U, state.V]),
                          [CC, FC, CF], [1, -1, -1], spmd)
        eta_f, U_f, V_f = SE3[0], SE3[1], SE3[2]
    else:
        eta_f = _fill(ge, state.eta, CC, 1)
        U_f = _fill(ge, state.U, FC, -1)
        V_f = _fill(ge, state.V, CF, -1)

    first = state.iteration == 0
    w1 = jnp.where(first, 1.0, 1.5 + _CHI).astype(model.dtype)
    w2 = jnp.where(first, 0.0, 0.5 + _CHI).astype(model.dtype)

    if overlap:
        Gu, Gv, Gc, _ = tendencies_overlapped(model, state, spmd)
    else:
        u, v, c = SB[0], SB[1], SB[2]
        Gu, Gv, Gc = tendencies(model, u, v, c, t=state.t)
    Gu_s = w1 * Gu - w2 * state.Gu
    Gv_s = w1 * Gv - w2 * state.Gv
    Gc_s = w1 * Gc - w2 * state.Gc
    GUb = model.ib.h_u * Gu_s
    GVb = model.ib.h_v * Gv_s
    c_new = (state.c + dt * Gc_s) * model.ib.mask_c

    # fill of the depth-integrated forcing planes (valid through the widened halo
    # rows); eta/U/V were already exchanged above, overlapping the tendency compute
    GU0 = embed_ext(g, ge, GUb)
    GV0 = embed_ext(g, ge, GVb)
    if fill_mode == "batch" or spmd is not None:
        SG = _fill_batch(ge, jnp.stack([GU0, GV0]), [FC, CF], [-1, -1], spmd)
        GU_f, GV_f = SG[0], SG[1]
    else:
        GU_f = _fill(ge, GU0, FC, -1)
        GV_f = _fill(ge, GV0, CF, -1)

    # With x-halos widened to >= substeps+1 (always true for 2-D decompositions, and
    # an option for serial/1-D runs) the barotropic loop needs NO per-substep x-wrap:
    # validity shrinks into the widened x-halo exactly as it does in y.
    n_sub = int(model.weights.shape[0])
    eta_a, U_a, V_a = barotropic_substeps(
        model, eta_f, U_f, V_f, GU_f, GV_f, dt,
        wrap_x_each_substep=ge.Hx < n_sub + 1)

    # Single-layer corrector: the velocity IS the barotropic velocity
    inv_h_u = _inv(model.ib.h_u)
    inv_h_v = _inv(model.ib.h_v)
    u_new = crop_ext(g, ge, U_a) * inv_h_u * model.ib.mask_u
    v_new = crop_ext(g, ge, V_a) * inv_h_v * model.ib.mask_v

    return State(
        u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new,
        Gu=Gu, Gv=Gv, Gc=Gc,
        t=state.t + dt, iteration=state.iteration + 1,
    )


def compute_cfl_dt(model: HydrostaticModel, state: State, cfl=0.3):
    """Advective-CFL time step: cfl / max(|u|/Δx + |v|/Δy), computed on device —
    the TimeStepWizard's device-side half (SURVEY.md O10)."""
    g = model.grid
    speed = jnp.abs(state.u) * model.inv_dx_fc + jnp.abs(state.v) * model.inv_dy_cf
    smax = jnp.max(g.interior(speed))
    return jnp.where(smax > 0, cfl / smax, jnp.inf)


def multi_step(model: HydrostaticModel, state: State, dt, n_steps: int, spmd=None,
               fill_mode=None, overlap=None) -> State:
    """n_steps time steps in one traced computation (lax.scan).

    Amortizes the per-dispatch overhead of a single jitted call across many steps —
    the simulation driver and benchmark use this with the TimeStepWizard's cadence
    (dt is constant within the scanned block, re-adapted between blocks)."""

    def body(s, _):
        return step(model, s, dt, spmd=spmd,
                    fill_mode=fill_mode, overlap=overlap), None

    out, _ = jax.lax.scan(body, state, None, length=n_steps)
    return out
