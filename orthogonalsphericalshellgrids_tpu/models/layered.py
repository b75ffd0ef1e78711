"""Multi-layer (Nz > 1) hydrostatic free-surface model on a tripolar grid.

Every reference workload is single-layer (Nz = 1 throughout examples and tests), but
the capability surface it exercises — Oceananigans's ``HydrostaticFreeSurfaceModel``
with ``FluxFormAdvection(WENO, WENO, Centered)`` (``examples/bickley_jet.jl:48``,
SURVEY.md O5/O7) — is a *layered* hydrostatic engine: the z slot of the advection
tuple and the model's optional buoyancy only act when Nz > 1. This module provides
that configuration natively:

- per-layer vector-invariant momentum with WENO-5 upwinded vorticity (same horizontal
  stencils as the single-layer model — all ops broadcast over the leading z axis),
- vertical velocity ``w`` diagnosed from continuity (cumulative layer-flux divergence
  from the sea floor), advective-form ``w ∂z u`` momentum transport,
- flux-form tracer advection: WENO-5 in x/y + second-order Centered in z (the
  reference's ``Centered`` z slot), with zero vertical flux through the surface and
  floor so total tracer content is conserved exactly (telescoping),
- optional buoyancy tracer ``b`` (Oceananigans ``BuoyancyTracer``): hydrostatic
  kinematic pressure ``p(z) = -∫_z^0 b dz'`` enters the horizontal momentum equations
  — the baroclinic pressure gradient,
- the same split-explicit barotropic engine as the single-layer model (the embedded
  ``HydrostaticModel`` supplies widened-halo grids, SM05 weights and the
  barotropic subcycle): the depth-integrated flow (η, U, V) is subcycled with the
  thickness-weighted baroclinic forcing, then the layer velocities' depth mean is
  replaced by the barotropic average (the standard split-explicit corrector),
- grid-fitted 3-D masking from the same ``bottom_height`` (a layer cell is fluid when
  its center sits above the bottom — full-cell GridFittedBottom semantics).

Layout: layer axis LEADING — fields are ``(Nz, Ny + 2Hy, Nx + 2Hx)`` with k = 0 the
SURFACE layer and k increasing downward, so (y, x) stay the two minor (contiguous)
dimensions and every horizontal stencil/halo-fill broadcasts unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..grids.tripolar import TripolarGrid
from ..ops import zipper
from ..ops.advection import (centered_faces_from_centers, tracer_faces,
                             weno5_upwind_centers_from_faces,
                             weno5_upwind_faces_from_centers)
from ..ops.location import CC, CF, FC
from ..ops.spmd2d import Spmd2D
from ..ops.operators import dxc, dxf, dyc, dyf, ixc, ixf, iyc, iyf
from .hydrostatic import (HydrostaticModel, _CHI, _fill, _fill_batch, _inv,
                          barotropic_substeps, crop_ext, embed_ext, make_model)
from .split_explicit import SplitExplicitFreeSurface

__all__ = [
    "LayeredState", "LayeredModel", "make_layered_model", "layered_initial_state",
    "layered_step", "layered_multi_step", "vertical_velocity", "layered_cfl_dt",
]

# --------------------------------------------------------------------------------------
# Pytrees
# --------------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayeredState:
    """Prognostics: u/v/c/b are (Nz, Yb, Xb) layer stacks; η/U/V live on the widened
    free-surface grid exactly as in the single-layer model."""

    u: Any
    v: Any
    eta: Any
    U: Any
    V: Any
    c: Any
    b: Any
    Gu: Any
    Gv: Any
    Gc: Any
    Gb: Any
    t: Any
    iteration: Any


@dataclasses.dataclass(frozen=True)
class LayeredModel:
    """The layered configuration wraps the single-layer model (its grids, metric
    reciprocals, immersed boundary and barotropic engine are reused as-is) and adds
    the per-layer mask/thickness arrays and vertical-coordinate metadata."""

    baro: HydrostaticModel
    # (Nz, Yb, Xb) fluid masks at cell / u-face / v-face
    mask_c3: Any
    mask_u3: Any
    mask_v3: Any
    # per-layer face thicknesses dz * mask (what the horizontal fluxes carry)
    dzu: Any
    dzv: Any
    # 1-(over) column depth at u/v faces (2-D, zero on land)
    inv_h_u: Any
    inv_h_v: Any
    # deepest-wet-layer indicator masks (bottom drag acts there)
    bot_u: Any
    bot_v: Any
    # static metadata
    nz: int
    dz: tuple        # per-layer thickness [m], surface-first (uniform -> equal entries)
    dzc: tuple       # center-to-center spacing at the Nz-1 interior interfaces
    zc: tuple        # layer-center depths [m], surface-first
    forcing: tuple   # ((target, fn), ...): fn(λ°, φ°, z, t, fields) -> tendency term
    buoyancy: str    # "none" | "tracer_b" (prognostic b) | "linear_eos" (b from T/S)
    kappa_v: float   # vertical tracer diffusivity (m^2/s; 0 disables)
    nu_v: float      # vertical viscosity (m^2/s; 0 disables)
    vert_impl: bool  # True: backward-Euler tridiagonal solve instead of explicit term
    tracer_names: tuple  # ("c",) -> State.c is (Nz, Yb, Xb); else (n*Nz, ...) stacked
    # linear seawater EOS: b = g_b (α (T - T0) - β (S - S0)); β term only if "S" present
    g_b: float
    alpha_T: float
    beta_S: float
    T0: float
    S0: float

    @property
    def has_b(self) -> bool:
        """True when ``b`` is a prognostic tracer (BuoyancyTracer mode)."""
        return self.buoyancy == "tracer_b"

    @property
    def dz3(self):
        """(Nz, 1, 1) per-layer thickness, broadcastable against field stacks."""
        return jnp.asarray(self.dz, self.dtype).reshape(-1, 1, 1)

    @property
    def dzc3(self):
        """(Nz-1, 1, 1) center-to-center spacing at the interior interfaces."""
        return jnp.asarray(self.dzc, self.dtype).reshape(-1, 1, 1)

    @property
    def grid(self):
        return self.baro.grid

    @property
    def grid_ext(self):
        return self.baro.grid_ext

    @property
    def dtype(self):
        return self.baro.dtype


for _cls, _data, _meta in [
    (LayeredState, [f.name for f in dataclasses.fields(LayeredState)], []),
    (LayeredModel,
     ["baro", "mask_c3", "mask_u3", "mask_v3", "dzu", "dzv", "inv_h_u", "inv_h_v",
      "bot_u", "bot_v"],
     ["nz", "dz", "dzc", "zc", "forcing", "buoyancy", "kappa_v", "nu_v", "vert_impl",
      "tracer_names", "g_b", "alpha_T", "beta_S", "T0", "S0"]),
]:
    jax.tree_util.register_dataclass(_cls, data_fields=_data, meta_fields=_meta)


# --------------------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------------------

def make_layered_model(
    grid: TripolarGrid,
    free_surface: SplitExplicitFreeSurface | None = None,
    bottom_height=None,
    buoyancy: bool | str = False,  # False | True (prognostic b) | "linear_eos" (T/S)
    tracers: tuple = ("c",),       # tracer names; >1 stacks State.c as (n*Nz, Yb, Xb)
    coriolis: bool = False,
    rotation_rate: float = 7.292115e-5,
    kappa_v: float = 0.0,
    nu_v: float = 0.0,
    vertical_time_discretization: str = "explicit",  # "explicit" | "implicit"
    gravitational_acceleration: float = 9.80665,  # for the linear EOS buoyancy
    thermal_expansion: float = 1.67e-4,           # α [1/K] (Oceananigans default)
    haline_contraction: float = 7.80e-4,          # β [1/psu] (Oceananigans default)
    reference_temperature: float = 0.0,           # T0
    reference_salinity: float = 35.0,             # S0
    wind_stress=None,       # callable (λ°, φ°) -> (τx, τy) kinematic [m²/s²]; acts on layer 0
    bottom_drag=None,       # ("linear", r) or ("quadratic", Cd); acts on the deepest wet layer
    nu_h: float = 0.0,
    kappa_h: float = 0.0,
    nu4_h: float = 0.0,
    kappa4_h: float = 0.0,
    tracer_advection: str = "weno5",
    momentum_advection: str = "weno_vector_invariant",
    forcing=None,           # {target: fn} with target in {"u","v","b"} | tracers;
                            # fn(λ°, φ°, z[m], t, fields) -> per-layer tendency term
) -> LayeredModel:
    """Assemble the layered model. The embedded single-layer model provides the
    barotropic engine (widened-halo grid, SM05 weights, subcycle) and
    the column-integrated immersed boundary; this adds per-layer (Nz, y, x) masks.

    The layer grid is the TripolarGrid's own z discretization: Nz uniform layers over
    ``z_bounds`` (``src/tripolar_grid.jl:91`` — generate_coordinate over (z_bottom,
    z_top)), k = 0 at the surface.

    Buoyancy modes (Oceananigans's ``buoyancy=`` model kwarg, SURVEY.md O5):
    - ``False``: none (the reference workloads, ``examples/bickley_jet.jl:53``).
    - ``True``: ``BuoyancyTracer`` — prognostic ``b`` enters the hydrostatic pressure.
    - ``"linear_eos"``: ``SeawaterBuoyancy(LinearEquationOfState(α, β))`` —
      b = g(α(T − T0) − β(S − S0)) computed from the ``"T"``/``"S"`` tracers
      (at least one must be in ``tracers``; a missing one contributes zero).
    """
    tracers = tuple(str(t) for t in tracers)
    if len(tracers) == 0 or len(set(tracers)) != len(tracers):
        raise ValueError(f"tracers must be a non-empty tuple of unique names, got {tracers!r}")
    if vertical_time_discretization not in ("explicit", "implicit"):
        raise ValueError(
            f"vertical_time_discretization must be 'explicit' or 'implicit', "
            f"got {vertical_time_discretization!r}")
    if buoyancy == "linear_eos":
        mode = "linear_eos"
        if "T" not in tracers and "S" not in tracers:
            raise ValueError('buoyancy="linear_eos" requires a "T" and/or "S" tracer')
    elif isinstance(buoyancy, str) and buoyancy not in ("none",):
        raise ValueError(f"unknown buoyancy mode {buoyancy!r}")
    else:
        # any truthy non-string (True, np.True_, 1) selects the prognostic tracer
        mode = "tracer_b" if bool(buoyancy) and not isinstance(buoyancy, str) else "none"
    forcing = dict(forcing or {})
    valid_targets = {"u", "v", *tracers} | ({"b"} if mode == "tracer_b" else set())
    unknown = set(forcing) - valid_targets
    if unknown:
        raise ValueError(f"forcing targets {sorted(unknown)} not in {sorted(valid_targets)}")
    forcing = tuple(forcing.items())
    baro = make_model(grid, free_surface=free_surface, bottom_height=bottom_height,
                      coriolis=coriolis, rotation_rate=rotation_rate,
                      tracer_advection=tracer_advection,
                      momentum_advection=momentum_advection,
                      wind_stress=wind_stress, bottom_drag=bottom_drag,
                      nu_h=nu_h, kappa_h=kappa_h, nu4_h=nu4_h, kappa4_h=kappa4_h)
    nz = grid.Nz
    # Layer-center depths / thicknesses, k = 0 at the surface (stretched-aware).
    zc, dz_layers, dzc_layers = _layer_geometry(grid)

    # Full-cell GridFittedBottom: layer cell fluid iff its center is above the bottom
    # AND the column itself is fluid (h_c > 0 — keeps the pole/land masking identical
    # to the single-layer model's).
    bot = np.asarray(baro.ib.bottom, np.float64)          # (Yb, Xb), halo-filled
    col = np.asarray(baro.ib.mask_c, np.float64) > 0
    wet = (zc[:, None, None] > bot[None]) & col[None]     # (Nz, Yb, Xb)
    mask_c3 = wet.astype(np.float64)
    mask_u3 = mask_c3 * np.roll(mask_c3, 1, axis=-1)
    mask_v3 = mask_c3 * np.roll(mask_c3, 1, axis=-2)

    dt = grid.dtype
    mask_c3 = jnp.asarray(mask_c3, dt)
    mask_u3 = jnp.asarray(mask_u3, dt)
    mask_v3 = jnp.asarray(mask_v3, dt)

    # deepest-wet-layer indicators: 1 in layer k iff wet there and dry (or sea floor)
    # below — where the bottom drag acts
    def bottom_indicator(m3):
        below = jnp.concatenate([m3[1:], jnp.zeros_like(m3[:1])], axis=0)
        return m3 * (1.0 - below)

    # Corrector column depths MUST be the quantized Σ dz·mask (NOT the continuous
    # ib.h_u/h_v): the corrector enforces Σ(u_new·dzu) = U_a only when ubar/Ubar are
    # normalized by the same thickness the layer fluxes carry. With the continuous
    # depth, a bottom that isn't layer-aligned (e.g. 950 m in 250 m layers → Σdz=750)
    # would leave a barotropic-baroclinic residual every step.
    dz3 = jnp.asarray(dz_layers, dt).reshape(-1, 1, 1)
    dzu = dz3 * mask_u3
    dzv = dz3 * mask_v3
    bot_u3 = bottom_indicator(mask_u3)
    bot_v3 = bottom_indicator(mask_v3)

    return LayeredModel(
        baro=baro,
        mask_c3=mask_c3,
        mask_u3=mask_u3,
        mask_v3=mask_v3,
        bot_u=bot_u3,
        bot_v=bot_v3,
        dzu=dzu,
        dzv=dzv,
        inv_h_u=_inv(jnp.sum(dzu, axis=0)),
        inv_h_v=_inv(jnp.sum(dzv, axis=0)),
        nz=nz,
        dz=tuple(float(v) for v in dz_layers),
        dzc=tuple(float(v) for v in dzc_layers),
        zc=tuple(float(v) for v in zc),
        forcing=forcing,
        buoyancy=mode,
        kappa_v=float(kappa_v),
        nu_v=float(nu_v),
        vert_impl=(vertical_time_discretization == "implicit"),
        tracer_names=tracers,
        g_b=float(gravitational_acceleration),
        alpha_T=float(thermal_expansion),
        beta_S=float(haline_contraction),
        T0=float(reference_temperature),
        S0=float(reference_salinity),
    )


def layered_initial_state(model: LayeredModel, u=None, v=None, c=None, b=None,
                          eta=None) -> LayeredState:
    """Initial state from functions of (λ°, φ°, z[m]) evaluated per layer at the
    proper staggered locations (the reference's ``set!(model, ...)`` semantics with a
    z argument).

    With multiple tracers (``make_layered_model(..., tracers=("T", "S"))``), ``c``
    may be a dict ``{name: fn}`` (missing names start at 0) or a sequence of fns in
    ``tracer_names`` order; ``State.c`` is the tracer-major (n_tracers·Nz, Yb, Xb)
    plane stack (tracer t occupies planes [t·Nz, (t+1)·Nz))."""
    g = model.grid
    dt = model.dtype
    nz = model.nz
    zc, _, _ = _layer_geometry(g)

    def sample(fn, lam, phi):
        if fn is None:
            return np.zeros((nz,) + g.shape2d)
        lam = np.asarray(lam, np.float64)
        phi = np.asarray(phi, np.float64)
        out = np.zeros((nz,) + g.shape2d)
        for k in range(nz):
            full = np.broadcast_to(np.asarray(fn(lam, phi, zc[k])), g.shape2d)
            out[k][g.interior2d] = full[g.interior2d]
        return out

    names = model.tracer_names
    if len(names) == 1 and not isinstance(c, (dict, list, tuple)):
        c_raw = sample(c, g.lam_cc, g.phi_cc)
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
        c_raw = np.concatenate([sample(fn, g.lam_cc, g.phi_cc) for fn in fns], axis=0)

    u_raw = sample(u, g.lam_fc, g.phi_fc)
    v_raw = sample(v, g.lam_cf, g.phi_cf)
    b_raw = sample(b, g.lam_cc, g.phi_cc)
    if eta is None:
        eta_raw = np.zeros(g.shape2d)
    else:
        full = np.broadcast_to(
            np.asarray(eta(np.asarray(g.lam_cc, np.float64),
                           np.asarray(g.phi_cc, np.float64))), g.shape2d)
        eta_raw = np.zeros(g.shape2d)
        eta_raw[g.interior2d] = full[g.interior2d]

    @jax.jit
    def _assemble(u_raw, v_raw, c_raw, b_raw, eta_raw):
        u0 = jnp.asarray(u_raw, dt) * model.mask_u3
        v0 = jnp.asarray(v_raw, dt) * model.mask_v3
        c0 = _mask_tracers(model, jnp.asarray(c_raw, dt))
        b0 = jnp.asarray(b_raw, dt) * model.mask_c3
        eta0 = jnp.asarray(eta_raw, dt) * model.baro.ib.mask_c
        U0 = embed_ext(g, model.baro.grid_ext, jnp.sum(u0 * model.dzu, axis=0))
        V0 = embed_ext(g, model.baro.grid_ext, jnp.sum(v0 * model.dzv, axis=0))
        eta_e = embed_ext(g, model.baro.grid_ext, eta0)
        z3 = jnp.zeros((nz,) + g.shape2d, dt)
        return LayeredState(
            u=u0, v=v0, eta=eta_e, U=U0, V=V0, c=c0, b=b0,
            Gu=z3, Gv=z3, Gc=jnp.zeros_like(c0), Gb=z3,
            t=jnp.zeros((), dt), iteration=jnp.zeros((), jnp.int32),
        )

    return _assemble(u_raw, v_raw, c_raw, b_raw, eta_raw)


# --------------------------------------------------------------------------------------
# Vertical operators (layer axis 0, k = 0 surface; no z halos — edges handled inline)
# --------------------------------------------------------------------------------------

def vertical_velocity(model: LayeredModel, u, v):
    """w at layer interfaces (Nz+1, Yb, Xb) from continuity, integrated up from the
    sea floor (w = 0 there): w_k = -Σ_{j≥k} D_j with D_j the thickness-integrated
    horizontal flux divergence of layer j. Interface k is the TOP of layer k. Inputs
    must be halo-filled."""
    g = model.grid
    hdiv = (dxc(g.dy_fc * model.dzu * u) + dyc(g.dx_cf * model.dzv * v)) * _inv(g.az_cc)
    # Σ_{j>=k} D_j as a native reverse cumsum (flip(cumsum(flip(x))) would
    # materialize two extra full-stack copies)
    below = jax.lax.cumsum(hdiv, axis=0, reverse=True)
    return jnp.concatenate([-below, jnp.zeros_like(hdiv[:1])], axis=0)


def _layer_geometry(grid: TripolarGrid):
    """(zc, dz, dzc) surface-first in float64: layer-center depths, per-layer
    thicknesses, and interior-interface center spacings — from the grid's interface
    positions (stretched when ``z_interfaces`` is set, else uniform over z_bounds)."""
    if grid.z_interfaces is not None:
        z_f = np.asarray(grid.z_interfaces, np.float64)
    else:
        z0, z1 = grid.z_bounds
        z_f = np.linspace(z0, z1, grid.Nz + 1)
    zf = z_f[::-1]                        # surface-first: zf[0] = top
    dz = zf[:-1] - zf[1:]                 # positive layer thickness, k = 0 surface
    zc = 0.5 * (zf[:-1] + zf[1:])
    dzc = 0.5 * (dz[:-1] + dz[1:])
    return zc, dz, dzc


def _as_tracer4(model: LayeredModel, c):
    """(n_tracers·Nz, Yb, Xb) tracer-major plane stack -> (n, Nz, Yb, Xb) view
    (identity reshape for a single tracer)."""
    n = len(model.tracer_names)
    return c.reshape((n, model.nz) + c.shape[-2:])


def _as_tracer_stack(model: LayeredModel, c4):
    """Inverse of _as_tracer4, back to the State layout: (Nz, ...) for one tracer,
    (n·Nz, ...) otherwise."""
    if len(model.tracer_names) == 1:
        return c4.reshape((model.nz,) + c4.shape[-2:])
    return c4.reshape((-1,) + c4.shape[-2:])


def _mask_tracers(model: LayeredModel, c):
    """Multiply a tracer stack by mask_c3 (broadcast per tracer)."""
    return _as_tracer_stack(model, _as_tracer4(model, c) * model.mask_c3)


# Layer-axis slicing helpers: the layer axis is -3 so every vertical operator also
# broadcasts over an optional LEADING tracer axis ((n, Nz, Yb, Xb) stacks); for plain
# (Nz, Yb, Xb) fields axis -3 is axis 0, identical to the original formulation.
def _zs(q, lo, hi):
    return q[..., lo:hi, :, :] if hi is not None else q[..., lo:, :, :]


def _zcat(parts):
    return jnp.concatenate(parts, axis=-3)


def _w_advect(w_face, q, dzc):
    """Advective-form vertical transport ``w ∂z q`` at layer points from interface
    velocities ``w_face`` (Nz+1, ...) co-located with q horizontally. The interface
    gradient spans the center-to-center spacing ``dzc`` (= dz on uniform layers).
    Surface and floor interfaces contribute zero (no flux through the boundaries)."""
    dq = (_zs(q, 0, -1) - _zs(q, 1, None)) / dzc  # ∂z q at interior interfaces 1..Nz-1
    contrib = _zs(w_face, 1, -1) * dq
    zero = jnp.zeros_like(_zs(q, 0, 1))
    upper = _zcat([zero, contrib])   # interface k term, layer k
    lower = _zcat([contrib, zero])   # interface k+1 term, layer k
    return 0.5 * (upper + lower)


def _vertical_tracer_div(w, c, dz):
    """-δz(w c̃)/dz_k with Centered interface reconstruction (the reference's
    FluxFormAdvection z slot) and ZERO flux through surface and floor — total content
    Σ G·dz telescopes to exact conservation (per-layer ``dz`` included)."""
    cbar = 0.5 * (_zs(c, 0, -1) + _zs(c, 1, None))   # interior interfaces 1..Nz-1
    F = _zs(w, 1, -1) * cbar
    zero = jnp.zeros_like(_zs(c, 0, 1))
    Ffull = _zcat([zero, F, zero])   # (..., Nz+1, Y, X)
    return -(_zs(Ffull, 0, -1) - _zs(Ffull, 1, None)) / dz


def _vertical_laplacian(q, dz, dzc, mask):
    """Explicit δz(κ δz q) with zero-flux boundaries and solid-cell masking: the
    interface flux gradient spans ``dzc``, the divergence the layer thickness ``dz``."""
    # flux only between fluid cells
    dq = (_zs(q, 0, -1) - _zs(q, 1, None)) / dzc * (_zs(mask, 0, -1) * _zs(mask, 1, None))
    zero = jnp.zeros_like(_zs(q, 0, 1))
    Ffull = _zcat([zero, dq, zero])
    return (_zs(Ffull, 0, -1) - _zs(Ffull, 1, None)) / dz


def _implicit_vertical_solve(q, r, dz, dzc, mask):
    """Backward-Euler vertical diffusion: x with ``(I - r·Lz) x = q`` along axis -3,
    where ``Lz`` is exactly the flux-form operator of ``_vertical_laplacian`` (zero
    flux through surface/floor and across solid interfaces) and ``r = dt·κ`` [m²].

    This is the layered model's ``VerticallyImplicitTimeDiscretization`` (the
    ecosystem's standard vertical-mixing treatment — the reference workloads are all
    single-layer, SURVEY.md O5 note): unconditionally stable for any κ·dt/dz², so
    strong convective-adjustment-scale mixing doesn't constrain Δt. Solved by a
    vectorized Thomas algorithm unrolled over the (static, small) layer count — each
    sweep step is one fused elementwise pass over the (Y, X) planes, so the whole solve is
    2·Nz elementwise plane ops with no gathers or transposes.

    Because Lz telescopes, ``Σ dz·x = Σ dz·q`` per column (content is conserved
    exactly) and land cells (mask 0 above and below) reduce to the identity.

    ``dz``/``dzc`` are the static per-layer tuples; ``mask`` is (Nz, Y, X) and
    broadcasts against an optional leading tracer axis of ``q``; ``r`` may be a
    traced scalar (dt is traced inside jit)."""
    nz = q.shape[-3]
    if nz == 1:
        return q

    def pl(A, k):
        return A[..., k, :, :]

    # interface openness M_k (between layers k-1 and k), k = 1..Nz-1
    M = [pl(mask, k - 1) * pl(mask, k) for k in range(1, nz)]
    # sub/super-diagonals (<= 0) and diagonal (>= 1); a[0] = c[Nz-1] = 0
    a = [None] + [-(r / (dz[k] * dzc[k - 1])) * M[k - 1] for k in range(1, nz)]
    c = [-(r / (dz[k] * dzc[k])) * M[k] for k in range(nz - 1)] + [None]
    # Thomas forward sweep: denom >= 1 always (diagonally dominant by construction)
    cp = [None] * nz
    dp = [None] * nz
    b0 = 1.0 - c[0]
    cp[0] = c[0] / b0
    dp[0] = pl(q, 0) / b0
    for k in range(1, nz):
        bk = 1.0 - (a[k] if a[k] is not None else 0.0) - (c[k] if c[k] is not None else 0.0)
        denom = bk - a[k] * cp[k - 1]
        cp[k] = (c[k] / denom) if c[k] is not None else None
        dp[k] = (pl(q, k) - a[k] * dp[k - 1]) / denom
    # back substitution
    x = [None] * nz
    x[nz - 1] = dp[nz - 1]
    for k in range(nz - 2, -1, -1):
        x[k] = dp[k] - cp[k] * x[k + 1]
    return jnp.stack(x, axis=-3)


def _hydrostatic_pressure(b, dz):
    """Kinematic pressure p_k = -∫_{z_k}^0 b dz' at layer centers (k = 0 surface):
    p_0 = -b_0 dz_0/2, p_k = p_{k-1} - (b_{k-1} dz_{k-1} + b_k dz_k)/2 — via one
    cumsum; ``dz`` may be the per-layer (Nz, 1, 1) thickness (stretched layers)."""
    csum = jnp.cumsum(b * dz, axis=0)
    return -(csum - 0.5 * dz * b)


def _linear_eos_buoyancy(model: LayeredModel, c):
    """b = g(α(T − T0) − β(S − S0)) from the tracer stack — Oceananigans's
    ``SeawaterBuoyancy(equation_of_state=LinearEquationOfState(α, β))`` (SURVEY.md O5
    model family; the reference workloads use ``buoyancy=nothing``). A missing T or S
    tracer contributes zero (its anomaly is defined as 0)."""
    c4 = _as_tracer4(model, c)
    names = model.tracer_names
    b = jnp.zeros_like(c4[0])
    if "T" in names:
        b = b + model.alpha_T * (c4[names.index("T")] - model.T0)
    if "S" in names:
        b = b - model.beta_S * (c4[names.index("S")] - model.S0)
    return model.g_b * b * model.mask_c3


# --------------------------------------------------------------------------------------
# Dynamics
# --------------------------------------------------------------------------------------

def layered_tendencies(model: LayeredModel, u, v, c, b, t=0.0):
    """Interior tendencies per layer. Horizontal terms are the single-layer stencils
    broadcast over the leading z axis; vertical advection and the baroclinic pressure
    gradient are the layered additions. Inputs must be halo-filled; ``t`` is the model
    time handed to user forcing functions."""
    g = model.grid
    m = model.baro

    # --- per-layer relative (+ planetary) vorticity and vector-invariant terms
    upwind_q = m.momentum_advection == "weno_vector_invariant"
    zeta = (dxf(g.dy_cf * v) - dyf(g.dx_fc * u)) * m.inv_az_ff
    q = zeta + m.f_ff if m.coriolis else zeta

    v_hat = ixf(iyc(g.dx_cf * v)) * m.inv_dx_fc
    q_at_u = (weno5_upwind_centers_from_faces(q, v_hat, axis=-2)
              if upwind_q else iyc(q))
    ke = 0.5 * (ixc(u * u) + iyc(v * v))
    Gu = q_at_u * v_hat - dxf(ke) * m.inv_dx_fc

    u_hat = iyf(ixc(g.dy_fc * u)) * m.inv_dy_cf
    q_at_v = (weno5_upwind_centers_from_faces(q, u_hat, axis=-1)
              if upwind_q else ixc(q))
    Gv = -q_at_v * u_hat - dyf(ke) * m.inv_dy_cf

    # --- layer-coupled vertical terms: interface velocity w, advective
    # w-transport, baroclinic pressure gradient (p = -∫ b dz with b from the
    # prognostic BuoyancyTracer or the T/S linear EOS), and the explicit
    # vertical Laplacians.
    # --- vertical momentum advection (advective form, centered)
    w = vertical_velocity(model, u, v)
    Gu = Gu - _w_advect(ixf(w), u, model.dzc3)
    Gv = Gv - _w_advect(iyf(w), v, model.dzc3)

    if model.buoyancy != "none":
        if model.buoyancy == "linear_eos":
            b_eff = _linear_eos_buoyancy(model, c)
        else:
            b_eff = b
        p = _hydrostatic_pressure(b_eff, model.dz3)
        Gu = Gu - dxf(p) * m.inv_dx_fc
        Gv = Gv - dyf(p) * m.inv_dy_cf

    if model.nu_v > 0.0 and not model.vert_impl:
        Gu = Gu + model.nu_v * _vertical_laplacian(u, model.dz3, model.dzc3,
                                                   model.mask_u3)
        Gv = Gv + model.nu_v * _vertical_laplacian(v, model.dz3, model.dzc3,
                                                   model.mask_v3)

    # --- optional forcing / closures (compiled out when disabled)
    if m.wind:
        # surface stress accelerates the top layer
        Gu = Gu.at[0].add(m.taux / model.dz[0])
        Gv = Gv.at[0].add(m.tauy / model.dz[0])
    if m.drag_type == "linear":
        Gu = Gu - (m.drag_coeff / model.dz3) * u * model.bot_u
        Gv = Gv - (m.drag_coeff / model.dz3) * v * model.bot_v
    elif m.drag_type == "quadratic":
        sp_u = jnp.sqrt(u * u + ixf(iyc(v)) ** 2)
        sp_v = jnp.sqrt(v * v + iyf(ixc(u)) ** 2)
        Gu = Gu - (m.drag_coeff / model.dz3) * sp_u * u * model.bot_u
        Gv = Gv - (m.drag_coeff / model.dz3) * sp_v * v * model.bot_v
    if m.nu_h > 0.0:
        from ..ops.closures import laplacian_u, laplacian_v

        Gu = Gu + m.nu_h * laplacian_u(g, u, model.mask_u3, model.mask_c3)
        Gv = Gv + m.nu_h * laplacian_v(g, v, model.mask_v3, model.mask_c3)
    if m.nu4_h > 0.0:
        from ..ops.closures import biharmonic_u, biharmonic_v

        Gu = Gu - m.nu4_h * biharmonic_u(g, u, model.mask_u3, model.mask_c3)
        Gv = Gv - m.nu4_h * biharmonic_v(g, v, model.mask_v3, model.mask_c3)

    Gu = Gu * model.mask_u3
    Gv = Gv * model.mask_v3

    # --- tracers: flux-form WENO-5 (x, y) + Centered (z)
    inv_vol = model.mask_c3 * _inv(g.az_cc * model.dz3)
    def tracer_tendency(cq):
        cx = tracer_faces(cq, u, axis=-1, scheme=m.tracer_advection)
        cy = tracer_faces(cq, v, axis=-2, scheme=m.tracer_advection)
        fx = u * model.dzu * g.dy_fc * cx
        fy = v * model.dzv * g.dx_cf * cy
        G = -(dxc(fx) + dyc(fy)) * inv_vol
        G = G + _vertical_tracer_div(w, cq, model.dz3) * model.mask_c3
        if model.kappa_v > 0.0 and not model.vert_impl:
            G = G + model.kappa_v * _vertical_laplacian(
                cq, model.dz3, model.dzc3, model.mask_c3) * model.mask_c3
        if m.kappa_h > 0.0:
            from ..ops.closures import laplacian_c

            G = G + m.kappa_h * laplacian_c(g, cq, model.mask_c3, model.mask_u3,
                                            model.mask_v3)
        if m.kappa4_h > 0.0:
            from ..ops.closures import biharmonic_c

            G = G - m.kappa4_h * biharmonic_c(g, cq, model.mask_c3, model.mask_u3,
                                              model.mask_v3)
        return G

    # multi-tracer: one broadcast pass over the (n, Nz, Yb, Xb) view — every
    # horizontal/vertical operator above indexes axes -1/-2/-3 only
    Gc = _as_tracer_stack(model, tracer_tendency(_as_tracer4(model, c)))
    Gb = tracer_tendency(b) if model.has_b else jnp.zeros_like(b)

    # --- user forcing (Oceananigans ``Forcing``), pointwise per layer: fn receives
    # the (Nz, 1, 1) layer-center depths so (λ, φ, z) broadcast to (Nz, Yb, Xb)
    if model.forcing:
        from .hydrostatic import ForcingFields

        nz = model.nz
        z3 = jnp.asarray(model.zc, model.dtype).reshape(-1, 1, 1)
        fields = ForcingFields(u=u, v=v, c=c, b=b if model.has_b else None)
        for name, fn in model.forcing:
            if name == "u":
                Gu = Gu + fn(g.lam_fc, g.phi_fc, z3, t, fields) * model.mask_u3
            elif name == "v":
                Gv = Gv + fn(g.lam_cf, g.phi_cf, z3, t, fields) * model.mask_v3
            elif name == "b":
                Gb = Gb + fn(g.lam_cc, g.phi_cc, z3, t, fields) * model.mask_c3
            else:
                idx = model.tracer_names.index(name)
                contrib = fn(g.lam_cc, g.phi_cc, z3, t, fields) * model.mask_c3
                Gc = Gc.at[idx * nz : (idx + 1) * nz].add(contrib)

    return Gu, Gv, Gc, Gb


def _sharded_group_fill(spmd):
    """Strip-based group-fill closure for a sharded mesh (1-D ``Spmd`` or 2-D
    ``Spmd2D``), or None when the run is serial (per/batch fills apply).
    The closure maps (groups, locs, signs, grid) -> filled groups with ZERO
    full-plane concats (ops/spmd.fill_halos_spmd_groups and the 2-D
    counterpart)."""
    from ..ops.spmd import Spmd, fill_halos_spmd_groups
    from ..ops.spmd2d import fill_halos_spmd2d_groups

    if isinstance(spmd, Spmd) and spmd.n_shards > 1:
        return lambda groups, locs, signs, g: fill_halos_spmd_groups(
            groups, locs, signs, g.Nx, g.Ny, g.Hx, g.Hy, spmd)
    if isinstance(spmd, Spmd2D) and spmd.n_x * spmd.n_y > 1:
        return lambda groups, locs, signs, g: fill_halos_spmd2d_groups(
            groups, locs, signs, g.Nx, g.Ny, g.Hx, g.Hy, spmd)
    return None


def _fill3(model: LayeredModel, A, loc, sign, spmd=None):
    """Halo fill of an (Nz, Yb, Xb) stack — every zipper/ppermute op broadcasts over
    the leading layer axis. Serial / 1-D Spmd / 2-D Spmd2D all supported (the 2-D
    path routes the layer planes through the batched fold-aware strip-gather fill).
    The serial path uses the uniform-location broadcast fill directly (strip writes
    only — no per-plane select machinery, no stack copy)."""
    g = model.grid
    if spmd is None or getattr(spmd, "n_shards", 2) == 1:
        return zipper.fill_halos(A, loc, sign, g.Nx, g.Ny, g.Hx, g.Hy,
                                 south="zero_gradient", xp=jnp)
    nz = A.shape[0]
    return _fill_batch(g, A, [loc] * nz, [sign] * nz, spmd)




def layered_tendencies_overlapped(model: LayeredModel, state: LayeredState, spmd):
    """Interior/boundary-split layered tendencies (models/hydrostatic.py::
    split_tendencies applied to the (3-4)·Nz-plane stack): the bulk per-layer
    stencil pass has no data dependence on the halo exchange, so XLA can run the
    ppermute/all_gather collectives concurrently with it; boundary rows/columns are
    recomputed on thin strips of the exchanged stack and patched in. Works on the
    1-D y mesh (``Spmd``) and the 2-D (x, y) mesh (``Spmd2D``); bitwise-equal to
    the unsplit layered step (tests/test_distributed{,2d}.py).

    All vertical operators (continuity w, w-advection, implicit/explicit mixing,
    hydrostatic pressure, EOS) are column-local, so the row/column-sliced model
    views slice them consistently — only the horizontal stencil radius matters, and
    it is the same as the single-layer model's (``overlap_radius``)."""
    from .hydrostatic import split_tendencies

    groups = [state.u, state.v, state.c] + ([state.b] if model.has_b else [])
    locs = [FC, CF, CC] + ([CC] if model.has_b else [])
    signs = [-1, -1, 1] + ([1] if model.has_b else [])

    def tend(m_view, views, t):
        # with no prognostic b the (full-size, unused) state.b placeholder must
        # stay OUT of the strip merge, so Gb is dropped here and re-attached by
        # the caller
        u, v, c = views[0], views[1], views[2]
        b = views[3] if model.has_b else state.b
        Gu, Gv, Gc, Gb = layered_tendencies(m_view, u, v, c, b, t=t)
        return (Gu, Gv, Gc, Gb) if model.has_b else (Gu, Gv, Gc)

    G, _ = split_tendencies(model, groups, locs, signs, spmd, tend, state.t)
    if model.has_b:
        return G
    return G + (jnp.zeros_like(state.b),)


def layered_step(model: LayeredModel, state: LayeredState, dt, spmd=None,
                 fill_mode=None, overlap=None) -> LayeredState:
    """One layered time step: halo fills, per-layer tendencies, quasi-AB2, barotropic
    subcycling of (η, U, V) with the thickness-weighted baroclinic forcing, then the
    split-explicit corrector that replaces each column's depth-mean velocity with the
    subcycle average.

    ``spmd`` may be a 1-D ``Spmd`` (y mesh) or a 2-D ``Spmd2D`` ((x, y) mesh with the
    fold-aware strip gather) — the same dispatch as the single-layer step.

    Halo-fill mode mirrors the single-layer ``step``: serial runs fill each
    prognostic GROUP in place (the zipper ops broadcast over the leading layer axis,
    so u/v/c/b fill with zero stack copies instead of the (3-4)·Nz-plane
    concat/split of the batched path); SPMD runs
    concatenate everything into ONE batched exchange (one collective pair per
    direction for the whole stack beats per-group ppermutes)."""
    g = model.grid
    m = model.baro
    ge = m.grid_ext
    nz = model.nz
    dt = jnp.asarray(dt, model.dtype)
    if fill_mode is None:
        fill_mode = "per" if spmd is None else "batch"
    if fill_mode not in ("per", "batch"):
        raise ValueError(f"unknown fill_mode {fill_mode!r}; options: per|batch")
    if fill_mode == "per" and spmd is not None:
        raise ValueError(
            f"fill_mode={fill_mode!r} is a serial-only path; sharded (spmd) runs "
            "use the batched-exchange fill (fill_mode='batch' or None)")
    if overlap is None:
        from ..ops.spmd import Spmd
        from .hydrostatic import overlap_supported

        sharded = (isinstance(spmd, Spmd) and spmd.n_shards > 1) or \
                  (isinstance(spmd, Spmd2D) and spmd.n_x * spmd.n_y > 1)
        overlap = sharded and overlap_supported(m, g)
    elif overlap:
        from .hydrostatic import overlap_radius, overlap_supported

        if not overlap_supported(m, g):
            raise ValueError(
                f"overlap split is not exact for this configuration: effective "
                f"stencil radius {overlap_radius(m)} needs Hy >= radius+1 and "
                f"Hx >= radius (grid halo is ({g.Hx}, {g.Hy}))")

    ncp = state.c.shape[0]  # n_tracers * nz tracer planes
    if overlap:
        # free-surface fields exchanged first — like the prognostic exchange inside
        # the split, this collective has no dependence on the bulk stencil pass
        fill_groups = _sharded_group_fill(spmd)
        if fill_groups is not None:
            eta_f, U_f, V_f = (a[0] for a in fill_groups(
                [state.eta[None], state.U[None], state.V[None]],
                [CC, FC, CF], [1, -1, -1], ge))
        else:
            SE3 = _fill_batch(ge, jnp.stack([state.eta, state.U, state.V]),
                              [CC, FC, CF], [1, -1, -1], spmd)
            eta_f, U_f, V_f = SE3[0], SE3[1], SE3[2]
        Gu, Gv, Gc, Gb = layered_tendencies_overlapped(model, state, spmd)
    elif fill_mode == "per":
        # per-group broadcast fills: no concat, strip writes only
        u = _fill3(model, state.u, FC, -1)
        v = _fill3(model, state.v, CF, -1)
        c = _fill3(model, state.c, CC, 1)
        b = _fill3(model, state.b, CC, 1) if model.has_b else state.b
        eta_f = _fill(ge, state.eta, CC, 1)
        U_f = _fill(ge, state.U, FC, -1)
        V_f = _fill(ge, state.V, CF, -1)
    else:
        fill_groups = _sharded_group_fill(spmd)
        if fill_groups is not None:
            # sharded mesh (1-D or 2-D): STRIP-BASED group exchange — same
            # collective count as the batched path with zero full-plane
            # concats
            groups = [state.u, state.v, state.c] + ([state.b] if model.has_b else [])
            glocs = [FC, CF, CC] + ([CC] if model.has_b else [])
            gsigns = [-1, -1, 1] + ([1] if model.has_b else [])
            filled = fill_groups(groups, glocs, gsigns, g)
            u, v, c = filled[0], filled[1], filled[2]
            b = filled[3] if model.has_b else state.b

            # free-surface fields exchanged early (overlappable with the
            # tendency stencils); 1-plane groups — no stack/unstack copies
            eta_f, U_f, V_f = (a[0] for a in fill_groups(
                [state.eta[None], state.U[None], state.V[None]],
                [CC, FC, CF], [1, -1, -1], ge))
        else:
            # serial batch mode: one batched fill of the plane stack
            planes = [state.u, state.v, state.c] + ([state.b] if model.has_b else [])
            locs = [FC] * nz + [CF] * nz + [CC] * (ncp + (nz if model.has_b else 0))
            signs = [-1] * nz + [-1] * nz + [1] * (ncp + (nz if model.has_b else 0))
            SB = _fill_batch(g, jnp.concatenate(planes, axis=0), locs, signs, spmd)
            u, v, c = SB[:nz], SB[nz : 2 * nz], SB[2 * nz : 2 * nz + ncp]
            b = SB[2 * nz + ncp :] if model.has_b else state.b

            # free-surface fields exchanged early (overlappable with the
            # tendency stencils)
            SE3 = _fill_batch(ge, jnp.stack([state.eta, state.U, state.V]),
                              [CC, FC, CF], [1, -1, -1], spmd)
            eta_f, U_f, V_f = SE3[0], SE3[1], SE3[2]

    if not overlap:
        Gu, Gv, Gc, Gb = layered_tendencies(model, u, v, c, b, t=state.t)

    first = state.iteration == 0
    w1 = jnp.where(first, 1.0, 1.5 + _CHI).astype(model.dtype)
    w2 = jnp.where(first, 0.0, 0.5 + _CHI).astype(model.dtype)
    Gu_s = w1 * Gu - w2 * state.Gu
    Gv_s = w1 * Gv - w2 * state.Gv
    Gc_s = w1 * Gc - w2 * state.Gc
    Gb_s = w1 * Gb - w2 * state.Gb if model.has_b else state.Gb

    # thickness-weighted depth integral of the baroclinic forcing drives the subcycle
    GUb = jnp.sum(Gu_s * model.dzu, axis=0)
    GVb = jnp.sum(Gv_s * model.dzv, axis=0)
    GU0 = embed_ext(g, ge, GUb)
    GV0 = embed_ext(g, ge, GVb)
    if fill_mode == "per":
        GU_f = _fill(ge, GU0, FC, -1)
        GV_f = _fill(ge, GV0, CF, -1)
    else:
        fill_groups = _sharded_group_fill(spmd)
        if fill_groups is not None:
            GU_f, GV_f = (a[0] for a in fill_groups(
                [GU0[None], GV0[None]], [FC, CF], [-1, -1], ge))
        else:
            SG = _fill_batch(ge, jnp.stack([GU0, GV0]), [FC, CF], [-1, -1], spmd)
            GU_f, GV_f = SG[0], SG[1]

    n_sub = int(m.weights.shape[0])
    eta_a, U_a, V_a = barotropic_substeps(
        m, eta_f, U_f, V_f, GU_f, GV_f, dt,
        wrap_x_each_substep=ge.Hx < n_sub + 1)

    # split-explicit corrector: predictor layers, then replace the depth mean
    u_star = (state.u + dt * Gu_s) * model.mask_u3
    v_star = (state.v + dt * Gv_s) * model.mask_v3
    if model.vert_impl and model.nu_v > 0.0:
        # backward-Euler vertical viscosity on the predictor; Σ dz·u is conserved by
        # the solve, so the depth-mean replacement below is unaffected
        r = dt * model.nu_v
        u_star = _implicit_vertical_solve(u_star, r, model.dz, model.dzc, model.mask_u3)
        v_star = _implicit_vertical_solve(v_star, r, model.dz, model.dzc, model.mask_v3)
    ubar = jnp.sum(u_star * model.dzu, axis=0) * model.inv_h_u
    vbar = jnp.sum(v_star * model.dzv, axis=0) * model.inv_h_v
    Ubar = crop_ext(g, ge, U_a) * model.inv_h_u
    Vbar = crop_ext(g, ge, V_a) * model.inv_h_v
    u_new = (u_star + (Ubar - ubar)[None]) * model.mask_u3
    v_new = (v_star + (Vbar - vbar)[None]) * model.mask_v3

    c_new = _mask_tracers(model, state.c + dt * Gc_s)
    b_new = (state.b + dt * Gb_s) * model.mask_c3 if model.has_b else state.b
    if model.vert_impl and model.kappa_v > 0.0:
        r = dt * model.kappa_v
        c_new = _as_tracer_stack(model, _implicit_vertical_solve(
            _as_tracer4(model, c_new), r, model.dz, model.dzc, model.mask_c3))
        if model.has_b:
            b_new = _implicit_vertical_solve(b_new, r, model.dz, model.dzc,
                                             model.mask_c3)

    return LayeredState(
        u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new, b=b_new,
        Gu=Gu, Gv=Gv, Gc=Gc, Gb=Gb if model.has_b else state.Gb,
        t=state.t + dt, iteration=state.iteration + 1,
    )


def layered_multi_step(model: LayeredModel, state: LayeredState, dt, n_steps: int,
                       spmd=None, fill_mode=None, overlap=None) -> LayeredState:
    """n_steps layered steps in one traced computation (lax.scan)."""

    def body(s, _):
        return layered_step(model, s, dt, spmd=spmd, fill_mode=fill_mode,
                            overlap=overlap), None

    out, _ = jax.lax.scan(body, state, None, length=n_steps)
    return out


def layered_cfl_dt(model: LayeredModel, state: LayeredState, cfl=0.3):
    """Advective-CFL time step over all layers (the TimeStepWizard's device half)."""
    g = model.grid
    m = model.baro
    speed = jnp.abs(state.u) * m.inv_dx_fc + jnp.abs(state.v) * m.inv_dy_cf
    smax = jnp.max(speed[(slice(None),) + g.interior2d])
    return jnp.where(smax > 0, cfl / smax, jnp.inf)
