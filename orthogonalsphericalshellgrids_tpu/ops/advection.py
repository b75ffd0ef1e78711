"""Advection schemes: WENO-5 (Z-weights), centered, flux-form and vector-invariant.

JAX build of the schemes the reference workloads exercise (SURVEY.md O7):
``FluxFormAdvection(WENO(order=5), WENO(order=5), Centered())`` for tracers and
``WENOVectorInvariant(vorticity_order=5)`` for momentum
(``examples/bickley_jet.jl:48-49``). The WENO-5 reconstruction uses uniform-mesh
optimal coefficients (as Oceananigans does by default on curvilinear horizontal grids)
with WENO-Z nonlinear weights (Borges et al. 2008).

All reconstructions are shape-preserving operations on halo-inclusive arrays; a WENO-5
face value consumes 3 halo cells on each side, within the default halo of 4.
"""

from __future__ import annotations

import jax.numpy as jnp

from .operators import shift_m, shift_p

__all__ = [
    "weno5_faces_from_centers",
    "weno5_centers_from_faces",
    "weno5_upwind_faces_from_centers",
    "weno5_upwind_centers_from_faces",
    "weno7_upwind_faces_from_centers",
    "upwind3_faces_from_centers",
    "upwind_select",
    "centered_faces_from_centers",
    "centered4_faces_from_centers",
    "TRACER_SCHEMES",
]

# tracer_advection= option names accepted by the models (Oceananigans analogs:
# WENO(order=5), WENO(order=7), UpwindBiased(order=3), Centered(order=2/4))
TRACER_SCHEMES = ("weno5", "weno7", "upwind3", "centered", "centered4")

# halo cells each reconstruction consumes on each side (scheme admissibility is
# checked against the grid halo at model build)
SCHEME_RADIUS = {"weno5": 3, "weno7": 4, "upwind3": 2, "centered": 1, "centered4": 2}


def tracer_faces(c, vel, axis, scheme):
    """Face reconstruction of a center field under the named tracer-advection scheme
    (the models' ``tracer_advection=`` dispatch). ``vel`` drives upwinding; the
    centered schemes ignore it."""
    if scheme == "weno5":
        return weno5_upwind_faces_from_centers(c, vel, axis)
    if scheme == "weno7":
        return weno7_upwind_faces_from_centers(c, vel, axis)
    if scheme == "upwind3":
        return upwind3_faces_from_centers(c, vel, axis)
    if scheme == "centered":
        return centered_faces_from_centers(c, axis)
    if scheme == "centered4":
        return centered4_faces_from_centers(c, axis)
    raise ValueError(f"unknown tracer_advection {scheme!r}; options: {TRACER_SCHEMES}")

_EPS = 1e-8  # smoothness regularizer; float32-safe


def _weno5_left(m3, m2, m1, p0, p1):
    """WENO-5 reconstruction at the interface from the LEFT (upwind for positive flow).

    Data (m3, m2, m1 | p0, p1) are the five cells around the interface: three upwind
    (left) and two downwind (right). Returns the reconstructed interface value.
    """
    q0 = (2.0 * m3 - 7.0 * m2 + 11.0 * m1) / 6.0
    q1 = (-m2 + 5.0 * m1 + 2.0 * p0) / 6.0
    q2 = (2.0 * m1 + 5.0 * p0 - p1) / 6.0

    b0 = (13.0 / 12.0) * (m3 - 2.0 * m2 + m1) ** 2 + 0.25 * (m3 - 4.0 * m2 + 3.0 * m1) ** 2
    b1 = (13.0 / 12.0) * (m2 - 2.0 * m1 + p0) ** 2 + 0.25 * (m2 - p0) ** 2
    b2 = (13.0 / 12.0) * (m1 - 2.0 * p0 + p1) ** 2 + 0.25 * (3.0 * m1 - 4.0 * p0 + p1) ** 2

    tau = jnp.abs(b0 - b2)
    a0 = 0.1 * (1.0 + (tau / (b0 + _EPS)) ** 2)
    a1 = 0.6 * (1.0 + (tau / (b1 + _EPS)) ** 2)
    a2 = 0.3 * (1.0 + (tau / (b2 + _EPS)) ** 2)
    s = a0 + a1 + a2
    return (a0 * q0 + a1 * q1 + a2 * q2) / s


def weno5_faces_from_centers(c, axis):
    """Biased WENO-5 reconstructions of a center-located field at faces.

    Face k sits between centers k-1 and k. Returns ``(left, right)``:
    - ``left``  — reconstruction biased from below (upwind value for positive velocity),
    - ``right`` — reconstruction biased from above (upwind value for negative velocity).
    """
    cm1 = shift_m(c, axis)           # c[k-1]
    cm2 = shift_m(cm1, axis)         # c[k-2]
    cm3 = shift_m(cm2, axis)         # c[k-3]
    cp0 = c                          # c[k]
    cp1 = shift_p(c, axis)           # c[k+1]
    left = _weno5_left(cm3, cm2, cm1, cp0, cp1)
    # The right-biased reconstruction is the mirror image: (c[k+2], c[k+1], c[k] | c[k-1], c[k-2])
    cp2 = shift_p(cp1, axis)
    right = _weno5_left(cp2, cp1, cp0, cm1, cm2)
    return left, right


def weno5_centers_from_faces(f, axis):
    """Biased WENO-5 reconstructions of a face-located field at centers.

    Center k sits between faces k and k+1, i.e. at 'face index k+1' of the face field.
    Implemented by reconstructing at faces and shifting the result down by one.
    """
    left, right = weno5_faces_from_centers(f, axis)
    return shift_p(left, axis), shift_p(right, axis)


def weno5_upwind_faces_from_centers(c, vel, axis):
    """Upwind WENO-5 face reconstruction with the biased stencil selected on the
    INPUTS: bitwise-equal to ``upwind_select(vel, *weno5_faces_from_centers(c, axis))``
    (``where`` commutes with the elementwise reconstruction) at half the flops — the
    unselected biased reconstruction is never computed. ``vel`` is the face-located
    advecting velocity that drives the upwinding."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cm3 = shift_m(cm2, axis)
    cp1 = shift_p(c, axis)
    cp2 = shift_p(cp1, axis)
    pos = vel > 0.0

    def sel(a, b):
        return jnp.where(pos, a, b)

    # positive flow: (c[k-3], c[k-2], c[k-1] | c[k], c[k+1]); negative: mirror image
    return _weno5_left(sel(cm3, cp2), sel(cm2, cp1), sel(cm1, c), sel(c, cm1),
                       sel(cp1, cm2))


def weno5_upwind_centers_from_faces(f, vel, axis):
    """Upwind WENO-5 reconstruction of a face field at centers, input-selected.

    Center k sits at face index k+1 of the face field, so the face-level upwinding at
    index j must use the center velocity at j-1; the result shifts down by one —
    bitwise-equal to ``upwind_select(vel, *weno5_centers_from_faces(f, axis))``."""
    return shift_p(weno5_upwind_faces_from_centers(f, shift_m(vel, axis), axis), axis)


def _weno7_left(m4, m3, m2, m1, p0, p1, p2):
    """WENO-7 reconstruction at the interface from the LEFT (Balsara & Shu 2000
    candidate polynomials and smoothness indicators; Castro–Costa–Don 2011 Z-weights
    with τ₇ = |β₀ + 3β₁ − 3β₂ − β₃|). Data are the seven cells around the interface:
    four upwind (m4..m1), three downwind (p0..p2) — the Oceananigans ``WENO(order=7)``
    slot of SURVEY.md O7's scheme family."""
    q0 = (-3.0 * m4 + 13.0 * m3 - 23.0 * m2 + 25.0 * m1) / 12.0
    q1 = (m3 - 5.0 * m2 + 13.0 * m1 + 3.0 * p0) / 12.0
    q2 = (-m2 + 7.0 * m1 + 7.0 * p0 - p1) / 12.0
    q3 = (3.0 * m1 + 13.0 * p0 - 5.0 * p1 + p2) / 12.0

    b0 = (m4 * (547.0 * m4 - 3882.0 * m3 + 4642.0 * m2 - 1854.0 * m1)
          + m3 * (7043.0 * m3 - 17246.0 * m2 + 7042.0 * m1)
          + m2 * (11003.0 * m2 - 9402.0 * m1) + 2107.0 * m1 * m1)
    b1 = (m3 * (267.0 * m3 - 1642.0 * m2 + 1602.0 * m1 - 494.0 * p0)
          + m2 * (2843.0 * m2 - 5966.0 * m1 + 1922.0 * p0)
          + m1 * (3443.0 * m1 - 2522.0 * p0) + 547.0 * p0 * p0)
    b2 = (m2 * (547.0 * m2 - 2522.0 * m1 + 1922.0 * p0 - 494.0 * p1)
          + m1 * (3443.0 * m1 - 5966.0 * p0 + 1602.0 * p1)
          + p0 * (2843.0 * p0 - 1642.0 * p1) + 267.0 * p1 * p1)
    b3 = (m1 * (2107.0 * m1 - 9402.0 * p0 + 7042.0 * p1 - 1854.0 * p2)
          + p0 * (11003.0 * p0 - 17246.0 * p1 + 4642.0 * p2)
          + p1 * (7043.0 * p1 - 3882.0 * p2) + 547.0 * p2 * p2)

    tau = jnp.abs(b0 + 3.0 * b1 - 3.0 * b2 - b3)
    a0 = (1.0 / 35.0) * (1.0 + (tau / (b0 + _EPS)) ** 2)
    a1 = (12.0 / 35.0) * (1.0 + (tau / (b1 + _EPS)) ** 2)
    a2 = (18.0 / 35.0) * (1.0 + (tau / (b2 + _EPS)) ** 2)
    a3 = (4.0 / 35.0) * (1.0 + (tau / (b3 + _EPS)) ** 2)
    s = a0 + a1 + a2 + a3
    return (a0 * q0 + a1 * q1 + a2 * q2 + a3 * q3) / s


def weno7_upwind_faces_from_centers(c, vel, axis):
    """Upwind WENO-7 face reconstruction, input-selected like the WENO-5 variant
    (one reconstruction; the mirror stencil is fed through the same kernel for
    negative flow). Consumes 4 halo cells each side — within the default halo of 4."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cm3 = shift_m(cm2, axis)
    cm4 = shift_m(cm3, axis)
    cp1 = shift_p(c, axis)
    cp2 = shift_p(cp1, axis)
    cp3 = shift_p(cp2, axis)
    pos = vel > 0.0

    def sel(a, b):
        return jnp.where(pos, a, b)

    # positive flow: (c[k-4..k-1] | c[k..k+2]); negative: mirror image around the face
    return _weno7_left(sel(cm4, cp3), sel(cm3, cp2), sel(cm2, cp1), sel(cm1, c),
                       sel(c, cm1), sel(cp1, cm2), sel(cp2, cm3))


def upwind3_faces_from_centers(c, vel, axis):
    """Third-order upwind-biased face reconstruction (Oceananigans
    ``UpwindBiased(order=3)``): the WENO-5 middle candidate stencil with fixed
    weights — (−c[k−2] + 5c[k−1] + 2c[k])/6 for positive flow, mirror for negative.
    Input-selected; consumes 2 halo cells each side."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cp1 = shift_p(c, axis)
    pos = vel > 0.0

    def sel(a, b):
        return jnp.where(pos, a, b)

    return (-sel(cm2, cp1) + 5.0 * sel(cm1, c) + 2.0 * sel(c, cm1)) / 6.0


def upwind_select(vel, left, right):
    """Upwind selection: the left-biased value where vel > 0, else right-biased.

    Matches the reference's upwind dispatch on the interpolated advecting velocity sign
    (Oceananigans upwind-biased reconstruction; SURVEY.md O7)."""
    return jnp.where(vel > 0.0, left, right)


def centered_faces_from_centers(c, axis):
    """Second-order centered interpolation of centers to faces (Centered())."""
    return 0.5 * (c + shift_m(c, axis))


def centered4_faces_from_centers(c, axis):
    """Fourth-order centered face interpolation (Oceananigans ``Centered(order=4)``):
    (7(c[k−1] + c[k]) − (c[k−2] + c[k+1]))/12. Consumes 2 halo cells each side."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cp1 = shift_p(c, axis)
    return (7.0 * (cm1 + c) - (cm2 + cp1)) / 12.0
