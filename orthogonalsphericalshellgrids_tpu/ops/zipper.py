"""Zipper north-fold boundary condition and fused halo filling.

JAX reimplementation of the reference's ``ZipperBoundaryCondition``
(``src/zipper_boundary_condition.jl``). The tripolar grid is periodic in x and *folded*
onto itself at the north edge: the north halo of column i is read from the mirrored
column i' on the other half of the fold, with a sign flip for vector components.

Instead of a boundary-condition object hierarchy with per-point kernels, the fold here
is pure, fused data movement on static slices. The exact index/sign conventions
replicate the four reference fold kernels:

- center-x map   i' = Nx - i + 1 (1-based)            ``fold_north_center_*!`` (:110,:125)
- face-x map     i' = Nx - i + 2, wrapped periodically with sign -> |sign| at the wrap
                 point                                 ``fold_north_face_*!`` (:73-75,:90-92)
- center-y rows  halo row Ny+j <- row Ny-j (row Ny duplicated), PLUS in-place overwrite
                 of the redundant half of row Ny itself: f[i,Ny] = sign*f[i',Ny] for
                 i > Nx÷2                              (:95-104,:127-137)
- face-y rows    halo row Ny+j <- row Ny-j+1 (no duplicated row)   (:78-84,:113-119)

Performance note: halo filling runs on every prognostic field every step (the hot
communication loop, SURVEY.md §3.3). The update writes ONLY the halo strips
(``.at[...].set`` -> dynamic-update-slice) rather than reassembling the full array —
the difference between touching ~3 full copies of the array per fill and
touching a few thin strips.

All functions are array-library agnostic (``xp=numpy`` for float64 host-side grid
construction, ``xp=jax.numpy`` inside jit). Arrays are halo-inclusive with layout
``(..., y, x)`` — x last, the contiguous dimension — of shape
``(..., Ny + 2*Hy, Nx + 2*Hx)``. 0-based index p maps to the reference's 1-based,
offset-array index m via p = m + H - 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .location import CENTER, FACE, validate_location

__all__ = ["ZipperBoundaryCondition", "fold_north", "fold_strip", "wrap_x",
           "fill_south", "fill_halos", "fill_halos_batch"]


@dataclasses.dataclass(frozen=True)
class ZipperBoundaryCondition:
    """North-fold boundary condition with an explicit sign — the reference's second
    (and only other) public export (``src/OrthogonalSphericalShellGrids.jl:4``,
    constructor ``src/zipper_boundary_condition.jl:52`` with default ``sign = 1``).

    In this functional design a boundary condition is not an object threaded through a
    dispatch hierarchy; it is just the ``(fold, sign)`` pair the halo fill uses. This
    class exists so user code can *override* the location-derived default sign exactly
    as in the reference (e.g. force +1 on a Face-located scalar), and as the name
    users of the reference will look for. ``apply`` performs the fold on a
    halo-inclusive ``(..., y, x)`` array.
    """

    sign: int = 1

    def apply(self, A, loc, grid, xp=np):
        """Fill the north halo of ``A`` (located at ``loc``) across the zipper fold."""
        return fold_north(A, loc, self.sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy, xp=xp)


def _set(A, yslc, xslc, value, xp, inplace=False):
    """Strip write: functional on jnp (`.at[].set`); on numpy, copy-on-write unless
    the caller owns the buffer (``inplace=True`` — the grid-construction path, where
    copying every strip write costs ~1 GB of memcpy at 1/4 degree)."""
    if xp is np:
        if not inplace:
            A = np.array(A, copy=True)
        A[..., yslc, xslc] = value
        return A
    return A.at[..., yslc, xslc].set(value)


def _mirror_x_interior(I, lx, sign, Nx, xp):
    """Mirror an interior-x block (..., r, Nx) across the fold.

    Returns (mirrored_block, sign_row): sign_row is a length-Nx array of ±1
    implementing the per-column sign, including the |sign| exception at the x-periodic
    wrap point for face-x fields (``src/zipper_boundary_condition.jl:74,:91``).
    """
    if lx == CENTER:
        # i' = Nx - i + 1 (1-based)  ->  i0' = Nx - 1 - i0 : a pure flip.
        M = xp.flip(I, axis=-1)
        sign_row = xp.full((Nx,), sign, dtype=I.dtype)
    else:
        # i' = Nx - i + 2 (1-based) with periodic wrap  ->  i0' = (Nx - i0) % Nx :
        # flip then roll by +1. The wrap point (i0 == 0) takes |sign|.
        M = xp.roll(xp.flip(I, axis=-1), 1, axis=-1)
        i0 = xp.arange(Nx)
        sign_row = xp.where(i0 == 0, abs(sign), sign).astype(I.dtype)
    return M, sign_row


def fold_strip(A, loc, sign, Nx, Ny, Hx, Hy, xp=np):
    """Compute the full-width rows the zipper fold writes, without writing them.

    Returns ``(full, y0)``: ``full`` has shape ``(..., rf, Nx + 2*Hx)`` where
    ``rf = Hy + 1`` for center-y locations (row Ny + halo rows) and ``rf = Hy`` for
    face-y (halo rows only), and ``y0`` is the first written row. The strip is
    already periodically x-wrapped; ``fold_north`` writes it.
    """
    lx, ly = validate_location(loc)
    # Reads only the top Hy+1 interior rows.
    top = A[..., Hy + Ny - 1 - Hy : Hy + Ny, Hx : Hx + Nx]
    M, sign_row = _mirror_x_interior(top, lx, sign, Nx, xp)
    # local row index within `top`: 0..Hy ; row Hy is interior row Ny.

    if ly == CENTER:
        # halo row Ny+j <- mirrored interior row Ny-j (local index Hy-j), j=1..Hy
        halo = xp.flip(M[..., : Hy, :], axis=-2) * sign_row
        # redundant-half overwrite of row Ny for i0 >= Nx//2, reading pre-update values
        i0 = xp.arange(Nx)
        old_row = top[..., Hy, :]
        mir_row = M[..., Hy, :]
        new_row = xp.where(i0 >= Nx // 2, sign_row * mir_row, old_row)
        strip = xp.concatenate([new_row[..., None, :], halo], axis=-2)
        y0 = Hy + Ny - 1  # write row Ny + the Hy halo rows
    else:
        # face-y: halo row Ny+j <- mirrored row Ny-j+1 (local Hy-j+1), j=1..Hy
        halo = xp.flip(M[..., 1 : Hy + 1, :], axis=-2) * sign_row
        strip = halo
        y0 = Hy + Ny

    # periodic x-wrap of the strip, written in one shot across the full width
    full = xp.concatenate([strip[..., Nx - Hx :], strip, strip[..., :Hx]], axis=-1)
    return full, y0


def fold_north(A, loc, sign, Nx, Ny, Hx, Hy, xp=np, inplace=False):
    """Apply the zipper fold: rewrite the north halo rows (and, for center-y fields,
    the redundant half of the last interior row) of halo-inclusive ``A``.

    The x-halo columns of the rewritten rows are also refreshed with the periodic wrap
    so the result is self-consistent (matching the reference's fill order where the
    east/west periodic fill runs after the north fold — pinned by
    ``test/test_zipper_boundary_conditions.jl:39-45``).
    """
    full, y0 = fold_strip(A, loc, sign, Nx, Ny, Hx, Hy, xp=xp)
    return _set(A, slice(y0, Hy + Ny + Hy), slice(None), full, xp, inplace)


def wrap_x(A, Nx, Hx, xp=np, inplace=False):
    """Periodic x-wrap of all rows: west halo <- last Hx interior columns, east halo <-
    first Hx interior columns (x is hardcoded Periodic, ``src/tripolar_grid.jl:88``)."""
    A = _set(A, slice(None), slice(0, Hx), A[..., :, Nx : Nx + Hx], xp, inplace)
    # after the first strip write, a numpy A is owned here either way
    return _set(A, slice(None), slice(Hx + Nx, Hx + Nx + Hx), A[..., :, Hx : 2 * Hx],
                xp, inplace or xp is np)


def fill_south(A, Ny, Hy, mode, xp=np, inplace=False):
    """Fill the south halo rows.

    The reference leaves the south 'continued'/open (``src/tripolar_grid.jl:149``) —
    the physical south boundary sits on land below the southernmost latitude.

    - ``"zero_gradient"``: copy the first interior row into the halo.
    - ``"none"``: leave untouched (grid-construction path).
    """
    if mode == "none" or Hy == 0:
        return A
    if mode != "zero_gradient":
        raise ValueError(f"Unknown south fill mode {mode!r}")
    first = A[..., Hy : Hy + 1, :]
    south = xp.broadcast_to(first, A.shape[:-2] + (Hy, A.shape[-1]))
    return _set(A, slice(0, Hy), slice(None), south, xp, inplace)


def fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, south="zero_gradient", fold=True, xp=np,
               inplace=False):
    """Fused halo fill: south fill, north zipper fold, then periodic x-wrap.

    Single-device equivalent of the reference's ``fill_halo_regions!`` on a tripolar
    grid (SURVEY.md stack 3.3): west/east = periodic wrap, north = zipper fold with
    location-dependent index map and sign, south = open. Pure function of ``A``."""
    A = fill_south(A, Ny, Hy, south, xp=xp, inplace=inplace)
    if fold and Hy > 0:
        A = fold_north(A, loc, sign, Nx, Ny, Hx, Hy, xp=xp, inplace=inplace)
    return wrap_x(A, Nx, Hx, xp=xp, inplace=inplace)


def fill_halos_batch(S, locs, signs, Nx, Ny, Hx, Hy, south="zero_gradient", xp=np):
    """Fused halo fill for a STACK of fields (K, Ny+2Hy, Nx+2Hx) with per-plane
    staggered locations and signs.

    Identical semantics to mapping fill_halos over the planes, but the whole stack is
    filled with one shared set of array ops (plane differences expressed as selects on
    tiny strips) — an order of magnitude fewer kernel launches per step on dispatch-
    bound backends. Pinned against the per-plane path in tests/test_zipper.py.
    """
    K = S.shape[0]
    locs = [validate_location(l) for l in locs]
    assert len(locs) == K and len(signs) == K

    S = fill_south(S, Ny, Hy, south, xp=xp)
    S = fold_north_batch(S, locs, signs, Nx, Ny, Hx, Hy, xp=xp)
    return wrap_x(S, Nx, Hx, xp=xp)


def fold_north_batch(S, locs, signs, Nx, Ny, Hx, Hy, xp=np):
    """Batched zipper fold: rewrite the fold strip (row Ny + north halo rows) of a
    (K, ...) field stack with per-plane location maps/signs in one shared set of ops."""
    K = S.shape[0]
    locs = [validate_location(l) for l in locs]

    top = S[:, Hy + Ny - 1 - Hy : Hy + Ny, Hx : Hx + Nx]   # (K, Hy+1, Nx)
    flipped = xp.flip(top, axis=-1)
    rolled = xp.roll(flipped, 1, axis=-1)
    is_face_x = xp.asarray([lx == FACE for lx, _ in locs]).reshape(K, 1, 1)
    M = xp.where(is_face_x, rolled, flipped)

    i0 = xp.arange(Nx)
    sign_col = xp.asarray(signs, dtype=S.dtype).reshape(K, 1, 1)
    # face-x planes take |sign| at the periodic wrap point i0 == 0
    sign_row = xp.where(
        is_face_x & (i0.reshape(1, 1, Nx) == 0), xp.abs(sign_col), sign_col
    )

    # halo rows: center-y reads mirrored rows [0:Hy] (duplicated row), face-y [1:Hy+1]
    is_face_y = xp.asarray([ly == FACE for _, ly in locs]).reshape(K, 1, 1)
    halo_c = xp.flip(M[:, :Hy, :], axis=-2)
    halo_f = xp.flip(M[:, 1 : Hy + 1, :], axis=-2)
    halo = xp.where(is_face_y, halo_f, halo_c) * sign_row

    # redundant-half overwrite of row Ny for center-y planes
    old_row = top[:, Hy, :]
    mir_row = M[:, Hy, :]
    cond = (~is_face_y[:, 0, :]) & (i0.reshape(1, Nx) >= Nx // 2)
    new_row = xp.where(cond, sign_row[:, 0, :] * mir_row, old_row)

    strip = xp.concatenate([new_row[:, None, :], halo], axis=-2)  # (K, Hy+1, Nx)
    full = xp.concatenate([strip[..., Nx - Hx :], strip, strip[..., :Hx]], axis=-1)
    return _set(S, slice(Hy + Ny - 1, Hy + Ny + Hy), slice(None), full, xp)
