"""Halo-fill semantics against an independent oracle of the reference's fold kernels.

The oracle below is written point by point from the index formulas of the four
``fold_north_*!`` kernels in the reference (``src/zipper_boundary_condition.jl``),
in the reference's 1-based offset indexing, with none of ops/zipper.py's strip
arithmetic:

- center-x fields (CC, CF) mirror column i to i' = Nx - i + 1;
- face-x fields (FC, FF) mirror to i' = Nx - i + 2, wrapped periodically, and the
  wrap point (i = 1, which maps onto itself) takes |sign|;
- center-y fields (CC, FC) fill halo row Ny + j from row Ny - j and overwrite the
  redundant half of row Ny (i > Nx / 2) from the pre-update mirror;
- face-y fields (CF, FF) fill halo row Ny + j from row Ny - j + 1.

The south halo is zero-gradient (first interior row, before the fold) and x is
periodic (after the fold). Every production fill path — ``zipper.fill_halos``, its
batched form, and the serial step fills of both models — must match it bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from orthogonalsphericalshellgrids_tpu.models import hydrostatic as H
from orthogonalsphericalshellgrids_tpu.ops import zipper
from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC, FF

# (Nx, Ny, Hx, Hy): odd and even Nx, the extended halos (Hy > Ny) of the
# barotropic grid, and a wide, many-column case
GEOMETRIES = [
    (12, 9, 4, 4),
    (52, 30, 5, 5),
    (260, 21, 4, 4),
    (250, 16, 22, 22),
]
LOCS = [(CC, 1), (FC, -1), (CF, -1), (FF, 1)]


def oracle_fill(A, loc, sign, Nx, Ny, Hx, Hy, south=True):
    """Reference semantics, one point at a time, in 1-based (i, j) indices."""
    A = np.array(A, dtype=np.float64, copy=True)
    lead = A.shape[:-2]
    A = A.reshape((-1,) + A.shape[-2:])
    face_x, face_y = loc[0] == "f", loc[1] == "f"

    def P(m, H_):  # reference index m -> 0-based array index
        return m + H_ - 1

    for a in A:
        if south:
            for j in range(1 - Hy, 1):
                a[P(j, Hy), :] = a[P(1, Hy), :]
        old = a.copy()
        # with no y-halo there is nothing to fold (the seam row stays as it is)
        for i in range(1, Nx + 1 if Hy > 0 else 1):
            if face_x:
                ip = Nx - i + 2
                if ip > Nx:
                    ip -= Nx
                s = abs(sign) if i == 1 else sign
            else:
                ip = Nx - i + 1
                s = sign
            for j in range(1, Hy + 1):
                src = Ny - j + 1 if face_y else Ny - j
                a[P(Ny + j, Hy), P(i, Hx)] = s * old[P(src, Hy), P(ip, Hx)]
            if not face_y and i > Nx // 2:
                a[P(Ny, Hy), P(i, Hx)] = s * old[P(Ny, Hy), P(ip, Hx)]
        for i in range(1 - Hx, 1):
            a[:, P(i, Hx)] = a[:, P(i + Nx, Hx)]
        for i in range(Nx + 1, Nx + Hx + 1):
            a[:, P(i, Hx)] = a[:, P(i - Nx, Hx)]
    return A.reshape(lead + A.shape[-2:])


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("loc,sign", LOCS)
def test_fill_halos_matches_oracle(geom, loc, sign):
    Nx, Ny, Hx, Hy = geom
    A = _rand((Ny + 2 * Hy, Nx + 2 * Hx))
    got = zipper.fill_halos(jnp.asarray(A), loc, sign, Nx, Ny, Hx, Hy, xp=jnp)
    np.testing.assert_array_equal(np.asarray(got), oracle_fill(A, loc, sign, *geom))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_fill_halos_broadcasts_leading_axes(lead):
    Nx, Ny, Hx, Hy = 52, 30, 5, 5
    A = _rand(lead + (Ny + 2 * Hy, Nx + 2 * Hx), seed=1)
    got = zipper.fill_halos(jnp.asarray(A), FC, -1, Nx, Ny, Hx, Hy, xp=jnp)
    assert got.shape == A.shape
    np.testing.assert_array_equal(np.asarray(got), oracle_fill(A, FC, -1, Nx, Ny, Hx, Hy))


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("loc", [CC, CF])
def test_fill_writes_only_halos_and_seam_half(geom, loc):
    """Everything a fill writes is a halo strip or (center-y) the redundant half of
    the seam row; every other cell comes back untouched."""
    Nx, Ny, Hx, Hy = geom
    A = _rand((3, Ny + 2 * Hy, Nx + 2 * Hx), seed=2)
    got = np.asarray(zipper.fill_halos(jnp.asarray(A), loc, 1, Nx, Ny, Hx, Hy, xp=jnp))
    keep = np.zeros(A.shape[-2:], bool)
    keep[Hy:Hy + Ny, Hx:Hx + Nx] = True
    if loc[1] == "c":
        keep[Hy + Ny - 1, Hx + Nx // 2:Hx + Nx] = False
    np.testing.assert_array_equal(got[:, keep], A[:, keep])
    np.testing.assert_array_equal(got, oracle_fill(A, loc, 1, *geom))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_step_batch_fill_matches_oracle(geom):
    """The batched fill the sharded and ``fill_mode="batch"`` steps use, on the
    single-layer step's (u, v, c, c) stack."""

    class G:  # the four grid sizes _fill_batch reads
        Nx, Ny, Hx, Hy = geom

    Nx, Ny, Hx, Hy = geom
    S = _rand((4, Ny + 2 * Hy, Nx + 2 * Hx), seed=3)
    locs, signs = [FC, CF, CC, CC], [-1, -1, 1, 1]
    got = np.asarray(H._fill_batch(G, jnp.asarray(S), locs, signs))
    for k in range(4):
        np.testing.assert_array_equal(got[k], oracle_fill(S[k], locs[k], signs[k], *geom))


def test_step_per_fill_matches_oracle():
    """The per-field fill of the serial step (``fill_mode="per"``)."""

    class G:
        Nx, Ny, Hx, Hy = 52, 30, 5, 5

    A = _rand((30 + 10, 52 + 10), seed=4)
    for loc, sign in LOCS:
        got = np.asarray(H._fill(G, jnp.asarray(A), loc, sign))
        np.testing.assert_array_equal(got, oracle_fill(A, loc, sign, 52, 30, 5, 5))


def test_layered_group_fill_matches_oracle():
    """The layered step's per-group broadcast fill of an (Nz, y, x) stack."""
    from orthogonalsphericalshellgrids_tpu.models import layered as L

    class Grid:
        Nx, Ny, Hx, Hy = 52, 30, 5, 5

    class M:
        grid = Grid

    A = _rand((4, 30 + 10, 52 + 10), seed=5)
    got = np.asarray(L._fill3(M, jnp.asarray(A), CF, -1))
    np.testing.assert_array_equal(got, oracle_fill(A, CF, -1, 52, 30, 5, 5))


def test_fill_halos_batch_mixed_locations():
    Nx, Ny, Hx, Hy = 52, 30, 5, 5
    S = _rand((4, Ny + 2 * Hy, Nx + 2 * Hx), seed=6)
    locs, signs = [l for l, _ in LOCS], [s for _, s in LOCS]
    got = np.asarray(zipper.fill_halos_batch(jnp.asarray(S), locs, signs, Nx, Ny, Hx,
                                             Hy, xp=jnp))
    for k in range(4):
        np.testing.assert_array_equal(got[k], oracle_fill(S[k], locs[k], signs[k],
                                                          Nx, Ny, Hx, Hy))


def test_south_none_leaves_south_halo():
    Nx, Ny, Hx, Hy = 52, 30, 5, 5
    A = _rand((Ny + 2 * Hy, Nx + 2 * Hx), seed=7)
    got = zipper.fill_halos(jnp.asarray(A), CC, 1, Nx, Ny, Hx, Hy, south="none", xp=jnp)
    np.testing.assert_array_equal(np.asarray(got),
                                  oracle_fill(A, CC, 1, Nx, Ny, Hx, Hy, south=False))


def test_zero_y_halo_only_wraps_x():
    Nx, Ny, Hx, Hy = 52, 30, 5, 0
    A = _rand((Ny, Nx + 2 * Hx), seed=8)
    got = zipper.fill_halos(jnp.asarray(A), CC, 1, Nx, Ny, Hx, Hy, xp=jnp)
    np.testing.assert_array_equal(np.asarray(got), oracle_fill(A, CC, 1, Nx, Ny, Hx, Hy))
