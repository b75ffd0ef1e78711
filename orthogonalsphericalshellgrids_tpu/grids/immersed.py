"""Immersed boundary: grid-fitted bottom masking (SURVEY.md O8).

JAX equivalent of ``ImmersedBoundaryGrid(grid, GridFittedBottom(bottom_height))``
as the reference examples use it to mask the two north singularities and Antarctica
(``examples/bickley_jet.jl:26-29``, ``test/test_tripolar_grid.jl:62-66``). Instead of a
wrapper grid type with immersed-cell predicates dispatched per point, the mask is three
precomputed arrays (cell / u-face / v-face) plus column depths, folded into the stencil
kernels with ``where`` — pure data, no control flow inside jit.

A cell is fluid where the bottom height lies below the column top, i.e.
``H = z_top - max(bottom, z_bottom) > 0``. Faces are fluid only if both adjacent cells
are (the reference's peripheral-node convention for GridFittedBottom).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np

from ..ops import zipper
from ..ops.location import CC
from .tripolar import TripolarGrid

__all__ = ["ImmersedBoundary", "make_immersed_boundary"]


@dataclasses.dataclass(frozen=True)
class ImmersedBoundary:
    """Precomputed masks/depths on a tripolar grid (halo-inclusive, [y, x] layout).

    - ``bottom``: bottom height at cell centers, zipper(+1)-halo-filled. The fold
      symmetry of this field is pinned by the reference
      (``test/test_zipper_boundary_conditions.jl:52-54``).
    - ``h_c``: fluid column depth at centers; ``h_u``/``h_v``: at u/v faces (min of the
      adjacent centers).
    - ``mask_c``/``mask_u``/``mask_v``: 1.0 where fluid, 0.0 where solid.
    """

    bottom: Any
    h_c: Any
    h_u: Any
    h_v: Any
    mask_c: Any
    mask_u: Any
    mask_v: Any


jnp_tree_fields = [f.name for f in dataclasses.fields(ImmersedBoundary)]
try:
    import jax

    jax.tree_util.register_dataclass(ImmersedBoundary, data_fields=jnp_tree_fields, meta_fields=[])
except Exception:  # pragma: no cover
    pass


def make_immersed_boundary(grid: TripolarGrid, bottom_height: Callable | Any) -> ImmersedBoundary:
    """Build the mask set from a bottom-height function ``f(λ, φ) -> height`` evaluated
    at cell centers (the reference's ``GridFittedBottom(bottom_height)`` path), or from
    a precomputed interior (Ny, Nx) / halo-inclusive array."""
    z0, z1 = grid.z_bounds
    shape = grid.shape2d

    if callable(bottom_height):
        lam = np.asarray(grid.interior(grid.lam_cc), dtype=np.float64)
        phi = np.asarray(grid.interior(grid.phi_cc), dtype=np.float64)
        bot_int = np.asarray(bottom_height(lam, phi), dtype=np.float64)
        bot_int = np.broadcast_to(bot_int, (grid.Ny, grid.Nx))
    else:
        bot_int = np.asarray(bottom_height, dtype=np.float64)
        if bot_int.shape == shape:
            bot_int = bot_int[grid.interior2d]
        assert bot_int.shape == (grid.Ny, grid.Nx), bot_int.shape

    bot = np.full(shape, z1, dtype=np.float64)  # halo default: solid above domain top
    bot[grid.interior2d] = bot_int
    # Zipper(+1) fold + periodic wrap; south halo: zero-gradient (land below -80 anyway)
    bot = zipper.fill_halos(bot, CC, 1, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
                            south="zero_gradient", xp=np, inplace=True)  # bot is owned

    # All derived arrays computed host-side in f64, shipped as ONE stacked transfer and
    # split in ONE jit (each eager op would pay a compile of its own).
    h_c = np.clip(z1 - np.maximum(bot, z0), 0.0, None)
    h_u = np.minimum(h_c, np.roll(h_c, 1, axis=-1))
    h_v = np.minimum(h_c, np.roll(h_c, 1, axis=-2))
    mask_c = (h_c > 0).astype(np.float64)
    mask_u = (h_u > 0).astype(np.float64)
    mask_v = (h_v > 0).astype(np.float64)

    import jax

    stacked = jnp.asarray(
        np.stack([bot, h_c, h_u, h_v, mask_c, mask_u, mask_v]), dtype=grid.dtype
    )
    parts = jax.jit(lambda s: tuple(s[i] for i in range(7)))(stacked)
    return ImmersedBoundary(*parts)
