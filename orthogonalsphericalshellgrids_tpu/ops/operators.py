"""Staggered C-grid difference and interpolation operators.

JAX equivalents of the Oceananigans.Operators stencils the reference's model
layer consumes (SURVEY.md O14: the hot stencils all read the precomputed Δx/Δy/Az
metric arrays from the grid). All operators act on halo-inclusive arrays with layout
``(..., y, x)`` and are shape-preserving shifts (``jnp.roll``), so consuming one of them
costs one halo cell of validity; halo widths (>= 4 by default, matching the reference's
default halo, ``src/tripolar_grid.jl:62``) cover the widest WENO-5 stencil (3 cells)
plus one metric read.

Index convention (0-based): a face-x located value ``f[..., i]`` sits *between* centers
``i-1`` and ``i`` (the Julia convention that face i is the left edge of cell i,
shifted to 0-based). Likewise in y.

Everything here is pure jnp; XLA fuses the roll/arith chains into the surrounding
kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "shift_m", "shift_p",
    "dxc", "dxf", "dyc", "dyf",
    "ixc", "ixf", "iyc", "iyf",
]

_X = -1
_Y = -2


def shift_p(a, axis):
    """out[k] = a[k+1] (wraps at the array edge; only halo cells become invalid)."""
    return jnp.roll(a, -1, axis=axis)


def shift_m(a, axis):
    """out[k] = a[k-1]."""
    return jnp.roll(a, 1, axis=axis)


# -- differences -----------------------------------------------------------------------

def dxc(f):
    """δx Face->Center: out[i] = f[i+1] - f[i] (divergence-type difference)."""
    return shift_p(f, _X) - f


def dxf(c):
    """δx Center->Face: out[i] = c[i] - c[i-1] (gradient-type difference)."""
    return c - shift_m(c, _X)


def dyc(f):
    return shift_p(f, _Y) - f


def dyf(c):
    return c - shift_m(c, _Y)


# -- interpolations --------------------------------------------------------------------

def ixc(f):
    """ℑx Face->Center: out[i] = (f[i] + f[i+1]) / 2."""
    return 0.5 * (f + shift_p(f, _X))


def ixf(c):
    """ℑx Center->Face: out[i] = (c[i-1] + c[i]) / 2."""
    return 0.5 * (c + shift_m(c, _X))


def iyc(f):
    return 0.5 * (f + shift_p(f, _Y))


def iyf(c):
    return 0.5 * (c + shift_m(c, _Y))
