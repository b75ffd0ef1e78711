"""Tripolar-grid ocean stencil engine in JAX.

A brand-new JAX/XLA implementation of the capabilities of
CliMA/OrthogonalSphericalShellGrids.jl plus the Oceananigans machinery its examples
exercise (SURVEY.md §0): tripolar grid generation with precomputed metrics, the zipper
north-fold boundary condition, C-grid finite-volume WENO dynamics, a split-explicit free
surface, simulation driving/output, and y-sharded distributed execution over a JAX
device mesh.

The reference package exports exactly two names — ``TripolarGrid`` and
``ZipperBoundaryCondition`` (``src/OrthogonalSphericalShellGrids.jl:4``); here the same
two concepts are the core exports, alongside the model/simulation layer that the
reference delegates to Oceananigans.
"""

import os as _os

import jax as _jax

# Persistent compilation cache. A JAX_COMPILATION_CACHE_DIR set from outside is
# read by JAX itself and left alone; otherwise the cache lives in a fixed directory
# of the checkout (listed in .gitignore). The path is part of each entry's key, so a
# fixed path is what lets later processes find earlier compilations.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                      ".jax_cache"))

from .grids.geometry import R_EARTH
from .grids.tripolar import TripolarGrid, build_tripolar_arrays, with_halo
from .ops.location import CC, CF, FC, FF, default_zipper_sign, sign_for_field_name
from .ops.zipper import ZipperBoundaryCondition, fill_halos, fold_north, wrap_x

__all__ = [
    "TripolarGrid",
    "ZipperBoundaryCondition",
    "build_tripolar_arrays",
    "with_halo",
    "fill_halos",
    "fold_north",
    "wrap_x",
    "default_zipper_sign",
    "sign_for_field_name",
    "R_EARTH",
    "CC", "CF", "FC", "FF",
]

__version__ = "0.1.0"
