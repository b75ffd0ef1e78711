"""2-D (x, y) domain decomposition driver: partitioning, sharded step, gather.

The fold-aware 2-D halo machinery lives in ops/spmd2d.py; this module provides the
layout conversion (the 2-D analog of the reference's halo-inclusive jrange slicing,
now in both directions) and the shard_map wrapper. The reference never supported
x-partitioning (src/distributed_tripolar_grid.jl:30-31) — this is the build's
extension target (BASELINE config #4).

Layout: every distributed 2-D array is stored globally as
``(n_y*(ny+2Hy), n_x*(nx+2Hx))`` with ``P('y', 'x')`` sharding — each shard's block is
its halo-inclusive local array. Any model works: the free-surface grid always
carries widened x-halos, so the barotropic loop shrinks validity in x instead of
wrapping locally (mandatory once x is sharded).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import hydrostatic as hydro
from ..models.hydrostatic import HydrostaticModel, State
from ..ops.spmd2d import Spmd2D
from . import layouts

__all__ = ["make_mesh2d", "distribute2d", "gather_state2d", "sharded_step_fn2d",
           "distribute_layered2d", "gather_layered_state2d", "sharded_layered_step_fn2d"]


def make_mesh2d(n_x: int, n_y: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_x * n_y:
        raise RuntimeError(f"need {n_x * n_y} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[: n_x * n_y]).reshape(n_y, n_x), axis_names=("y", "x"))


def _partition_blocks(A: np.ndarray, n_y, n_x, ny, nx, Hy, Hx) -> np.ndarray:
    """Global halo-inclusive array -> (n_y*(ny+2Hy), n_x*(nx+2Hx)) block layout."""
    rows = [
        np.concatenate(
            [A[ky * ny : ky * ny + ny + 2 * Hy, kx * nx : kx * nx + nx + 2 * Hx]
             for kx in range(n_x)], axis=1)
        for ky in range(n_y)
    ]
    return np.concatenate(rows, axis=0)


def _pspec_for(leaf):
    if hasattr(leaf, "ndim") and leaf.ndim == 2:
        return P("y", "x")
    if hasattr(leaf, "ndim") and leaf.ndim == 3:
        return P(None, "y", "x")
    return P()


def _check_divisibility(g, ge, n_y, n_x):
    if g.Ny % n_y or g.Nx % n_x:
        raise ValueError(f"grid {g.Nx}x{g.Ny} not divisible by mesh {n_x}x{n_y}")
    ny, nx = g.Ny // n_y, g.Nx // n_x
    if nx < ge.Hx or ny < ge.Hy:
        raise ValueError(
            f"local block {nx}x{ny} must cover the extended halos {ge.Hx}x{ge.Hy}")
    return ny, nx


def _repartition_tree2d(tree, n_y, n_x, ny, nx, g, ge):
    """Tag-driven serial -> 2-D block layout conversion (see parallel/layouts.py)."""

    def repartition(path, leaf):
        # layout by registered leaf name (parallel/layouts.py), never by shape
        tag = layouts.leaf_layout(path)
        a = np.asarray(leaf)
        if tag == layouts.REP or a.ndim < 2:
            return a
        Hy_k, Hx_k = (g.Hy, g.Hx) if tag == layouts.BASE else (ge.Hy, ge.Hx)
        rows, cols = g.Ny + 2 * Hy_k, g.Nx + 2 * Hx_k
        if a.ndim == 2:
            if a.shape != (rows, cols):
                raise ValueError(
                    f"leaf {jax.tree_util.keystr(path)} tagged {tag!r} has shape "
                    f"{a.shape}, layout expects {(rows, cols)}")
            return _partition_blocks(a, n_y, n_x, ny, nx, Hy_k, Hx_k)
        if a.shape[1:] != (rows, cols):
            raise ValueError(
                f"3-D leaf {jax.tree_util.keystr(path)} tagged {tag!r} has planes "
                f"{a.shape[1:]}, layout expects {(rows, cols)}")
        return np.stack([_partition_blocks(a[k], n_y, n_x, ny, nx, Hy_k, Hx_k)
                         for k in range(a.shape[0])])

    return jax.tree_util.tree_map_with_path(repartition, tree)


def _put(tree, mesh):
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, NamedSharding(mesh, _pspec_for(leaf))), tree)


def distribute2d(model: HydrostaticModel, state: State, mesh: Mesh):
    """Partition a serial model+state onto an (x, y) mesh."""
    n_y, n_x = mesh.devices.shape
    g, ge = model.grid, model.grid_ext
    ny, nx = _check_divisibility(g, ge, n_y, n_x)

    dist_model = _repartition_tree2d(model, n_y, n_x, ny, nx, g, ge)
    dist_state = _repartition_tree2d(state, n_y, n_x, ny, nx, g, ge)

    local_grid = dataclasses.replace(dist_model.grid, Nx=nx, Ny=ny)
    local_grid_ext = dataclasses.replace(dist_model.grid_ext, Nx=nx, Ny=ny)
    dist_model = dataclasses.replace(dist_model, grid=local_grid, grid_ext=local_grid_ext)

    return _put(dist_model, mesh), _put(dist_state, mesh)


def _gather_tree2d(dist_tree, mesh: Mesh, g, ge):
    """Tag-driven 2-D block layout -> serial conversion (interiors only; halos
    refresh on next fill)."""
    n_y, n_x = mesh.devices.shape
    ny, nx = g.Ny // n_y, g.Nx // n_x

    def unpart(a, Hy_k, Hx_k, Yg, Xg):
        br, bc = ny + 2 * Hy_k, nx + 2 * Hx_k
        out = np.zeros((Yg, Xg), a.dtype)
        for ky in range(n_y):
            for kx in range(n_x):
                blk = a[ky * br : (ky + 1) * br, kx * bc : (kx + 1) * bc]
                out[Hy_k + ky * ny : Hy_k + (ky + 1) * ny,
                    Hx_k + kx * nx : Hx_k + (kx + 1) * nx] = blk[Hy_k : Hy_k + ny,
                                                                 Hx_k : Hx_k + nx]
        return out

    def conv(path, leaf):
        tag = layouts.leaf_layout(path)
        a = np.asarray(leaf)
        if tag == layouts.REP or a.ndim < 2:
            return jnp.asarray(a.ravel()[0]) if a.ndim > 0 and a.size > 1 else leaf
        Hy_k, Hx_k = (g.Hy, g.Hx) if tag == layouts.BASE else (ge.Hy, ge.Hx)
        Yg, Xg = g.Ny + 2 * Hy_k, g.Nx + 2 * Hx_k
        if a.ndim == 3:
            return jnp.asarray(np.stack(
                [unpart(a[k], Hy_k, Hx_k, Yg, Xg) for k in range(a.shape[0])]))
        return jnp.asarray(unpart(a, Hy_k, Hx_k, Yg, Xg))

    return jax.tree_util.tree_map_with_path(conv, dist_tree)


def gather_state2d(dist_state: State, model_serial: HydrostaticModel, mesh: Mesh) -> State:
    """Reassemble a serial-layout State (interiors only; halos refresh on next fill)."""
    return _gather_tree2d(dist_state, mesh, model_serial.grid, model_serial.grid_ext)


def sharded_step_fn2d(mesh: Mesh, dist_model: HydrostaticModel, nx_global: int,
                      overlap=None, fold_mode="auto"):
    """Jitted shard_map-wrapped 2-D step: (state, dt) -> state.

    ``overlap`` (default: on when the halo width statically supports it) selects the
    interior/boundary split in BOTH directions: the bulk pass reads only local
    interior data, boundary rows AND columns are recomputed on strips of the
    exchanged stack; bitwise-equal either way (tests/test_distributed2d.py)."""
    n_y, n_x = mesh.devices.shape
    spmd = Spmd2D(axis_x="x", axis_y="y", n_x=n_x, n_y=n_y, nx_global=nx_global,
                  fold_mode=fold_mode)

    model_specs = jax.tree_util.tree_map(_pspec_for, dist_model)

    def run(dist_state, dt):
        state_specs = jax.tree_util.tree_map(_pspec_for, dist_state)
        fn = jax.shard_map(
            partial(hydro.step, spmd=spmd, overlap=overlap),
            mesh=mesh,
            in_specs=(model_specs, state_specs, P()),
            out_specs=state_specs,
        )
        return fn(dist_model, dist_state, dt)

    return jax.jit(run)


# --------------------------------------------------------------------------------------
# Layered (Nz > 1) model over the 2-D (x, y) mesh — the same tag-driven conversion;
# 3-D (Nz, y, x) leaves are block-partitioned per layer plane
# --------------------------------------------------------------------------------------

def distribute_layered2d(model, state, mesh: Mesh):
    """Partition a layered model+state onto an (x, y) mesh (the 2-D analog of
    parallel/distributed.distribute_layered)."""
    n_y, n_x = mesh.devices.shape
    g, ge = model.grid, model.baro.grid_ext
    ny, nx = _check_divisibility(g, ge, n_y, n_x)

    dist_model = _repartition_tree2d(model, n_y, n_x, ny, nx, g, ge)
    dist_state = _repartition_tree2d(state, n_y, n_x, ny, nx, g, ge)

    local_baro = dataclasses.replace(
        dist_model.baro,
        grid=dataclasses.replace(dist_model.baro.grid, Nx=nx, Ny=ny),
        grid_ext=dataclasses.replace(dist_model.baro.grid_ext, Nx=nx, Ny=ny),
    )
    dist_model = dataclasses.replace(dist_model, baro=local_baro)
    return _put(dist_model, mesh), _put(dist_state, mesh)


def gather_layered_state2d(dist_state, model_serial, mesh: Mesh):
    """Reassemble a serial-layout LayeredState from the 2-D block layout."""
    return _gather_tree2d(dist_state, mesh, model_serial.grid,
                          model_serial.baro.grid_ext)


def sharded_layered_step_fn2d(mesh: Mesh, dist_model, nx_global: int, overlap=None,
                              fold_mode="auto"):
    """Jitted shard_map-wrapped 2-D layered step: (state, dt) -> state. ``overlap``
    as in ``sharded_step_fn2d`` (split in both directions, bitwise-equal)."""
    from ..models import layered as lay

    n_y, n_x = mesh.devices.shape
    spmd = Spmd2D(axis_x="x", axis_y="y", n_x=n_x, n_y=n_y, nx_global=nx_global,
                  fold_mode=fold_mode)
    model_specs = jax.tree_util.tree_map(_pspec_for, dist_model)

    def run(dist_state, dt):
        state_specs = jax.tree_util.tree_map(_pspec_for, dist_state)
        fn = jax.shard_map(
            partial(lay.layered_step, spmd=spmd, overlap=overlap),
            mesh=mesh,
            in_specs=(model_specs, state_specs, P()),
            out_specs=state_specs,
        )
        return fn(dist_model, dist_state, dt)

    return jax.jit(run)
