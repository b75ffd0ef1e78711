"""Distributed (y-sharded) tripolar model over a JAX device mesh.

JAX build of the reference's distributed layer (SURVEY.md §2.3/2.4, C7):
the reference supports exactly 1-D y(j)-partitioning (guard at
``src/distributed_tripolar_grid.jl:30-31``), builds the global grid on the host and
slices a halo-inclusive j-range per rank (``jrange = jstart-Hy:jend+Hy``, :47-49), puts
the zipper fold only on the last rank (:143-147) and MPI halo-communication BCs on
interior ranks (:171).

Here the same decomposition maps to single-controller JAX:

- Every distributed 2-D array is stored globally as ``(n_shards * (ny + 2*Hy), Nx+2*Hx)``
  with ``NamedSharding(P('y', None))`` — each shard's block IS its halo-inclusive local
  array, the direct analog of the reference's halo-inclusive j-range slice.
- The step runs under ``shard_map``; halo exchange is two ``lax.ppermute`` neighbor
  shifts over the mesh's y axis, the zipper fold is a local flip on the top shard
  (each shard holds the full x extent, exactly like the reference's ranks), the south
  fill applies on shard 0 only.
- The barotropic substep loop stays communication-free: the free-surface fields carry
  the widened y-halo per shard, so substeps shrink validity into the halo instead of
  exchanging (the reference's with_halo trick, now per shard).

The local step body is the *same* serial code (models/hydrostatic.py) — the only
injection point is the halo-fill function, selected by the ``Spmd`` tag.
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
from ..ops.spmd import Spmd, fill_halos_spmd
from . import layouts

__all__ = ["Spmd", "fill_halos_spmd", "make_mesh", "distribute", "gather_state",
           "sharded_step_fn", "distribute_layered", "gather_layered_state",
           "sharded_layered_step_fn"]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D y mesh over the available devices, in their order."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise RuntimeError(f"requested a {n_devices}-device mesh but only "
                               f"{len(devices)} device(s) are visible")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("y",))


# --------------------------------------------------------------------------------------
# Serial -> distributed layout conversion
# --------------------------------------------------------------------------------------

def _partition_rows(A: np.ndarray, n: int, ny: int, Hy: int) -> np.ndarray:
    """Global halo-inclusive rows -> stacked per-shard halo-inclusive blocks.

    The k-th block is rows [k*ny, k*ny + ny + 2*Hy) of the global halo-inclusive array —
    the reference's halo-inclusive jrange slice (src/distributed_tripolar_grid.jl:47-49,
    :112-120) expressed in 0-based offsets."""
    blocks = [A[k * ny : k * ny + ny + 2 * Hy] for k in range(n)]
    return np.concatenate(blocks, axis=0)


def _spec_for(leaf, mesh):
    return NamedSharding(mesh, _pspec_for(leaf))


def _pspec_for(leaf):
    if hasattr(leaf, "ndim") and leaf.ndim == 2:
        return P("y", None)
    if hasattr(leaf, "ndim") and leaf.ndim == 3:
        return P(None, "y", None)
    return P()


def _repartition_tree(tree, n: int, ny: int, g, ge):
    """Tag-driven serial -> stacked-per-shard conversion: every leaf's layout comes
    from its registered name (parallel/layouts.py), never from its shape. 3-D leaves
    are stacked planes, row-partitioned per plane."""

    def repartition(path, leaf):
        tag = layouts.leaf_layout(path)
        a = np.asarray(leaf)
        if tag == layouts.REP or a.ndim < 2:
            return a
        Hy = g.Hy if tag == layouts.BASE else ge.Hy
        rows = g.Ny + 2 * Hy
        if a.ndim == 2:
            if a.shape[0] != rows:
                raise ValueError(
                    f"leaf {jax.tree_util.keystr(path)} tagged {tag!r} has "
                    f"{a.shape[0]} rows, layout expects {rows}")
            return _partition_rows(a, n, ny, Hy)
        if a.shape[1] != rows:
            raise ValueError(
                f"3-D leaf {jax.tree_util.keystr(path)} tagged {tag!r} has "
                f"{a.shape[1]} rows, layout expects {rows}")
        return np.stack([_partition_rows(a[k], n, ny, Hy)
                         for k in range(a.shape[0])])

    return jax.tree_util.tree_map_with_path(repartition, tree)


def distribute(model: HydrostaticModel, state: State, mesh: Mesh):
    """Partition a serial model+state onto the mesh.

    Returns (dist_model, dist_state) whose 2-D leaves are ``(n*(ny+2Hy), X)`` arrays
    sharded over the mesh's y axis, and whose grid metadata is rewritten to the LOCAL
    sizes (Ny -> ny) so the unchanged serial step code runs correctly inside shard_map.
    Requires Ny % n == 0 and ny >= the extended y-halo."""
    n = mesh.devices.size
    g, ge = model.grid, model.grid_ext
    if g.Ny % n != 0:
        raise ValueError(f"Ny={g.Ny} must be divisible by the number of shards {n}")
    ny = g.Ny // n
    if ny < ge.Hy:
        raise ValueError(
            f"local rows ny={ny} must cover the extended halo Hy={ge.Hy} "
            f"(the communication-free barotropic loop folds that far)"
        )

    dist_model_host = _repartition_tree(model, n, ny, g, ge)
    dist_state_host = _repartition_tree(state, n, ny, g, ge)

    # rewrite static metadata to local sizes
    local_grid = dataclasses.replace(dist_model_host.grid, Ny=ny)
    local_grid_ext = dataclasses.replace(dist_model_host.grid_ext, Ny=ny)
    dist_model_host = dataclasses.replace(
        dist_model_host, grid=local_grid, grid_ext=local_grid_ext
    )

    put = lambda tree: jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, _spec_for(leaf, mesh)), tree
    )
    return put(dist_model_host), put(dist_state_host)


def _gather_tree(dist_tree, n: int, g, ge):
    """Tag-driven stacked-per-shard -> serial-layout conversion (the analog of the
    reference's reconstruct_global_grid path for fields,
    src/distributed_tripolar_grid.jl:201-226): keep each shard's interior rows; halos
    re-fill from the serial grid's fill on next use."""
    ny = g.Ny // n

    def unpart2(a, Hy):
        block_rows = ny + 2 * Hy
        interiors = [a[k * block_rows + Hy : k * block_rows + Hy + ny] for k in range(n)]
        out = np.zeros((g.Ny + 2 * Hy, a.shape[-1]), a.dtype)
        out[Hy : Hy + g.Ny] = np.concatenate(interiors, axis=0)
        return out

    def conv(path, leaf):
        tag = layouts.leaf_layout(path)
        a = np.asarray(leaf)
        if tag == layouts.REP or a.ndim < 2:
            # a replicated scalar may come back with a per-shard leading axis
            return jnp.asarray(a.ravel()[0]) if a.ndim > 0 and a.size > 1 else leaf
        Hy = g.Hy if tag == layouts.BASE else ge.Hy
        if a.ndim == 3:
            return jnp.asarray(np.stack([unpart2(a[k], Hy) for k in range(a.shape[0])]))
        return jnp.asarray(unpart2(a, Hy))

    return jax.tree_util.tree_map_with_path(conv, dist_tree)


def gather_state(dist_state: State, model_serial: HydrostaticModel, n: int) -> State:
    """Reassemble a serial-layout State from a distributed one."""
    return _gather_tree(dist_state, n, model_serial.grid, model_serial.grid_ext)


def sharded_step_fn(mesh: Mesh, dist_model: HydrostaticModel, overlap=None):
    """Jitted shard_map-wrapped step over the mesh. Returned fn: (state, dt) -> state.

    ``overlap`` (default: on) selects the interior/boundary-split tendency path so
    the ppermute halo exchange runs concurrently with the bulk stencil compute;
    results are bitwise-equal either way (test_overlap_split_bitwise)."""
    n = mesh.devices.size
    spmd = Spmd(axis_name="y", n_shards=n)

    model_specs = jax.tree_util.tree_map(_pspec_for, dist_model)
    state_specs_fn = lambda s: jax.tree_util.tree_map(_pspec_for, s)

    def run(dist_state, dt):
        state_specs = state_specs_fn(dist_state)
        local = partial(hydro.step, spmd=spmd, overlap=overlap)
        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(model_specs, state_specs, P()),
            out_specs=state_specs,
        )
        return fn(dist_model, dist_state, dt)

    return jax.jit(run)


# --------------------------------------------------------------------------------------
# Layered (Nz > 1) model distribution — same y-decomposition, 3-D (Nz, y, x) leaves
# --------------------------------------------------------------------------------------

def distribute_layered(model, state, mesh: Mesh):
    """Partition a layered model+state onto the mesh (the single-layer ``distribute``
    extended to (Nz, y, x) leaves: the layer axis is replicated, rows are sharded).

    Every 3-D leaf (per-layer state fields and masks) is partitioned along its row
    axis into halo-inclusive per-shard blocks; grid metadata is rewritten to local sizes so
    the unchanged serial layered_step runs inside shard_map."""
    n = mesh.devices.size
    g, ge = model.grid, model.baro.grid_ext
    if g.Ny % n != 0:
        raise ValueError(f"Ny={g.Ny} must be divisible by the number of shards {n}")
    ny = g.Ny // n
    if ny < ge.Hy:
        raise ValueError(f"local rows ny={ny} must cover the extended halo Hy={ge.Hy}")

    dist_model = _repartition_tree(model, n, ny, g, ge)
    dist_state = _repartition_tree(state, n, ny, g, ge)

    local_baro = dataclasses.replace(
        dist_model.baro,
        grid=dataclasses.replace(dist_model.baro.grid, Ny=ny),
        grid_ext=dataclasses.replace(dist_model.baro.grid_ext, Ny=ny),
    )
    dist_model = dataclasses.replace(dist_model, baro=local_baro)

    put = lambda tree: jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, _spec_for(leaf, mesh)), tree)
    return put(dist_model), put(dist_state)


def gather_layered_state(dist_state, model_serial, n: int):
    """Reassemble a serial-layout LayeredState from a distributed one (interior rows
    per shard; halos re-filled by the serial step on next use)."""
    return _gather_tree(dist_state, n, model_serial.grid, model_serial.baro.grid_ext)


def sharded_layered_step_fn(mesh: Mesh, dist_model, overlap=None):
    """Jitted shard_map-wrapped layered step over the mesh: (state, dt) -> state.

    ``overlap`` (default: on when the halo width statically supports it) selects the
    interior/boundary-split tendency path — the exchange collectives and the bulk
    per-layer stencil pass are data-independent so they can run concurrently;
    results are bitwise-equal either way (test_layered_overlap_split_bitwise)."""
    from ..models import layered as lay

    n = mesh.devices.size
    spmd = Spmd(axis_name="y", n_shards=n)
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
