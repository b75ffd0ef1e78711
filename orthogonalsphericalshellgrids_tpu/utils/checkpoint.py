"""Checkpoint / resume for the model state.

The reference repo has no checkpointing (SURVEY.md §5: Oceananigans provides a
Checkpointer but no reference file uses it); the state-pytree design makes it trivial
here. Uses orbax when available (the production path on multi-host runs: async,
sharding-aware), falling back to a plain npz of the flattened pytree.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from ..models.hydrostatic import State

__all__ = ["save_checkpoint", "load_checkpoint"]


def _leaves(state: State):
    leaves, treedef = jax.tree_util.tree_flatten(state)
    return leaves, treedef


def save_checkpoint(path: str, state: State) -> None:
    """Write the state pytree. Directory path -> orbax; ``.npz`` path -> npz."""
    if path.endswith(".npz"):
        leaves, _ = _leaves(state)
        # atomic: a crash mid-write (OOM/preemption — the very case pickup resume
        # exists for) must not leave a truncated newest-looking checkpoint behind
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
        os.replace(tmp, path)
        return
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), state, force=True)
    ckptr.wait_until_finished()


def load_checkpoint(path: str, like: State) -> State:
    """Load a state pytree saved by save_checkpoint; ``like`` supplies the structure
    (and for orbax, the shardings/dtypes to restore into)."""
    if path.endswith(".npz"):
        import jax.numpy as jnp

        _, treedef = _leaves(like)
        with np.load(path) as data:
            leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(data.files))]
        return jax.tree_util.tree_unflatten(treedef, leaves)
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), target=like)
