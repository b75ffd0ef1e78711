"""Explicit per-leaf distributed-layout classification.

Every leaf of a model/state pytree is tagged ``base`` (base-halo grid layout),
``ext`` (extended free-surface-halo layout) or ``rep`` (replicated) by NAME, via the
tables below — never by sniffing array shapes. Shape fingerprinting (the round-1
approach) mis-partitions silently the first time two layouts collide; here an
unclassified leaf raises immediately with the attribute path, so adding a new model
field forces a conscious layout decision.

The tag is the single source of truth for both directions of the conversion:
``parallel/distributed.py`` (1-D y) and ``parallel/distributed2d.py`` (2-D x,y) use it
to partition, gather, and build PartitionSpecs.

3-D leaves are stacked planes (a leading axis of layers); each plane carries the
tagged 2-D layout.
"""

from __future__ import annotations

import jax

__all__ = ["BASE", "EXT", "REP", "leaf_layout", "classify_tree"]

BASE, EXT, REP = "base", "ext", "rep"

# Containers: every array leaf under these attributes inherits the container's layout.
_CONTAINERS = {"grid": BASE, "grid_ext": EXT, "ib": BASE}

# 1-D / scalar grid members that are replicated regardless of container.
_REPLICATED_GRID_MEMBERS = {"z_f", "z_c"}

# State leaves (single-layer State and LayeredState share names).
_STATE_FIELDS = {
    "u": BASE, "v": BASE, "c": BASE, "b": BASE,
    "Gu": BASE, "Gv": BASE, "Gc": BASE, "Gb": BASE,
    "eta": EXT, "U": EXT, "V": EXT,
    "t": REP, "iteration": REP,
}

# HydrostaticModel array leaves (models/hydrostatic.py:_MODEL_ARRAYS minus containers).
_MODEL_FIELDS = {
    "inv_dx_fc": BASE, "inv_dy_cf": BASE, "inv_az_ff": BASE, "inv_vol_c": BASE,
    "inv_dx_fc_e": EXT, "inv_dy_cf_e": EXT, "inv_az_cc_e": EXT,
    "dy_fc_e": EXT, "dx_cf_e": EXT,
    "h_u_e": EXT, "h_v_e": EXT, "mask_u_e": EXT, "mask_v_e": EXT,
    "weights": REP,
    "f_ff": BASE, "taux": BASE, "tauy": BASE,
}

# LayeredModel additions (3-D leaves are (Nz, Yb, Xb) layer stacks).
_LAYERED_FIELDS = {
    "mask_c3": BASE, "mask_u3": BASE, "mask_v3": BASE,
    "dzu": BASE, "dzv": BASE,
    "inv_h_u": BASE, "inv_h_v": BASE,
    "bot_u": BASE, "bot_v": BASE,
}

_FIELDS = {**_STATE_FIELDS, **_MODEL_FIELDS, **_LAYERED_FIELDS}


def _names(path) -> list[str]:
    out = []
    for k in path:
        name = getattr(k, "name", None)
        if name is not None:
            out.append(name)
    return out


def leaf_layout(path) -> str:
    """Layout tag for the leaf at ``path`` (a jax key path of GetAttrKeys).

    Raises ``KeyError`` for unknown attribute names — new fields must be added to the
    tables above before they can be distributed.
    """
    names = _names(path)
    if not names:
        raise KeyError("cannot classify an un-named pytree leaf; wrap it in a "
                       "registered dataclass field")
    if names[0] == "baro":  # LayeredModel wraps the single-layer model
        names = names[1:]
    if names and names[0] in _CONTAINERS:
        if names[-1] in _REPLICATED_GRID_MEMBERS:
            return REP
        return _CONTAINERS[names[0]]
    leaf_name = names[-1]
    try:
        return _FIELDS[leaf_name]
    except KeyError:
        raise KeyError(
            f"no distributed layout registered for pytree leaf {'.'.join(names)!r}; "
            f"add it to parallel/layouts.py") from None


def classify_tree(tree):
    """Pytree of layout tags mirroring ``tree`` (same treedef, str leaves)."""
    return jax.tree_util.tree_map_with_path(lambda p, _: leaf_layout(p), tree)
