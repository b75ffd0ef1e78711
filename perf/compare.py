"""The comparison that decides ``correct``: the fields the timed path produced after
its first steps against the plain reference (perf/configs/<config>.py) run over the
same steps from the same seed, each field's widest gap against its limit; and, over
the whole window, that every field stayed finite and that the state advanced by
exactly the steps the loop made."""

from __future__ import annotations

import numpy as np


def field_gaps(program, reference):
    """{field: max|program - reference| / scale} over the interior; ``reference``
    maps each field to (array, scale)."""
    gaps = {}
    for name, (ref, scale) in reference.items():
        d = np.abs(np.asarray(program[name], np.float64) - ref)
        gaps[name] = float(np.max(d)) / max(scale, 1e-300) if np.all(np.isfinite(d)) else float("inf")
    return gaps


def nonfinite(state):
    """Number of non-finite values in the floating leaves of a pytree."""
    import jax

    n = 0
    for leaf in jax.tree_util.tree_leaves(state):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating):
            n += int(a.size - np.count_nonzero(np.isfinite(a)))
    return n


def checks(gaps, limits, iteration_gap, n_nonfinite):
    """[(name, value, limit)] for every number compared, gaps first."""
    out = [(f"{name}_gap", value, limits[name]) for name, value in gaps.items()]
    out.append(("iteration_gap", float(iteration_gap), 0.0))
    out.append(("nonfinite", float(n_nonfinite), 0.0))
    return out


def passed(rows):
    return all(value <= limit for _, value, limit in rows)
