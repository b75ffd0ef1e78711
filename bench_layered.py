"""Layered-engine benchmark: wind-driven T/S gyre on the 1/4-degree (1440x680)
tripolar grid, Nz=10 stretched layers, T/S + linear EOS, Coriolis, wind stress +
quadratic bottom drag, horizontal/vertical mixing, split-explicit substeps=30, one GPU.

Prints ONE JSON line: steady-state grid-points/s with points = Nx*Ny*Nz (9.79M per
step), the device and the card's power limit. Timing as in bench.py.
"""

from __future__ import annotations

import json
import sys


def run(nx=1440, ny=680, nz=10, substeps=30, steps=30):
    """Run the layered benchmark; returns the metric dict (see module docstring)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from bench import device_info, time_blocks
    from examples.wind_driven_ts_gyre import build
    from orthogonalsphericalshellgrids_tpu.models.layered import layered_multi_step

    info = device_info()
    model, state = build(nx=nx, ny=ny, nz=nz, substeps=substeps)
    block = 10
    sj = jax.jit(partial(layered_multi_step, n_steps=block), donate_argnums=(1,))
    ms, s = time_blocks(sj, model, state, 40.0, max(steps // block, 1), block)
    assert bool(jnp.all(jnp.isfinite(s.u))), "benchmark produced non-finite fields"
    return {
        "metric": (f"grid-points/s (T/S gyre, 1/4deg x {nz} layers, linear EOS, "
                   f"WENO-5 + split-explicit substeps={substeps})"),
        "value": round(nx * ny * nz / ms * 1e3, 1),
        "unit": "grid-points/s",
        "ms_per_step": round(ms, 4),
        **info,
    }


def main(**kw):
    print(json.dumps(run(**kw)), flush=True)


if __name__ == "__main__":
    kw = {}
    for arg in sys.argv[1:]:
        k, v = arg.lstrip("-").split("=")
        kw[k] = int(v)
    main(**kw)
