"""Bickley jet on the 1/4-degree (1440x680) tripolar grid, one GPU: steady-state
grid-points/s of the single-layer step, then the layered T/S gyre (bench_layered.py).

Prints ONE JSON line on stdout (the single-layer result); the layered result goes
to stderr as its own JSON line. Both name the device (platform, device_kind, device
count) and the card's power limit. The script fails where JAX finds no GPU, and
fails if either run fails.

Timing: 10-step scanned blocks (the TimeStepWizard cadence), compile and warm-up
excluded, each window closed by ``block_until_ready``; best of 3 windows.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def device_info():
    """platform, device_kind, device count and the cards' nvidia-smi power limit;
    exits when the default device is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: no GPU: JAX's devices are {devs}")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "nvidia_smi": power}


def time_blocks(fn, model, state, dt, blocks, block, warmup=3, rounds=3):
    """Best-of-``rounds`` ms/step over ``blocks`` calls of a ``block``-step function;
    returns (ms_per_step, final_state)."""
    import jax

    s = state
    for _ in range(warmup):
        s = fn(model, s, dt)
    jax.block_until_ready(s)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(blocks):
            s = fn(model, s, dt)
        jax.block_until_ready(s)
        best = min(best, (time.perf_counter() - t0) / (blocks * block))
    return best * 1e3, s


def main(nx=1440, ny=680, substeps=30, steps=30):
    from functools import partial

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from examples.bickley_jet import build
    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import multi_step

    info = device_info()
    model, state = build(nx=nx, ny=ny, substeps=substeps)
    block = 10
    sj = jax.jit(partial(multi_step, n_steps=block), donate_argnums=(1,))
    ms, s = time_blocks(sj, model, state, 60.0, max(steps // block, 1), block)
    assert bool(jnp.all(jnp.isfinite(s.u))), "benchmark produced non-finite fields"

    import bench_layered

    print(json.dumps(bench_layered.run()), file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": ("grid-points/s (Bickley jet, 1/4deg tripolar, WENO-5 + "
                   f"split-explicit substeps={substeps})"),
        "value": round(nx * ny / ms * 1e3, 1),
        "unit": "grid-points/s",
        "ms_per_step": round(ms, 4),
        **info,
    }), flush=True)


if __name__ == "__main__":
    kw = {}
    for arg in sys.argv[1:]:
        k, v = arg.lstrip("-").split("=")
        kw[k] = int(v)
    main(**kw)
