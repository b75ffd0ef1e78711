"""Weak-scaling harness: y-sharded Bickley jet over an N-device mesh.

BASELINE.md's scaling metric is weak-scaling efficiency (>= 80% at N >= 2 hosts). The
harness runs on whatever devices exist: the GPUs of one host, or virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 python bench_scaling.py --platform cpu

NOTE: virtual CPU devices share the host's physical cores, so virtual-mesh efficiency
numbers measure correctness of the sharded path, not scaling (a 2-core host cannot
weak-scale 8 virtual devices); the efficiency target applies to real multi-chip runs.

Weak scaling: the per-device problem size is fixed (ny_per_device rows); efficiency at
N devices = T(1) / T(N) for N-times-larger problems. With the 1-D y decomposition the
fold stays device-local, so the communicated bytes per device are constant in N.

Prints one JSON line per mesh size plus a summary efficiency line.
"""

from __future__ import annotations

import argparse
import json
import time


def run(ndev, nx, ny_per_dev, steps, dt, substeps):
    import jax

    from examples.bickley_jet import build
    from orthogonalsphericalshellgrids_tpu.parallel import (
        distribute, make_mesh, sharded_step_fn,
    )

    ny = ny_per_dev * ndev
    model, state = build(nx, ny, substeps=substeps,
                         first_pole_longitude=45.0, north_poles_latitude=35.0)
    mesh = make_mesh(ndev)
    dist_model, dist_state = distribute(model, state, mesh)
    fn = sharded_step_fn(mesh, dist_model)

    s = jax.block_until_ready(fn(dist_state, dt))
    t0 = time.perf_counter()
    for _ in range(steps):
        s = fn(s, dt)
    jax.block_until_ready(s)
    el = time.perf_counter() - t0
    return nx * ny * steps / el


def run_decomposed(ndev, nx, ny_per_dev, steps, dt, substeps):
    """Per-N sharded-overhead decomposition on the virtual mesh (round-4 verdict
    item 5): communication is fake on virtual CPU devices, but the OVERHEAD
    STRUCTURE of the sharded step — boundary-strip recompute + tendency-patch
    merges (overlap on), halo-fill/collective machinery, shard_map wrapping —
    is real compute and measurable. Returns per-step ms for:

    - ``serial_local``: the UNSHARDED step on one device at the same LOCAL
      problem size (ny_per_dev rows) — the zero-overhead reference,
    - ``unsplit``: the N-device sharded step with ``overlap=False``,
    - ``overlap``: the N-device sharded step with the interior/boundary split.

    On a small host the N local steps timeshare the cores, so the honest
    per-shard cost at N devices is t(N) * min(N, ncores) / N; the table prints
    both raw and core-normalized values. ``overlap − unsplit`` isolates the
    strip-recompute + merge tax the analytic model puts at ~2*(Hy+r)/ny of the
    tendency work (docs/performance.md, weak-scaling section)."""
    import jax

    from examples.bickley_jet import build
    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import multi_step
    from orthogonalsphericalshellgrids_tpu.parallel import (
        distribute, make_mesh, sharded_step_fn,
    )

    def time_fn(fn, s, k=steps, repeats=3):
        # best-of-N: virtual devices timeshare the host's cores and the OS
        # scheduler adds multi-ms noise; min over repeats rejects it
        s = jax.block_until_ready(fn(s))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(k):
                s = fn(s)
            jax.block_until_ready(s)
            best = min(best, (time.perf_counter() - t0) / k)
        return best * 1e3

    out = {"devices": ndev}
    # serial reference at the LOCAL size
    model1, state1 = build(nx, ny_per_dev, substeps=substeps,
                           first_pole_longitude=45.0, north_poles_latitude=35.0)
    sj = jax.jit(lambda s: multi_step(model1, s, dt, 1))
    out["serial_local_ms"] = round(time_fn(sj, state1), 2)

    ny = ny_per_dev * ndev
    model, state = build(nx, ny, substeps=substeps,
                         first_pole_longitude=45.0, north_poles_latitude=35.0)
    mesh = make_mesh(ndev)
    dist_model, dist_state = distribute(model, state, mesh)
    for name, ov in (("unsplit", False), ("overlap", True)):
        fn = sharded_step_fn(mesh, dist_model, overlap=ov)
        out[f"{name}_ms"] = round(time_fn(lambda s: fn(s, dt), dist_state), 2)
    ncores = max(1, len(__import__("os").sched_getaffinity(0)))
    norm = min(ndev, ncores) / ndev
    out["overlap_per_shard_core_norm_ms"] = round(out["overlap_ms"] * norm, 2)
    out["strip_recompute_tax"] = round(
        (out["overlap_ms"] - out["unsplit_ms"]) / out["unsplit_ms"], 3)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--ny-per-dev", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dt", type=float, default=120.0)
    p.add_argument("--substeps", type=int, default=12)
    p.add_argument("--platform", default=None)
    p.add_argument("--sizes", default=None, help="comma-separated mesh sizes")
    p.add_argument("--decompose", action="store_true",
                   help="per-N overhead decomposition (see run_decomposed)")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    ndevs = len(jax.devices())
    sizes = ([int(x) for x in args.sizes.split(",")] if args.sizes
             else [n for n in (1, 2, 4, 8) if n <= ndevs])

    if args.decompose:
        for n in sizes:
            row = run_decomposed(n, args.nx, args.ny_per_dev, args.steps,
                                 args.dt, args.substeps)
            print(json.dumps({"metric": "sharded-overhead decomposition", **row}))
        return

    results = {}
    for n in sizes:
        pts = run(n, args.nx, args.ny_per_dev, args.steps, args.dt, args.substeps)
        results[n] = pts
        print(json.dumps({"metric": "weak-scaling grid-points/s", "devices": n,
                          "value": round(pts, 1), "unit": "points/s"}))

    if 1 in results and len(results) > 1:
        base = results[1]
        for n in sizes[1:]:
            eff = results[n] / (base * n)
            print(json.dumps({"metric": "weak-scaling efficiency",
                              "devices": n, "value": round(eff, 3), "unit": "ratio"}))


if __name__ == "__main__":
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    main()
