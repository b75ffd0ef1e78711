"""Distributed Bickley jet: the reference's examples/distributed_bickley_jet.jl
(320x240, y-partitioned over 4 ranks), in JAX.

Instead of MPI ranks, the state is y-sharded over a JAX device mesh; the step runs
under shard_map with ppermute halo exchange (parallel/distributed.py). On a machine
without multiple accelerators, run with virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=4 \
  python examples/distributed_bickley_jet.py --platform cpu --ndev 4

The fold-aware 2-D (x, y) decomposition — which the reference explicitly rejects
(src/distributed_tripolar_grid.jl:30-31) — runs with --decomp 2d --ndev-x 2 --ndev 2:
the zipper fold's x-mirror becomes a ppermute to the mirror shard.
"""

from __future__ import annotations

import argparse
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=320)
    p.add_argument("--ny", type=int, default=240)
    p.add_argument("--ndev", type=int, default=4, help="devices along y")
    p.add_argument("--ndev-x", type=int, default=1, help="devices along x (2-D decomposition)")
    p.add_argument("--decomp", choices=["1d", "2d"], default="1d")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--dt", type=float, default=120.0)
    p.add_argument("--platform", default=None)
    p.add_argument("--output", default=None,
                   help="base filename for per-shard dumps (<stem>.rank<k>.npz, "
                        "the reference's per-rank files, "
                        "examples/distributed_bickley_jet.jl:83-87); 1-D decomposition")
    args = p.parse_args()

    import os

    n_total_req = args.ndev * (args.ndev_x if args.decomp == "2d" else 1)
    if args.platform == "cpu":
        # virtual CPU devices for mesh testing (must precede backend init)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={n_total_req}")

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp

    from examples.bickley_jet import build
    from orthogonalsphericalshellgrids_tpu.models.diagnostics import max_speeds
    from orthogonalsphericalshellgrids_tpu.parallel import (
        distribute, gather_state, make_mesh, sharded_step_fn,
    )

    model, state = build(args.nx, args.ny, first_pole_longitude=45.0,
                         north_poles_latitude=35.0)
    if args.decomp == "2d":
        from orthogonalsphericalshellgrids_tpu.parallel import (
            distribute2d, gather_state2d, make_mesh2d, sharded_step_fn2d,
        )
        mesh = make_mesh2d(args.ndev_x, args.ndev)
        dist_model, dist_state = distribute2d(model, state, mesh)
        fn = sharded_step_fn2d(mesh, dist_model, args.nx)
        gather = lambda s: gather_state2d(s, model, mesh)
        n_total = args.ndev_x * args.ndev
    else:
        mesh = make_mesh(args.ndev)
        dist_model, dist_state = distribute(model, state, mesh)
        fn = sharded_step_fn(mesh, dist_model)
        gather = lambda s: gather_state(s, model, args.ndev)
        n_total = args.ndev

    writer = None
    if args.output:
        if args.decomp != "1d":
            raise SystemExit("--output per-shard dumps follow the 1-D decomposition")
        from orthogonalsphericalshellgrids_tpu.utils.output import ShardedOutputWriter

        writer = ShardedOutputWriter(args.output, {}, dist_model)

    s = fn(dist_state, args.dt)  # compile
    jax.block_until_ready(s)
    t0 = time.time()
    for i in range(args.steps):
        s = fn(s, args.dt)
        if (i + 1) % 50 == 0:
            g = gather(s)
            umax, vmax = max_speeds(model, g)
            print(f"iter {i+1}: velocity {float(umax):.2e} {float(vmax):.2e}")
            if writer is not None:  # each shard's interior, no global gather
                writer.write((i + 1) * args.dt, {"u": s.u, "v": s.v, "c": s.c,
                                                 "eta": s.eta})
    jax.block_until_ready(s)
    el = time.time() - t0
    print(f"{args.steps} steps on {n_total} devices ({args.decomp}): {el:.2f}s "
          f"({args.nx*args.ny*args.steps/el/1e6:.1f} M gridpoint-steps/s)")


if __name__ == "__main__":
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    main()
