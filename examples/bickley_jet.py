"""Bickley-jet barotropic turbulence on a tripolar grid — the reference's flagship
workload (examples/bickley_jet.jl), in JAX.

Physics: an unstable zonal jet U = sech²(y) with vortical perturbations and a
sinusoidal tracer, WENO-5 vector-invariant momentum + flux-form WENO-5 tracer,
split-explicit free surface (substeps=30), immersed-boundary masking of the two north
singularities and Antarctica, CFL-0.3 adaptive stepping, periodic field output.

Run:  python examples/bickley_jet.py [--nx 180 --ny 90 --days 50 --platform gpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np


def build(nx=180, ny=90, dtype=None, substeps=30,
          first_pole_longitude=45.0, north_poles_latitude=25.0, **model_kwargs):
    import jax.numpy as jnp

    import orthogonalsphericalshellgrids_tpu as osg
    from orthogonalsphericalshellgrids_tpu.models import (
        SplitExplicitFreeSurface, initial_state, make_model,
    )

    if dtype is None:
        dtype = jnp.float32

    grid = osg.TripolarGrid.make(
        (nx, ny, 1), halo=(5, 5, 5),
        first_pole_longitude=first_pole_longitude,
        north_poles_latitude=north_poles_latitude,
        dtype=dtype,
    )

    lam_p, phi_p = first_pole_longitude, north_poles_latitude

    def bottom(lam, phi):
        # mask the singularities and Antarctica (examples/bickley_jet.jl:27-29)
        land = (
            ((np.abs(lam - lam_p) < 5) & (np.abs(phi_p - phi) < 5))
            | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 5) & (np.abs(phi_p - phi) < 5))
            | (phi < -78)
        )
        return np.where(land, 1.0, 0.0)

    model = make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
                       bottom_height=bottom, **model_kwargs)

    # Initial conditions (examples/bickley_jet.jl:57-73)
    eps, ell, k = 0.1, 0.5, 2.5

    def psit(x, y):
        return np.exp(-((y + ell / 10) ** 2) / (2 * ell**2)) * np.cos(k * x) * np.cos(k * y)

    def ui(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 8
        return 1.0 / np.cosh(y) ** 2 + eps * psit(x, y) * (k * np.tan(k * y) + y / ell**2)

    def vi(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 4
        return -eps * psit(x, y) * k * np.tan(k * x)

    def ci(lam, phi):
        return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0)

    state = initial_state(model, u=ui, v=vi, c=ci)
    return model, state


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=180)
    p.add_argument("--ny", type=int, default=90)
    p.add_argument("--days", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=60.0)
    p.add_argument("--platform", default=None, help="cpu | gpu (default: env)")
    p.add_argument("--out", default="tripolar_bickley.npz")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp

    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import _fill, vorticity
    from orthogonalsphericalshellgrids_tpu.ops.location import CF, FC
    from orthogonalsphericalshellgrids_tpu.utils import (
        IterationInterval, OutputWriter, Simulation, TimeInterval, TimeStepWizard,
        progress_callback,
    )

    model, state = build(args.nx, args.ny)

    sim = Simulation(model, state, dt=args.dt, stop_time=args.days * 86400.0)

    wizard = TimeStepWizard(cfl=0.3, max_change=1.1, max_dt=3 * 3600.0)
    sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                     IterationInterval(10))
    sim.add_callback(progress_callback(), IterationInterval(10))

    def zeta_out(s):
        g = s.model.grid
        u = _fill(g, s.state.u, FC, -1)
        v = _fill(g, s.state.v, CF, -1)
        return vorticity(s.model, u, v)

    writer = OutputWriter(args.out, {
        "u": lambda s: s.state.u,
        "v": lambda s: s.state.v,
        "c": lambda s: s.state.c,
        "zeta": zeta_out,
    })
    sim.add_callback(writer, TimeInterval(86400.0))

    sim.run()
    print(f"done: iter={sim.iteration} t={sim.time/86400:.1f} days -> {args.out}")


if __name__ == "__main__":
    main()
