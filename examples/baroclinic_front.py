"""Baroclinic front adjustment on a tripolar grid — the layered (Nz > 1) engine.

A mid-latitude buoyancy front (light water to the south, dense to the north, stable
background stratification) adjusts under rotation: the thermal-wind shear spins up a
frontal jet and, at coarse resolution, the front slumps toward geostrophic balance.
Exercises the full layered capability set: buoyancy-driven baroclinic pressure
gradient, vertical advection, split-explicit barotropic coupling, Coriolis, the
Simulation driver with a CFL wizard, and layered field output.

The reference has no layered workload (every example is Nz = 1); this demonstrates the
capability surface its model engine (Oceananigans HydrostaticFreeSurfaceModel with
BuoyancyTracer) provides beyond the published examples.

Run:  python examples/baroclinic_front.py [--nx 120 --ny 60 --nz 8 --days 10]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build(nx=120, ny=60, nz=8, dtype=None, substeps=20,
          first_pole_longitude=70.0, north_poles_latitude=55.0, depth=1000.0):
    import jax.numpy as jnp

    import orthogonalsphericalshellgrids_tpu as osg
    from orthogonalsphericalshellgrids_tpu.models import (
        SplitExplicitFreeSurface, layered_initial_state, make_layered_model,
    )

    if dtype is None:
        dtype = jnp.float32

    grid = osg.TripolarGrid.make(
        (nx, ny, nz), halo=(5, 5, 5), z=(-depth, 0.0),
        first_pole_longitude=first_pole_longitude,
        north_poles_latitude=north_poles_latitude,
        dtype=dtype,
    )
    lam_p, phi_p = first_pole_longitude, north_poles_latitude

    def bottom(lam, phi):
        land = (
            ((np.abs(lam - lam_p) < 8) & (np.abs(phi_p - phi) < 8))
            | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 8) & (np.abs(phi_p - phi) < 8))
            | (phi < -78)
        )
        return np.where(land, 1.0, -depth)

    model = make_layered_model(
        grid,
        free_surface=SplitExplicitFreeSurface(substeps=substeps),
        bottom_height=bottom,
        buoyancy=True,
        coriolis=True,
        nu_v=1e-4,
        kappa_v=1e-5,
    )

    # Stable stratification N² = 1e-5 s⁻² plus a tanh buoyancy front at 30°N,
    # surface-intensified (decays over the top half of the column).
    N2, db, phi0, dphi = 1e-5, 2e-3, 30.0, 5.0

    def bi(lam, phi, z):
        front = -0.5 * db * np.tanh((phi - phi0) / dphi)
        return N2 * z + front * np.exp(z / (0.5 * depth))

    state = layered_initial_state(model, b=bi)
    return model, state


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=120)
    p.add_argument("--ny", type=int, default=60)
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--days", type=float, default=10.0)
    p.add_argument("--dt", type=float, default=120.0)
    p.add_argument("--platform", default=None, help="cpu | gpu (default: env)")
    p.add_argument("--out", default="tripolar_baroclinic_front.npz")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from orthogonalsphericalshellgrids_tpu.utils import (
        IterationInterval, OutputWriter, Simulation, TimeInterval, TimeStepWizard,
        progress_callback,
    )

    model, state = build(args.nx, args.ny, args.nz)

    sim = Simulation(model, state, dt=args.dt, stop_time=args.days * 86400.0)

    wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=1800.0)
    sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                     IterationInterval(10))
    sim.add_callback(progress_callback(), IterationInterval(20))

    writer = OutputWriter(args.out, {
        "u_surface": lambda s: s.state.u[0],
        "u_bottom": lambda s: s.state.u[-1],
        "b_surface": lambda s: s.state.b[0],
        "eta": lambda s: s.state.eta,
    })
    sim.add_callback(writer, TimeInterval(86400.0))

    sim.run()
    print(f"done: iter={sim.iteration} t={sim.time/86400:.1f} days -> {args.out}")


if __name__ == "__main__":
    main()
