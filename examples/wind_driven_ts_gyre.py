"""Wind-driven stratified gyres with T/S thermodynamics — the production feature set.

A meridional continental barrier turns the tripolar x-periodic domain into a closed
basin; steady zonal wind stress (easterly trades, mid-latitude westerlies) then spins
up subtropical/subpolar gyres with western intensification. Temperature and salinity
are active tracers through the linear seawater EOS (`buoyancy="linear_eos"`), layers
are stretched (thin near the surface), and the momentum budget carries Coriolis,
quadratic bottom drag, and horizontal + vertical mixing.

This exercises, in one workload, every capability added beyond the reference's
published examples (which are all single-layer, unforced, single-tracer —
``examples/bickley_jet.jl``): multi-tracer stacks, the seawater EOS, stretched
vertical coordinates, wind/drag forcing, and the layered split-explicit engine.

Run:  python examples/wind_driven_ts_gyre.py [--nx 180 --ny 80 --nz 6 --days 30]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build(nx=180, ny=80, nz=6, dtype=None, substeps=20,
          first_pole_longitude=70.0, north_poles_latitude=55.0, depth=2000.0,
          **model_kwargs):
    import jax.numpy as jnp

    import orthogonalsphericalshellgrids_tpu as osg
    from orthogonalsphericalshellgrids_tpu.models import (
        SplitExplicitFreeSurface, layered_initial_state, make_layered_model,
    )

    if dtype is None:
        dtype = jnp.float32

    # stretched layers: geometric taper (each layer ~1.7x the one above), any nz
    frac = 1.7 ** np.arange(nz, dtype=np.float64)
    frac = frac / frac.sum()
    z_faces = -depth + depth * np.concatenate([[0.0], np.cumsum(frac[::-1])])
    grid = osg.TripolarGrid.make(
        (nx, ny, nz), halo=(5, 5, 5), z=z_faces,
        first_pole_longitude=first_pole_longitude,
        north_poles_latitude=north_poles_latitude,
        dtype=dtype,
    )
    lam_p, phi_p = first_pole_longitude, north_poles_latitude

    def bottom(lam, phi):
        # pole singularity masks + Antarctica + a meridional continental barrier
        # (20 deg wide at lam_p+90) that closes the basin so gyres can form
        barrier_lon = (lam_p + 90.0) % 360.0
        dlon = np.minimum(np.abs(lam - barrier_lon), 360.0 - np.abs(lam - barrier_lon))
        land = (
            ((np.abs(lam - lam_p) < 8) & (np.abs(phi_p - phi) < 8))
            | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 8) & (np.abs(phi_p - phi) < 8))
            | (phi < -78)
            | ((dlon < 10.0) & (phi > -70) & (phi < 70))
        )
        return np.where(land, 1.0, -depth)

    def wind(lam, phi):
        # idealized zonal stress: easterly trades, westerlies poleward of ~30 deg
        tau0 = 1e-4  # kinematic stress [m^2/s^2] ~ 0.1 N/m^2 / rho0
        taux = -tau0 * np.cos(np.deg2rad(phi) * 3.0) * np.cos(np.deg2rad(phi))
        return taux, np.zeros_like(taux)

    model = make_layered_model(
        grid,
        free_surface=SplitExplicitFreeSurface(substeps=substeps),
        bottom_height=bottom,
        tracers=("T", "S"),
        buoyancy="linear_eos",
        coriolis=True,
        wind_stress=wind,
        bottom_drag=("quadratic", 2.5e-3),
        nu_h=5e3,
        kappa_h=1e2,
        nu_v=1e-3,
        kappa_v=1e-5,
        **model_kwargs,
    )

    # warm/salty subtropics, cold/fresh poles; surface-intensified stratification
    def Ti(lam, phi, z):
        return 4.0 + 16.0 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 500.0)

    def Si(lam, phi, z):
        return 34.0 + 1.5 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 800.0)

    state = layered_initial_state(model, c={"T": Ti, "S": Si})
    return model, state


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=180)
    p.add_argument("--ny", type=int, default=80)
    p.add_argument("--nz", type=int, default=6)
    p.add_argument("--days", type=float, default=30.0)
    p.add_argument("--dt", type=float, default=300.0)
    p.add_argument("--platform", default=None, help="cpu | gpu (default: env)")
    p.add_argument("--out", default="tripolar_ts_gyre.npz")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from orthogonalsphericalshellgrids_tpu.utils import (
        IterationInterval, OutputWriter, Simulation, TimeInterval, TimeStepWizard,
        progress_callback,
    )

    model, state = build(args.nx, args.ny, args.nz)
    nz = model.nz

    sim = Simulation(model, state, dt=args.dt, stop_time=args.days * 86400.0)

    wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=3600.0)
    sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                     IterationInterval(10))
    sim.add_callback(progress_callback(), IterationInterval(50))

    writer = OutputWriter(args.out, {
        "T_surface": lambda s: s.state.c[0],          # tracer 0 = T, layer 0
        "S_surface": lambda s: s.state.c[nz],         # tracer 1 = S, layer 0
        "u_surface": lambda s: s.state.u[0],
        "eta": lambda s: s.state.eta,
    })
    sim.add_callback(writer, TimeInterval(5 * 86400.0))

    sim.run()
    print(f"done: iter={sim.iteration} t={sim.time/86400:.1f} days -> {args.out}")


if __name__ == "__main__":
    main()
