"""Seeded initial state of ``gyre_q_z10``: the T/S stratification of
examples/wind_driven_ts_gyre.py (warm, salty subtropics over a cold, fresh
abyss) plus surface-intensified eddies in u, v and T whose wavenumbers, phases and
amplitudes are drawn from the seed. Every seed gives fields of the same shapes, so
every seed does the same work."""

import numpy as np


def fields(seed):
    """u, v, T, S as functions of (longitude, latitude in degrees, z in m)."""
    rng = np.random.default_rng(seed)
    mu, mv, mt = rng.integers(3, 9, size=3)
    nu_, nv, nt = rng.integers(4, 12, size=3)
    pu, pv, pt, qu, qv, qt = rng.uniform(0.0, 2.0 * np.pi, size=6)
    au, av = rng.uniform(0.03, 0.07, size=2)
    at = rng.uniform(0.3, 0.7)

    def eddy(a, m, n, p, q, depth):
        def f(lam, phi, z):
            return (a * np.cos(m * np.deg2rad(lam) + p) * np.sin(n * np.deg2rad(phi) + q)
                    * np.cos(np.deg2rad(phi)) * np.exp(z / depth))
        return f

    t_eddy = eddy(at, mt, nt, pt, qt, 500.0)

    def T(lam, phi, z):
        return 4.0 + 16.0 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 500.0) + t_eddy(lam, phi, z)

    def S(lam, phi, z):
        return 34.0 + 1.5 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 800.0)

    return {"u": eddy(au, mu, nu_, pu, qu, 800.0), "v": eddy(av, mv, nv, pv, qv, 800.0),
            "T": T, "S": S}


def program_state(model, seed):
    from orthogonalsphericalshellgrids_tpu.models import layered_initial_state

    f = fields(seed)
    return layered_initial_state(model, u=f["u"], v=f["v"], c={"T": f["T"], "S": f["S"]})


def outputs():
    """The output writer's fields of examples/wind_driven_ts_gyre.py:main."""
    def layer0(name, plane):
        return lambda s: getattr(s.state, name)[plane]

    return {"T_surface": layer0("c", 0), "S_surface": lambda s: s.state.c[s.model.nz],
            "u_surface": layer0("u", 0), "eta": lambda s: s.state.eta}
