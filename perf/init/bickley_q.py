"""Seeded initial state of ``bickley_q``: the Bickley jet of examples/bickley_jet.py
(an unstable sech^2 jet, vortical perturbations, a banded tracer) with the
perturbation's phase and amplitude and the tracer's phase drawn from the seed. Every
seed gives fields of the same shapes and size, so every seed does the same work."""

import numpy as np


def fields(seed):
    """(u, v, c) as functions of (longitude, latitude) in degrees; plain numpy, read
    by the program's initialiser and by the reference alike."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 2.0 * np.pi)
    eps = 0.1 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0))
    c0 = rng.uniform(0.0, 2.0 * np.pi)
    ell, k = 0.5, 2.5

    def psit(x, y):
        return np.exp(-((y + ell / 10) ** 2) / (2 * ell**2)) * np.cos(k * x) * np.cos(k * y)

    def u(lam, phi):
        x, y = np.deg2rad(lam) * 2 + x0, np.deg2rad(phi) * 8
        return 1.0 / np.cosh(y) ** 2 + eps * psit(x, y) * (k * np.tan(k * y) + y / ell**2)

    def v(lam, phi):
        x, y = np.deg2rad(lam) * 2 + x0, np.deg2rad(phi) * 4
        return -eps * psit(x, y) * k * np.tan(k * x)

    def c(lam, phi):
        return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0 + c0)

    return {"u": u, "v": v, "c": c}


def program_state(model, seed):
    """The program's state from these fields, through its own initialiser."""
    from orthogonalsphericalshellgrids_tpu.models import initial_state

    f = fields(seed)
    return initial_state(model, u=f["u"], v=f["v"], c=f["c"])


def outputs():
    """The output writer's fields of examples/bickley_jet.py:main (u, v, c, zeta)."""
    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import _fill, vorticity
    from orthogonalsphericalshellgrids_tpu.ops.location import CF, FC

    def zeta(s):
        g = s.model.grid
        return vorticity(s.model, _fill(g, s.state.u, FC, -1), _fill(g, s.state.v, CF, -1))

    return {"u": lambda s: s.state.u, "v": lambda s: s.state.v,
            "c": lambda s: s.state.c, "zeta": zeta}
