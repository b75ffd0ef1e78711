"""Precision bands of the XLA formulation: float32 against float64.

Every configuration the model supports runs through one XLA formulation (there is
no second, hand-written path to pin it against). These tests hold the float32 build
of each configuration to its float64 build, for the horizontal + vertical
tendencies and for one full step, as max|f32 - f64| / max|f64| over the interior.

Why the bands are what they are: the float32 inputs (grid metrics, masks, initial
fields) already differ from the float64 ones by ~6e-8 relative, and a tendency is a
difference of metric-weighted fluxes that cancel to a part in 1e2..1e3 of their
size. Measured here: at most 1.6e-5 of each tendency's maximum, except where the
baroclinic pressure gradient dominates Gu/Gv (T/S without Coriolis): there the
gradient is a horizontal difference of a hydrostatic pressure ~1e3 times larger,
and float32 carries 6.1e-4. One step then sits at <= 8.7e-7 for every field. The
bands are those worst cases times about 10; a dropped or mis-signed term is
O(1e-2..1) of the field.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import orthogonalsphericalshellgrids_tpu as osg
from orthogonalsphericalshellgrids_tpu.models import (
    SplitExplicitFreeSurface, initial_state, layered_initial_state, layered_step,
    make_layered_model, make_model, step)
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as H
from orthogonalsphericalshellgrids_tpu.models import layered as L
from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC

TEND_BAND_DEFAULT = 2e-4
TEND_BAND = {"explicit_mixing": 5e-3, "implicit_mixing": 5e-3}  # pressure-gradient bound
STEP_BAND = 1e-5
LAM_P, PHI_P = 45.0, 25.0


def bottom(lam, phi):
    land = (((np.abs(lam - LAM_P) < 10) & (np.abs(PHI_P - phi) < 10))
            | ((np.abs(lam - (LAM_P + 180.0)) < 10) & (np.abs(PHI_P - phi) < 10))
            | (phi < -78))
    return np.where(land, 1.0, -1000.0)


def ui(lam, phi, z=0.0):
    return 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2 * (1.0 + z / 2000.0)


def vi(lam, phi, z=0.0):
    return 0.05 * np.sin(np.deg2rad(lam) * 3)


def ci(lam, phi, z=0.0):
    return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0) + z / 1000.0


def wind(lam, phi):
    taux = -1e-4 * np.cos(np.deg2rad(phi) * 3.0) * np.cos(np.deg2rad(phi))
    return taux, np.zeros_like(taux)


def etai(lam, phi):
    return 0.01 * np.cos(np.deg2rad(lam) * 2) * np.cos(np.deg2rad(phi) * 3)


SINGLE = {
    "plain": {},
    "closures": dict(nu_h=5e3, kappa_h=1e2, nu4_h=1e11, kappa4_h=1e10),
    "drag_wind_coriolis": dict(bottom_drag=("quadratic", 2.5e-3), wind_stress=wind,
                               coriolis=True),
    "two_tracers": dict(tracers=("T", "S")),
}
TS = dict(tracers=("T", "S"), buoyancy="linear_eos")
LAYERED = {
    "linear_eos": dict(TS, coriolis=True),
    "buoyancy_tracer": dict(buoyancy=True),
    "explicit_mixing": dict(TS, nu_v=1e-2, kappa_v=1e-3),
    "implicit_mixing": dict(TS, nu_v=1e-2, kappa_v=1e-3,
                            vertical_time_discretization="implicit"),
    "closures_drag_wind": dict(TS, coriolis=True, nu_h=5e3, kappa_h=1e2,
                               bottom_drag=("quadratic", 2.5e-3), wind_stress=wind),
}


def build_single(dtype, kw):
    grid = osg.TripolarGrid.make((48, 32, 1), dtype=dtype, first_pole_longitude=LAM_P,
                                 north_poles_latitude=PHI_P)
    model = make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=12),
                       bottom_height=lambda l, p: np.where(bottom(l, p) > 0, 1.0, 0.0),
                       **kw)
    names = model.tracer_names
    c = ci if len(names) == 1 else {n: (lambda l, p, k=k: (k + 1) * ci(l, p))
                                    for k, n in enumerate(names)}
    return model, initial_state(model, u=ui, v=vi, c=c, eta=etai)


def build_layered(dtype, kw):
    grid = osg.TripolarGrid.make((48, 32, 4), dtype=dtype, z=(-1000.0, 0.0),
                                 first_pole_longitude=LAM_P, north_poles_latitude=PHI_P)
    model = make_layered_model(grid, free_surface=SplitExplicitFreeSurface(substeps=12),
                               bottom_height=bottom, **kw)
    names = model.tracer_names
    c = (ci if len(names) == 1 else
         {"T": lambda l, p, z: 10.0 + 5.0 * ci(l, p, z),
          "S": lambda l, p, z: 35.0 + 0.5 * ci(l, p, z)})
    b = (lambda l, p, z: 1e-3 * ci(l, p, z)) if model.has_b else None
    return model, layered_initial_state(model, u=ui, v=vi, c=c, b=b, eta=etai)


def _err(a, b, H_):
    Hy, Hx = H_
    a = np.asarray(a, np.float64)[..., Hy:-Hy, Hx:-Hx]
    b = np.asarray(b, np.float64)[..., Hy:-Hy, Hx:-Hx]
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-300)


def _single_tend(model, s):
    g = model.grid
    u = H._fill(g, s.u, FC, -1)
    v = H._fill(g, s.v, CF, -1)
    c = H._fill(g, s.c, CC, 1)
    return H.tendencies(model, u, v, c)


def _layered_tend(model, s):
    u = L._fill3(model, s.u, FC, -1)
    v = L._fill3(model, s.v, CF, -1)
    c = L._fill3(model, s.c, CC, 1)
    b = L._fill3(model, s.b, CC, 1)
    G = L.layered_tendencies(model, u, v, c, b)
    return G if model.has_b else G[:3]


def _pair(builder, kw):
    return builder(jnp.float32, dict(kw)), builder(jnp.float64, dict(kw))


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_layer_tendencies_band(name):
    (m32, s32), (m64, s64) = _pair(build_single, SINGLE[name])
    g = m64.grid
    for k, (a, b) in enumerate(zip(jax.jit(_single_tend)(m32, s32),
                                   jax.jit(_single_tend)(m64, s64))):
        err = _err(a, b, (g.Hy, g.Hx))
        assert err < TEND_BAND.get(name, TEND_BAND_DEFAULT), (name, k, err)


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_layer_step_band(name):
    (m32, s32), (m64, s64) = _pair(build_single, SINGLE[name])
    a = jax.jit(step)(m32, s32, 120.0)
    b = jax.jit(step)(m64, s64, 120.0)
    for f in ("u", "v", "c", "eta", "U", "V"):
        g = m64.grid_ext if f in ("eta", "U", "V") else m64.grid
        err = _err(getattr(a, f), getattr(b, f), (g.Hy, g.Hx))
        assert err < STEP_BAND, (name, f, err)


@pytest.mark.parametrize("name", list(LAYERED))
def test_layered_tendencies_band(name):
    (m32, s32), (m64, s64) = _pair(build_layered, LAYERED[name])
    g = m64.grid
    for k, (a, b) in enumerate(zip(jax.jit(_layered_tend)(m32, s32),
                                   jax.jit(_layered_tend)(m64, s64))):
        err = _err(a, b, (g.Hy, g.Hx))
        assert err < TEND_BAND.get(name, TEND_BAND_DEFAULT), (name, k, err)


@pytest.mark.parametrize("name", list(LAYERED))
def test_layered_step_band(name):
    (m32, s32), (m64, s64) = _pair(build_layered, LAYERED[name])
    a = jax.jit(layered_step)(m32, s32, 60.0)
    b = jax.jit(layered_step)(m64, s64, 60.0)
    fields = ("u", "v", "c", "eta", "U", "V") + (("b",) if m64.has_b else ())
    for f in fields:
        g = m64.grid_ext if f in ("eta", "U", "V") else m64.grid
        err = _err(getattr(a, f), getattr(b, f), (g.Hy, g.Hx))
        assert err < STEP_BAND, (name, f, err)
