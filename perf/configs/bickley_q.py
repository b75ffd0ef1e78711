"""Plain reference of ``bickley_q``: the single-layer Bickley jet on the tripolar
grid (vector-invariant momentum with WENO-5 vorticity, flux-form WENO-5 tracer,
quasi-AB2, split-explicit free surface), written on perf/refcore.py and independent
of the package under test. It builds its own grid, masks and initial state from the
configuration and the seed."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import refcore as rc
from refcore import CC, CF, FC

# Limits on max|program - reference| / scale per field after the 20 compared steps,
# set between the program's largest reading over 12 seeds (float32) and the
# control's smallest over 3 (the reference in bfloat16), read on an H100 at this
# size for both the scan and the simulation loop (PERF.md, section 2):
#   u, U 1.64e-5 / 2.54e-2; v, V 1.67e-5 / 2.79e-2; c 1.21e-6 / 3.01e-3;
#   eta 5.91e-4 / 1.04 (the free surface is a small difference of large fluxes).
LIMITS = {"u": 1e-4, "v": 1e-4, "c": 1e-5, "eta": 3e-3, "U": 1e-4, "V": 1e-4}


def bottom(lam_p, phi_p):
    """The example's land: the two north singularities and Antarctica."""
    def f(lam, phi):
        land = (((np.abs(lam - lam_p) < 5) & (np.abs(phi_p - phi) < 5))
                | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 5) & (np.abs(phi_p - phi) < 5))
                | (phi < -78))
        return np.where(land, 1.0, 0.0)
    return f


class Reference:
    def __init__(self, cfg, init_fields, dtype):
        b, gr = cfg["build"], cfg["grid"]
        Nx, Ny, H = b["nx"], b["ny"], gr["halo"]
        dtau, w = rc.averaging_weights(b["substeps"])
        He = max(len(w) + 1, H)
        self.Nx, self.Ny, self.H, self.He, self.d = Nx, Ny, H, He, He - H
        self.dtype = dtype
        coord = np.dtype(cfg["dtype"])
        ge = rc.tripolar_grid(Nx, Ny, He, gr["southernmost_latitude"],
                              gr["north_poles_latitude"], gr["first_pole_longitude"])
        g = {k: rc.crop(v, He, H) for k, v in ge.items()}
        z0, z1 = gr["z"]
        bot = bottom(gr["first_pole_longitude"], gr["north_poles_latitude"])
        ib = rc.masks_from_bottom(bot, g, Nx, Ny, H, z0, z1, coord)
        ibe = rc.masks_from_bottom(bot, ge, Nx, Ny, He, z0, z1, coord)
        base = dict(
            dx_fc=g["dx_fc"], dy_cf=g["dy_cf"], dx_cf=g["dx_cf"], dy_fc=g["dy_fc"],
            inv_dx_fc=rc.inv(g["dx_fc"]), inv_dy_cf=rc.inv(g["dy_cf"]),
            inv_az_ff=rc.inv(g["az_ff"]),
            inv_vol_c=ib["mask_c"] * rc.inv(g["az_cc"] * ib["h_c"]),
            h_u=ib["h_u"], h_v=ib["h_v"], mask_u=ib["mask_u"], mask_v=ib["mask_v"],
            mask_c=ib["mask_c"], inv_h_u=rc.inv(ib["h_u"]), inv_h_v=rc.inv(ib["h_v"]))
        ext = dict(
            dy_fc=ge["dy_fc"], dx_cf=ge["dx_cf"], inv_az_cc=rc.inv(ge["az_cc"]),
            inv_dx_fc=rc.inv(ge["dx_fc"]), inv_dy_cf=rc.inv(ge["dy_cf"]),
            mask_u=ibe["mask_u"], mask_v=ibe["mask_v"], gh_u=rc.G_EARTH * ibe["h_u"],
            gh_v=rc.G_EARTH * ibe["h_v"], weights=w)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
        self.P = {"base": cast(base), "ext": cast(ext), "dtau": dtau}

        u0 = rc.sample(init_fields["u"], g, "fc", Nx, Ny, H, coord) * ib["mask_u"]
        v0 = rc.sample(init_fields["v"], g, "cf", Nx, Ny, H, coord) * ib["mask_v"]
        c0 = rc.sample(init_fields["c"], g, "cc", Nx, Ny, H, coord) * ib["mask_c"]
        pad = lambda a: np.pad(a, self.d)  # noqa: E731
        zero = np.zeros_like(u0)
        self.state0 = cast(dict(u=u0, v=v0, c=c0, eta=pad(zero), U=pad(ib["h_u"] * u0),
                                V=pad(ib["h_v"] * v0), Gu=zero, Gv=zero, Gc=zero))
        self.state0["iteration"] = jnp.zeros((), jnp.int32)
        self._step = jax.jit(self.step)

    def fill(self, a, loc, sign):
        return rc.fill(jnp, a, loc, sign, self.Nx, self.Ny, self.H, self.H)

    def fill_e(self, a, loc, sign):
        return rc.fill(jnp, a, loc, sign, self.Nx, self.Ny, self.He, self.He)

    def tendencies(self, p, u, v, c):
        zeta = (rc.dxf(p["dy_cf"] * v) - rc.dyf(p["dx_fc"] * u)) * p["inv_az_ff"]
        v_hat = rc.ixf(rc.iyc(p["dx_cf"] * v)) * p["inv_dx_fc"]
        u_hat = rc.iyf(rc.ixc(p["dy_fc"] * u)) * p["inv_dy_cf"]
        ke = 0.5 * (rc.ixc(u * u) + rc.iyc(v * v))
        Gu = (rc.weno_centers(zeta, v_hat, -2) * v_hat - rc.dxf(ke) * p["inv_dx_fc"]) * p["mask_u"]
        Gv = (-rc.weno_centers(zeta, u_hat, -1) * u_hat - rc.dyf(ke) * p["inv_dy_cf"]) * p["mask_v"]
        fx = u * p["h_u"] * p["dy_fc"] * rc.weno_faces(c, u, -1)
        fy = v * p["h_v"] * p["dx_cf"] * rc.weno_faces(c, v, -2)
        Gc = -(rc.dxc(fx) + rc.dyc(fy)) * p["inv_vol_c"]
        return Gu, Gv, Gc

    def step(self, P, S, dt):
        p, e = P["base"], P["ext"]
        dt = jnp.asarray(dt, self.dtype)
        Gu, Gv, Gc = self.tendencies(p, self.fill(S["u"], FC, -1), self.fill(S["v"], CF, -1),
                                     self.fill(S["c"], CC, 1))
        first = S["iteration"] == 0
        w1 = jnp.where(first, 1.0, 1.5 + rc.CHI).astype(self.dtype)
        w2 = jnp.where(first, 0.0, 0.5 + rc.CHI).astype(self.dtype)
        Gu_s, Gv_s, Gc_s = (w1 * Gu - w2 * S["Gu"], w1 * Gv - w2 * S["Gv"],
                            w1 * Gc - w2 * S["Gc"])
        GU = self.fill_e(rc.pad_ext(p["h_u"] * Gu_s, self.d), FC, -1)
        GV = self.fill_e(rc.pad_ext(p["h_v"] * Gv_s, self.d), CF, -1)
        eta_a, U_a, V_a = rc.barotropic(
            e, self.fill_e(S["eta"], CC, 1), self.fill_e(S["U"], FC, -1),
            self.fill_e(S["V"], CF, -1), GU, GV, P["dtau"] * dt)
        return dict(u=rc.crop_ext(U_a, self.d) * p["inv_h_u"] * p["mask_u"],
                    v=rc.crop_ext(V_a, self.d) * p["inv_h_v"] * p["mask_v"],
                    c=(S["c"] + dt * Gc_s) * p["mask_c"], eta=eta_a, U=U_a, V=V_a,
                    Gu=Gu, Gv=Gv, Gc=Gc, iteration=S["iteration"] + 1)

    def run(self, n_steps, dt):
        S = self.state0
        for _ in range(n_steps):
            S = self._step(self.P, S, dt)
        return S

    def fields(self, S):
        """The compared fields over the interior, each with its scale (the largest
        magnitude of the reference field)."""
        out = {}
        for name, arr in interior_fields(S, self.Ny, self.Nx).items():
            out[name] = (arr, float(np.max(np.abs(arr))))
        return out


def interior_fields(S, Ny, Nx):
    """u, v, c, eta, U, V over the interior, as float64 numpy, from a state with those
    attributes or keys (the program's or the reference's)."""
    get = (lambda k: S[k]) if isinstance(S, dict) else (lambda k: getattr(S, k))  # noqa: E731
    out = {}
    for name in ("u", "v", "c", "eta", "U", "V"):
        a = np.asarray(get(name), np.float64)
        hy, hx = (a.shape[-2] - Ny) // 2, (a.shape[-1] - Nx) // 2
        out[name] = a[..., hy:hy + Ny, hx:hx + Nx]
    return out


def program_fields(cfg, state):
    b = cfg["build"]
    return interior_fields(state, b["ny"], b["nx"])
