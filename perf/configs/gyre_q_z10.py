"""Plain reference of ``gyre_q_z10``: the layered T/S gyre of
examples/wind_driven_ts_gyre.py (per-layer vector-invariant momentum with WENO-5
vorticity and Coriolis, continuity w and its advective transport, hydrostatic
pressure from a linear equation of state, explicit vertical and Laplacian horizontal
mixing, surface wind stress, quadratic bottom drag, flux-form WENO-5 / centered
tracers, quasi-AB2, split-explicit free surface with the depth-mean corrector),
written on perf/refcore.py and independent of the package under test."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import refcore as rc
from refcore import CC, CF, FC

# Limits on max|program - reference| / scale per field after the 20 compared steps,
# set between the program's largest reading over 12 seeds (float32) and the
# control's smallest over 3 (the reference in bfloat16), read on an H100 at this
# size (PERF.md, section 2): u 9.60e-5 / 0.559; v 9.53e-5 / 0.381; T 1.85e-6 /
# 3.32e-2; S 2.63e-5 / 0.359; eta 6.91e-5 / 0.224; U 3.23e-5 / 0.191; V 2.65e-5 /
# 0.182.
LIMITS = {"u": 5e-4, "v": 5e-4, "T": 1e-5, "S": 1.5e-4, "eta": 4e-4, "U": 2e-4, "V": 1.5e-4}

OMEGA = 7.292115e-5
ALPHA_T, BETA_S, T0, S0 = 1.67e-4, 7.80e-4, 0.0, 35.0
CD = 2.5e-3
NU_H, KAPPA_H, NU_V, KAPPA_V = 5e3, 1e2, 1e-3, 1e-5
TAU0 = 1e-4


def layers(nz, depth):
    """Stretched interfaces (each layer about 1.7 times the one above) and, surface
    first, the layer centers, thicknesses and center-to-center spacings."""
    frac = 1.7 ** np.arange(nz, dtype=np.float64)
    frac = frac / frac.sum()
    z_f = -depth + depth * np.concatenate([[0.0], np.cumsum(frac[::-1])])
    zf = z_f[::-1]
    dz = zf[:-1] - zf[1:]
    return 0.5 * (zf[:-1] + zf[1:]), dz, 0.5 * (dz[:-1] + dz[1:])


def bottom(lam_p, phi_p, depth):
    """The example's land: pole masks, Antarctica and a meridional barrier."""
    def f(lam, phi):
        barrier = (lam_p + 90.0) % 360.0
        dlon = np.minimum(np.abs(lam - barrier), 360.0 - np.abs(lam - barrier))
        land = (((np.abs(lam - lam_p) < 8) & (np.abs(phi_p - phi) < 8))
                | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 8) & (np.abs(phi_p - phi) < 8))
                | (phi < -78) | ((dlon < 10.0) & (phi > -70) & (phi < 70)))
        return np.where(land, 1.0, -depth)
    return f


def wind_x(lam, phi):
    return -TAU0 * np.cos(np.deg2rad(phi) * 3.0) * np.cos(np.deg2rad(phi))


class Reference:
    def __init__(self, cfg, init_fields, dtype):
        b, gr = cfg["build"], cfg["grid"]
        Nx, Ny, nz, H = b["nx"], b["ny"], b["nz"], gr["halo"]
        dtau, w = rc.averaging_weights(b["substeps"])
        He = max(len(w) + 1, H)
        self.Nx, self.Ny, self.nz, self.H, self.He, self.d = Nx, Ny, nz, H, He, He - H
        self.dtype = dtype
        coord = np.dtype(cfg["dtype"])
        depth = gr["depth"]
        ge = rc.tripolar_grid(Nx, Ny, He, gr["southernmost_latitude"],
                              gr["north_poles_latitude"], gr["first_pole_longitude"])
        g = {k: rc.crop(v, He, H) for k, v in ge.items()}
        bot = bottom(gr["first_pole_longitude"], gr["north_poles_latitude"], depth)
        ib = rc.masks_from_bottom(bot, g, Nx, Ny, H, -depth, 0.0, coord)
        ibe = rc.masks_from_bottom(bot, ge, Nx, Ny, He, -depth, 0.0, coord)
        zc, dz, dzc = layers(nz, depth)
        self.dz = dz

        # full-cell layers: wet where the layer center is above the bottom of a wet
        # column; faces wet where both neighbours are
        m_c = ((zc[:, None, None] > ib["bottom"][None]) & (ib["mask_c"][None] > 0)) * 1.0
        m_u = m_c * np.roll(m_c, 1, axis=-1)
        m_v = m_c * np.roll(m_c, 1, axis=-2)
        dz3 = dz[:, None, None]
        dzu, dzv = dz3 * m_u, dz3 * m_v
        below = lambda m: np.concatenate([m[1:], np.zeros_like(m[:1])])  # noqa: E731

        def stress(key):
            lam = g["lam_" + key].astype(coord).astype(np.float64)
            phi = g["phi_" + key].astype(coord).astype(np.float64)
            return wind_x(lam, phi)

        phi_ff = g["phi_ff"].astype(coord).astype(np.float64)
        base = dict(
            dx_fc=g["dx_fc"], dy_cf=g["dy_cf"], dx_cf=g["dx_cf"], dy_fc=g["dy_fc"],
            dx_cc=g["dx_cc"], dy_cc=g["dy_cc"], dx_ff=g["dx_ff"], dy_ff=g["dy_ff"],
            az_fc=g["az_fc"], az_cf=g["az_cf"], az_cc=g["az_cc"],
            inv_dx_fc=rc.inv(g["dx_fc"]), inv_dy_cf=rc.inv(g["dy_cf"]),
            inv_az_ff=rc.inv(g["az_ff"]), inv_az_cc=rc.inv(g["az_cc"]),
            f_ff=2.0 * OMEGA * np.sin(np.deg2rad(phi_ff)),
            taux=stress("fc") * ib["mask_u"],
            mask_c=m_c, mask_u=m_u, mask_v=m_v, dzu=dzu, dzv=dzv,
            bot_u=m_u * (1.0 - below(m_u)), bot_v=m_v * (1.0 - below(m_v)),
            inv_h_u=rc.inv(dzu.sum(0)), inv_h_v=rc.inv(dzv.sum(0)),
            inv_vol=m_c * rc.inv(g["az_cc"][None] * dz3),
            dz3=dz3, dzc3=dzc[:, None, None])
        ext = dict(
            dy_fc=ge["dy_fc"], dx_cf=ge["dx_cf"], inv_az_cc=rc.inv(ge["az_cc"]),
            inv_dx_fc=rc.inv(ge["dx_fc"]), inv_dy_cf=rc.inv(ge["dy_cf"]),
            mask_u=ibe["mask_u"], mask_v=ibe["mask_v"], gh_u=rc.G_EARTH * ibe["h_u"],
            gh_v=rc.G_EARTH * ibe["h_v"], weights=w)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
        self.P = {"base": cast(base), "ext": cast(ext), "dtau": dtau}
        self.wet = m_c[:, H:H + Ny, H:H + Nx] > 0

        def sample3(name, key, mask):
            return np.stack([rc.sample(init_fields[name], g, key, Nx, Ny, H, coord, z)
                             for z in zc]) * mask

        u0, v0 = sample3("u", "fc", m_u), sample3("v", "cf", m_v)
        T0_, S0_ = sample3("T", "cc", m_c), sample3("S", "cc", m_c)
        pad = lambda a: np.pad(a, self.d)  # noqa: E731
        zero3 = np.zeros_like(u0)
        self.state0 = cast(dict(
            u=u0, v=v0, T=T0_, S=S0_, eta=pad(np.zeros((Ny + 2 * H, Nx + 2 * H))),
            U=pad((u0 * dzu).sum(0)), V=pad((v0 * dzv).sum(0)),
            Gu=zero3, Gv=zero3, GT=zero3, GS=zero3))
        self.state0["iteration"] = jnp.zeros((), jnp.int32)
        self._step = jax.jit(self.step)

    def fill(self, a, loc, sign):
        return rc.fill(jnp, a, loc, sign, self.Nx, self.Ny, self.H, self.H)

    def fill_e(self, a, loc, sign):
        return rc.fill(jnp, a, loc, sign, self.Nx, self.Ny, self.He, self.He)

    @staticmethod
    def w_advect(wf, q, dzc3):
        """w dq/dz at layer centers from the interface velocities (zero at surface
        and floor), the mean of the layer's two interfaces."""
        contrib = wf[1:-1] * (q[:-1] - q[1:]) / dzc3
        zero = jnp.zeros_like(q[:1])
        return 0.5 * (jnp.concatenate([zero, contrib]) + jnp.concatenate([contrib, zero]))

    @staticmethod
    def vlap(q, dz3, dzc3, mask):
        """d/dz(d q/dz) with no flux through surface, floor or solid cells."""
        F = (q[:-1] - q[1:]) / dzc3 * (mask[:-1] * mask[1:])
        zero = jnp.zeros_like(q[:1])
        F = jnp.concatenate([zero, F, zero])
        return (F[:-1] - F[1:]) / dz3

    def tendencies(self, p, u, v, T, S):
        zeta = (rc.dxf(p["dy_cf"] * v) - rc.dyf(p["dx_fc"] * u)) * p["inv_az_ff"]
        q = zeta + p["f_ff"]
        v_hat = rc.ixf(rc.iyc(p["dx_cf"] * v)) * p["inv_dx_fc"]
        u_hat = rc.iyf(rc.ixc(p["dy_fc"] * u)) * p["inv_dy_cf"]
        ke = 0.5 * (rc.ixc(u * u) + rc.iyc(v * v))
        Gu = rc.weno_centers(q, v_hat, -2) * v_hat - rc.dxf(ke) * p["inv_dx_fc"]
        Gv = -rc.weno_centers(q, u_hat, -1) * u_hat - rc.dyf(ke) * p["inv_dy_cf"]

        # continuity: w at the layer tops, integrated up from the floor (w = 0 there)
        hdiv = (rc.dxc(p["dy_fc"] * p["dzu"] * u)
                + rc.dyc(p["dx_cf"] * p["dzv"] * v)) * p["inv_az_cc"]
        w = jnp.concatenate([-jax.lax.cumsum(hdiv, axis=0, reverse=True),
                             jnp.zeros_like(hdiv[:1])])
        Gu = Gu - self.w_advect(rc.ixf(w), u, p["dzc3"])
        Gv = Gv - self.w_advect(rc.iyf(w), v, p["dzc3"])

        # hydrostatic pressure of the linear-EOS buoyancy
        b = rc.G_EARTH * (ALPHA_T * (T - T0) - BETA_S * (S - S0)) * p["mask_c"]
        csum = jnp.cumsum(b * p["dz3"], axis=0)
        pres = -(csum - 0.5 * p["dz3"] * b)
        Gu = Gu - rc.dxf(pres) * p["inv_dx_fc"]
        Gv = Gv - rc.dyf(pres) * p["inv_dy_cf"]

        Gu = Gu + NU_V * self.vlap(u, p["dz3"], p["dzc3"], p["mask_u"])
        Gv = Gv + NU_V * self.vlap(v, p["dz3"], p["dzc3"], p["mask_v"])
        Gu = Gu.at[0].add(p["taux"] / float(self.dz[0]))
        sp_u = jnp.sqrt(u * u + rc.ixf(rc.iyc(v)) ** 2)
        sp_v = jnp.sqrt(v * v + rc.iyf(rc.ixc(u)) ** 2)
        Gu = Gu - (CD / p["dz3"]) * sp_u * u * p["bot_u"]
        Gv = Gv - (CD / p["dz3"]) * sp_v * v * p["bot_v"]
        Gu = Gu + NU_H * rc.laplacian_u(p, u, p["mask_u"], p["mask_c"])
        Gv = Gv + NU_H * rc.laplacian_v(p, v, p["mask_v"], p["mask_c"])
        Gu, Gv = Gu * p["mask_u"], Gv * p["mask_v"]

        def tracer(c):
            fx = u * p["dzu"] * p["dy_fc"] * rc.weno_faces(c, u, -1)
            fy = v * p["dzv"] * p["dx_cf"] * rc.weno_faces(c, v, -2)
            G = -(rc.dxc(fx) + rc.dyc(fy)) * p["inv_vol"]
            cbar = 0.5 * (c[:-1] + c[1:])
            zero = jnp.zeros_like(c[:1])
            F = jnp.concatenate([zero, w[1:-1] * cbar, zero])
            G = G - (F[:-1] - F[1:]) / p["dz3"] * p["mask_c"]
            G = G + KAPPA_V * self.vlap(c, p["dz3"], p["dzc3"], p["mask_c"]) * p["mask_c"]
            return G + KAPPA_H * rc.laplacian_c(p, c, p["mask_c"], p["mask_u"], p["mask_v"])

        return Gu, Gv, tracer(T), tracer(S)

    def step(self, P, S, dt):
        p, e = P["base"], P["ext"]
        dt = jnp.asarray(dt, self.dtype)
        G = self.tendencies(p, self.fill(S["u"], FC, -1), self.fill(S["v"], CF, -1),
                            self.fill(S["T"], CC, 1), self.fill(S["S"], CC, 1))
        first = S["iteration"] == 0
        w1 = jnp.where(first, 1.0, 1.5 + rc.CHI).astype(self.dtype)
        w2 = jnp.where(first, 0.0, 0.5 + rc.CHI).astype(self.dtype)
        Gu_s, Gv_s, GT_s, GS_s = (w1 * g - w2 * S[k] for g, k in
                                  zip(G, ("Gu", "Gv", "GT", "GS")))
        GU = self.fill_e(rc.pad_ext((Gu_s * p["dzu"]).sum(0), self.d), FC, -1)
        GV = self.fill_e(rc.pad_ext((Gv_s * p["dzv"]).sum(0), self.d), CF, -1)
        eta_a, U_a, V_a = rc.barotropic(
            e, self.fill_e(S["eta"], CC, 1), self.fill_e(S["U"], FC, -1),
            self.fill_e(S["V"], CF, -1), GU, GV, P["dtau"] * dt)
        # predictor, then the depth mean replaced by the barotropic average
        u_star = (S["u"] + dt * Gu_s) * p["mask_u"]
        v_star = (S["v"] + dt * Gv_s) * p["mask_v"]
        ubar = (u_star * p["dzu"]).sum(0) * p["inv_h_u"]
        vbar = (v_star * p["dzv"]).sum(0) * p["inv_h_v"]
        Ubar = rc.crop_ext(U_a, self.d) * p["inv_h_u"]
        Vbar = rc.crop_ext(V_a, self.d) * p["inv_h_v"]
        return dict(u=(u_star + (Ubar - ubar)[None]) * p["mask_u"],
                    v=(v_star + (Vbar - vbar)[None]) * p["mask_v"],
                    T=(S["T"] + dt * GT_s) * p["mask_c"], S=(S["S"] + dt * GS_s) * p["mask_c"],
                    eta=eta_a, U=U_a, V=V_a, Gu=G[0], Gv=G[1], GT=G[2], GS=G[3],
                    iteration=S["iteration"] + 1)

    def run(self, n_steps, dt):
        S = self.state0
        for _ in range(n_steps):
            S = self._step(self.P, S, dt)
        return S

    def fields(self, S):
        """The compared fields over the interior with their scales: the largest
        magnitude for velocities and the free surface, the range over wet cells for
        the tracers (whose means are far from zero)."""
        out = {}
        for name, arr in interior_fields(S, self.Ny, self.Nx, self.nz).items():
            if name in ("T", "S"):
                out[name] = (arr, float(np.ptp(arr[self.wet])))
            else:
                out[name] = (arr, float(np.max(np.abs(arr))))
        return out


def interior_fields(S, Ny, Nx, nz):
    """u, v, T, S, eta, U, V over the interior as float64 numpy, from the program's
    state (tracers stacked T then S in ``c``) or the reference's (keys T and S)."""
    if isinstance(S, dict):
        raw = {k: S[k] for k in ("u", "v", "T", "S", "eta", "U", "V")}
    else:
        c = np.asarray(S.c)
        raw = dict(u=S.u, v=S.v, T=c[:nz], S=c[nz:2 * nz], eta=S.eta, U=S.U, V=S.V)
    out = {}
    for name, a in raw.items():
        a = np.asarray(a, np.float64)
        hy, hx = (a.shape[-2] - Ny) // 2, (a.shape[-1] - Nx) // 2
        out[name] = a[..., hy:hy + Ny, hx:hx + Nx]
    return out


def program_fields(cfg, state):
    b = cfg["build"]
    return interior_fields(state, b["ny"], b["nx"], b["nz"])
