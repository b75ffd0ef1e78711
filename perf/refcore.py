"""Plain reference of the tripolar-grid ocean formulation: the yardstick that decides
``correct``.

It is written from the published formulation (Murray 1996 tripolar mapping, the
zipper fold of OrthogonalSphericalShellGrids.jl, Arakawa C-grid finite volumes,
WENO-5 with Z-weights, Shchepetkin & McWilliams 2005 split-explicit averaging) and
imports nothing of the package under test. The grid is generated here in float64
numpy; the time step is plain ``jax.numpy`` in whatever dtype the caller asks for
(float64 for the reference, a lower precision for the control).

Conventions (those of the system under test, which the comparison holds it to):
arrays are halo-inclusive ``(..., y, x)``; the 1-based index m of the reference's
offset arrays sits at 0-based ``m + H - 1``; a face value ``f[i]`` sits between
centers ``i - 1`` and ``i``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

R_EARTH = 6371.0e3
G_EARTH = 9.80665
CHI = 0.1            # quasi-Adams-Bashforth-2 parameter
WENO_EPS = 1e-8      # WENO smoothness regulariser

CC, FC, CF, FF = ("c", "c"), ("f", "c"), ("c", "f"), ("f", "f")


# ------------------------------------------------------------------------------------
# Halo fill: south zero-gradient (optional), north zipper fold, periodic x
# ------------------------------------------------------------------------------------

def fold_indices(loc, sign, Nx, Ny, Hx, Hy):
    """(dest_rows, dest_cols, src_rows, src_cols, signs) of the zipper fold, from the
    fold kernels' index formulas in 1-based indices: a center-x field mirrors column
    i to Nx - i + 1, a face-x field to Nx - i + 2 (wrapped, the wrap point taking
    |sign|); a center-y field fills halo row Ny + j from row Ny - j and rewrites the
    half i > Nx / 2 of row Ny, a face-y field fills row Ny + j from row Ny - j + 1."""
    face_x, face_y = loc[0] == "f", loc[1] == "f"
    i = np.arange(1, Nx + 1)
    if face_x:
        ip = Nx - i + 2
        ip = np.where(ip > Nx, ip - Nx, ip)
        s = np.where(i == 1, abs(sign), sign)
    else:
        ip = Nx - i + 1
        s = np.full(Nx, sign)
    dr, dc, sr, sc, ss = [], [], [], [], []
    for j in range(1, Hy + 1):
        src = Ny - j + 1 if face_y else Ny - j
        dr.append(np.full(Nx, Ny + j + Hy - 1))
        dc.append(i + Hx - 1)
        sr.append(np.full(Nx, src + Hy - 1))
        sc.append(ip + Hx - 1)
        ss.append(s)
    if not face_y:
        half = i > Nx // 2
        dr.append(np.full(half.sum(), Ny + Hy - 1))
        dc.append(i[half] + Hx - 1)
        sr.append(np.full(half.sum(), Ny + Hy - 1))
        sc.append(ip[half] + Hx - 1)
        ss.append(s[half])
    cat = np.concatenate
    return cat(dr), cat(dc), cat(sr), cat(sc), cat(ss).astype(np.float64)


def fill(xp, A, loc, sign, Nx, Ny, Hx, Hy, south=True):
    """Halo fill of ``A`` (numpy or jax.numpy via ``xp``): the south halo copies the
    first interior row, the fold reads the values before it writes, then x wraps."""
    if south:
        first = A[..., Hy:Hy + 1, :]
        A = _put(xp, A, (Ellipsis, slice(0, Hy), slice(None)),
                 xp.broadcast_to(first, A.shape[:-2] + (Hy, A.shape[-1])))
    dr, dc, sr, sc, ss = fold_indices(loc, sign, Nx, Ny, Hx, Hy)
    vals = A[..., sr, sc] * ss.astype(A.dtype)
    A = _put(xp, A, (Ellipsis, dr, dc), vals)
    A = _put(xp, A, (Ellipsis, slice(None), slice(0, Hx)), A[..., :, Nx:Nx + Hx])
    return _put(xp, A, (Ellipsis, slice(None), slice(Hx + Nx, 2 * Hx + Nx)),
                A[..., :, Hx:2 * Hx])


def _put(xp, A, idx, vals):
    if xp is np:
        A = np.array(A, copy=True)
        A[idx] = vals
        return A
    return A.at[idx].set(vals)


# ------------------------------------------------------------------------------------
# Grid generation (float64, host)
# ------------------------------------------------------------------------------------

def sind(x):
    """sin of degrees, exact at multiples of 90 degrees, with the sign of zero
    following the argument (the fold's atan(y / x) branch depends on it)."""
    x = np.asarray(x, np.float64)
    r = np.mod(x, 360.0)
    out = np.sin(np.radians(r))
    out = np.where(np.mod(r, 180.0) == 0.0, np.copysign(0.0, x), out)
    out = np.where(r == 90.0, 1.0, out)
    return np.where(r == 270.0, -1.0, out)


def cosd(x):
    return sind(np.asarray(x, np.float64) + 90.0)


def tand(x):
    return sind(x) / cosd(x)


def murray(lam1, phi1, focal, first_pole_longitude):
    """Murray (1996) cofocal mapping of a (phi1 x lam1) lattice; degrees out."""
    lam = np.asarray(lam1, np.float64)[None, :]
    phi = np.asarray(phi1, np.float64)[:, None]
    psi = np.arcsinh(tand((90.0 - phi) / 2.0) / focal)
    x = focal * sind(lam) * np.cosh(psi)
    y = focal * cosd(lam) * np.sinh(psi)
    with np.errstate(divide="ignore", invalid="ignore"):
        lam2 = -(180.0 / math.pi) * np.arctan(y / x)
    pole = (x == 0.0) & (y == 0.0)
    lam2 = np.where(pole, np.where(lam == -180.0, -90.0, 90.0), lam2)
    phi2 = 90.0 - (360.0 / math.pi) * np.arctan(np.sqrt(x * x + y * y))
    lam2 = lam2 + np.where(lam < 0.0, -90.0, 90.0) + first_pole_longitude + 90.0
    return ((lam2 % 360) + 360) % 360, phi2


def haversine(lon1, lat1, lon2, lat2, radius):
    dlat = np.radians(lat2 - lat1)
    dlon = np.radians(lon2 - lon1)
    a = (np.sin(dlat / 2) ** 2
         + np.cos(np.radians(lat1)) * np.cos(np.radians(lat2)) * np.sin(dlon / 2) ** 2)
    return 2 * radius * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def _cart(lat, lon):
    la, lo = np.radians(lat), np.radians(lon)
    return np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)


def _triangle(a, b, c):
    """Solid angle of a unit-sphere triangle (van Oosterom & Strackee 1983)."""
    cross = (b[1] * c[2] - b[2] * c[1], b[2] * c[0] - b[0] * c[2],
             b[0] * c[1] - b[1] * c[0])
    num = np.abs(sum(a[k] * cross[k] for k in range(3)))
    dot = lambda p, q: sum(p[k] * q[k] for k in range(3))  # noqa: E731
    return 2.0 * np.arctan2(num, 1.0 + dot(a, b) + dot(b, c) + dot(a, c))


def _quad(a, b, c, d):
    return _triangle(a, b, c) + _triangle(a, c, d)


def tripolar_grid(Nx, Ny, H, southernmost_latitude=-80.0, north_poles_latitude=55.0,
                  first_pole_longitude=70.0, radius=R_EARTH):
    """Coordinates and metrics of the tripolar grid with halo H on both axes, as
    float64 arrays of shape (Ny + 2H, Nx + 2H), keyed ``lam_cc``, ``dx_fc``, ..."""
    focal = tand((90.0 - north_poles_latitude) / 2.0)
    dlam = 360.0 / Nx
    lamF = -180.0 + dlam * np.arange(Nx)
    lamC = lamF + dlam / 2.0
    phiC = np.linspace(southernmost_latitude, 90.0, Ny)
    phiF = phiC - (phiC[1] - phiC[0]) / 2.0
    lamF, lamC = np.roll(lamF, Nx // 4), np.roll(lamC, Nx // 4)

    def embed(a):
        out = np.zeros((Ny + 2 * H, Nx + 2 * H))
        out[H:H + Ny, H:H + Nx] = a
        return out

    locs = {"ff": FF, "fc": FC, "cf": CF, "cc": CC}
    g = {}
    for key, (l1, p1) in {"ff": (lamF, phiF), "fc": (lamF, phiC),
                          "cf": (lamC, phiF), "cc": (lamC, phiC)}.items():
        lam, phi = murray(l1, p1, focal, first_pole_longitude)
        g["lam_" + key] = fill(np, embed(lam), locs[key], 1, Nx, Ny, H, H, south=False)
        g["phi_" + key] = fill(np, embed(phi), locs[key], 1, Nx, Ny, H, H, south=False)

    J, Jp, Jm = slice(H, H + Ny), slice(H + 1, H + Ny + 1), slice(H - 1, H + Ny - 1)
    I, Ip, Im = slice(H, H + Nx), slice(H + 1, H + Nx + 1), slice(H - 1, H + Nx - 1)

    def hav(key, ja, ia, jb, ib):
        lam, phi = g["lam_" + key], g["phi_" + key]
        return haversine(lam[ja, ia], phi[ja, ia], lam[jb, ib], phi[jb, ib], radius)

    def node(key, ja, ia):
        return _cart(g["phi_" + key][ja, ia], g["lam_" + key][ja, ia])

    m = {
        "dx_cc": hav("fc", J, Ip, J, I), "dx_fc": hav("cc", J, I, J, Im),
        "dx_cf": hav("ff", J, Ip, J, I), "dx_ff": hav("cf", J, I, J, Im),
        "dy_cc": hav("cf", Jp, I, J, I), "dy_fc": hav("ff", Jp, I, J, I),
        "dy_cf": hav("cc", J, I, Jm, I), "dy_ff": hav("fc", J, I, Jm, I),
        "az_cc": _quad(node("ff", J, I), node("ff", J, Ip), node("ff", Jp, Ip),
                       node("ff", Jp, I)) * radius ** 2,
        "az_ff": _quad(node("cc", Jm, Im), node("cc", Jm, I), node("cc", J, I),
                       node("cc", J, Im)) * radius ** 2,
    }
    m["az_fc"] = m["dy_fc"] * m["dx_fc"]
    m["az_cf"] = m["dy_cf"] * m["dx_cf"]
    for key in list(m):
        m[key] = fill(np, embed(m[key]), locs[key[-2:]], 1, Nx, Ny, H, H, south=False)

    # south halo rows and interior row 1: the metrics of a uniform latitude-longitude
    # grid of Ny cells over (southernmost_latitude, 90)
    j = np.arange(1 - H, 2)
    dphi = (90.0 - southernmost_latitude) / Ny
    phi_face = southernmost_latitude + (j - 1) * dphi
    phi_cent = southernmost_latitude + (j - 0.5) * dphi
    rl = radius * math.radians(dlam)
    dx_c, dx_f = rl * cosd(phi_cent), rl * cosd(phi_face)
    az_c = radius * rl * (sind(phi_face + dphi) - sind(phi_face))
    az_f = radius * rl * (sind(phi_cent) - sind(phi_cent - dphi))
    cont = {"dx_cc": dx_c, "dx_fc": dx_c, "dx_cf": dx_f, "dx_ff": dx_f,
            "az_cc": az_c, "az_fc": az_c, "az_cf": az_f, "az_ff": az_f}
    for key in m:
        if key.startswith("dy"):
            m[key][:H + 1, :] = radius * math.radians(dphi)
        else:
            m[key][:H + 1, :] = cont[key][:, None]
    g.update(m)
    return g


def crop(a, H, h):
    """The halo-h view of a halo-H array (h <= H)."""
    d = H - h
    return a[..., d:a.shape[-2] - d, d:a.shape[-1] - d]


def averaging_weights(substeps, p=2.0, q=4.0, r=0.18927):
    """Fractional substep and normalised Shchepetkin & McWilliams (2005) weights,
    truncated after the last positive value."""
    dtau = 2.0 / substeps
    tau0 = (p + 2) * (p + q + 2) / ((p + 1) * (p + q + 1))
    x = dtau * np.arange(1, substeps + 1) / tau0
    w = x ** p * (1 - x ** q) - r * x
    w = np.clip(w[:np.nonzero(w > 0)[0][-1] + 1], 0.0, None)
    return dtau, w / w.sum()


def masks_from_bottom(bottom_fn, g, Nx, Ny, H, z_bottom, z_top, coord_dtype):
    """Grid-fitted bottom: column depth and fluid masks at centers and faces. The
    bottom height is evaluated at the cell centers as the grid stores them (in
    ``coord_dtype``), filled across the fold, south zero-gradient."""
    lam = g["lam_cc"][H:H + Ny, H:H + Nx].astype(coord_dtype).astype(np.float64)
    phi = g["phi_cc"][H:H + Ny, H:H + Nx].astype(coord_dtype).astype(np.float64)
    bot = np.full((Ny + 2 * H, Nx + 2 * H), z_top)
    bot[H:H + Ny, H:H + Nx] = np.broadcast_to(bottom_fn(lam, phi), (Ny, Nx))
    bot = fill(np, bot, CC, 1, Nx, Ny, H, H)
    h_c = np.clip(z_top - np.maximum(bot, z_bottom), 0.0, None)
    h_u = np.minimum(h_c, np.roll(h_c, 1, axis=-1))
    h_v = np.minimum(h_c, np.roll(h_c, 1, axis=-2))
    return dict(bottom=bot, h_c=h_c, h_u=h_u, h_v=h_v, mask_c=(h_c > 0) * 1.0,
                mask_u=(h_u > 0) * 1.0, mask_v=(h_v > 0) * 1.0)


def inv(a):
    a = np.asarray(a, np.float64)
    return np.where(a > 0, 1.0 / np.where(a > 0, a, 1.0), 0.0)


def sample(fn, g, key, Nx, Ny, H, coord_dtype, *extra):
    """A field initialiser evaluated at the stored coordinates of location ``key``,
    zero in the halo."""
    lam = g["lam_" + key].astype(coord_dtype).astype(np.float64)
    phi = g["phi_" + key].astype(coord_dtype).astype(np.float64)
    out = np.zeros((Ny + 2 * H, Nx + 2 * H))
    full = np.broadcast_to(np.asarray(fn(lam, phi, *extra), np.float64), out.shape)
    out[H:H + Ny, H:H + Nx] = full[H:H + Ny, H:H + Nx]
    return out


# ------------------------------------------------------------------------------------
# Stencils (jax.numpy; shape preserving, wrapping at the array edge inside the halo)
# ------------------------------------------------------------------------------------

def sp(a, axis):
    """a[k + 1]."""
    return jnp.roll(a, -1, axis=axis)


def sm(a, axis):
    """a[k - 1]."""
    return jnp.roll(a, 1, axis=axis)


def dxc(f):
    return sp(f, -1) - f


def dxf(c):
    return c - sm(c, -1)


def dyc(f):
    return sp(f, -2) - f


def dyf(c):
    return c - sm(c, -2)


def ixc(f):
    return 0.5 * (f + sp(f, -1))


def ixf(c):
    return 0.5 * (c + sm(c, -1))


def iyc(f):
    return 0.5 * (f + sp(f, -2))


def iyf(c):
    return 0.5 * (c + sm(c, -2))


def weno5(m3, m2, m1, p0, p1):
    """WENO-5 (Z weights) value at the interface, biased from the m side."""
    q0 = (2.0 * m3 - 7.0 * m2 + 11.0 * m1) / 6.0
    q1 = (-m2 + 5.0 * m1 + 2.0 * p0) / 6.0
    q2 = (2.0 * m1 + 5.0 * p0 - p1) / 6.0
    b0 = (13.0 / 12.0) * (m3 - 2.0 * m2 + m1) ** 2 + 0.25 * (m3 - 4.0 * m2 + 3.0 * m1) ** 2
    b1 = (13.0 / 12.0) * (m2 - 2.0 * m1 + p0) ** 2 + 0.25 * (m2 - p0) ** 2
    b2 = (13.0 / 12.0) * (m1 - 2.0 * p0 + p1) ** 2 + 0.25 * (3.0 * m1 - 4.0 * p0 + p1) ** 2
    tau = jnp.abs(b0 - b2)
    a0 = 0.1 * (1.0 + (tau / (b0 + WENO_EPS)) ** 2)
    a1 = 0.6 * (1.0 + (tau / (b1 + WENO_EPS)) ** 2)
    a2 = 0.3 * (1.0 + (tau / (b2 + WENO_EPS)) ** 2)
    return (a0 * q0 + a1 * q1 + a2 * q2) / (a0 + a1 + a2)


def weno_faces(c, vel, axis):
    """Upwind WENO-5 value of a center field at faces (face k between centers k - 1
    and k): both biased reconstructions, then the one upwind of ``vel``."""
    cm1 = sm(c, axis)
    cm2 = sm(cm1, axis)
    cp1 = sp(c, axis)
    left = weno5(sm(cm2, axis), cm2, cm1, c, cp1)
    right = weno5(sp(cp1, axis), cp1, c, cm1, cm2)
    return jnp.where(vel > 0.0, left, right)


def weno_centers(f, vel, axis):
    """Upwind WENO-5 value of a face field at centers (center k at face index
    k + 1), upwinded by the center velocity ``vel``."""
    return sp(weno_faces(f, sm(vel, axis), axis), axis)


def ratio(num, den):
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)


def laplacian_u(g, u, mask_u, mask_c):
    gx = dxc(u) * ratio(g["dy_cc"], g["dx_cc"]) * mask_c
    gy = dyf(u) * ratio(g["dx_ff"], g["dy_ff"]) * (mask_u * sm(mask_u, -2))
    return (dxf(gx) + dyc(gy)) * ratio(1.0, g["az_fc"]) * mask_u


def laplacian_v(g, v, mask_v, mask_c):
    gx = dxf(v) * ratio(g["dy_ff"], g["dx_ff"]) * (mask_v * sm(mask_v, -1))
    gy = dyc(v) * ratio(g["dx_cc"], g["dy_cc"]) * mask_c
    return (dxc(gx) + dyf(gy)) * ratio(1.0, g["az_cf"]) * mask_v


def laplacian_c(g, c, mask_c, mask_u, mask_v):
    gx = dxf(c) * ratio(g["dy_fc"], g["dx_fc"]) * mask_u
    gy = dyf(c) * ratio(g["dx_cf"], g["dy_cf"]) * mask_v
    return (dxc(gx) + dyc(gy)) * ratio(1.0, g["az_cc"]) * mask_c


def barotropic(e, eta, U, V, GU, GV, dtau):
    """Forward-backward substeps of (eta, U, V) on the widened grid, averaged with
    the weights. ``e`` holds the widened grid's statics; no halo update inside the
    loop (validity shrinks one cell per substep into the widened halo)."""
    eta_a, U_a, V_a = jnp.zeros_like(eta), jnp.zeros_like(U), jnp.zeros_like(V)
    for k in range(e["weights"].shape[0]):
        w = e["weights"][k]
        div = (dxc(e["dy_fc"] * U) + dyc(e["dx_cf"] * V)) * e["inv_az_cc"]
        eta = eta - dtau * div
        U = (U - dtau * (e["gh_u"] * dxf(eta) * e["inv_dx_fc"] - GU)) * e["mask_u"]
        V = (V - dtau * (e["gh_v"] * dyf(eta) * e["inv_dy_cf"] - GV)) * e["mask_v"]
        eta_a, U_a, V_a = eta_a + w * eta, U_a + w * U, V_a + w * V
    return eta_a, U_a, V_a


def pad_ext(a, d):
    return jnp.pad(a, ((d, d), (d, d)))


def crop_ext(a, d):
    return a[..., d:a.shape[-2] - d, d:a.shape[-1] - d]
