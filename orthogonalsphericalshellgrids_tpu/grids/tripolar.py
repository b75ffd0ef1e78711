"""Tripolar grid construction (Murray 1996 cofocal ellipse/hyperbola mapping).

JAX reimplementation of the reference's core product: the ``TripolarGrid``
constructor (``src/tripolar_grid.jl:59-333``) and the coordinate kernel
(``src/generate_tripolar_coordinates.jl:53-89``). The construction pipeline mirrors the
reference call stack (SURVEY.md §3.1):

1. 1-D coordinates: uniform λ faces/centers; φ centers from southernmost_latitude to
   90° (the north pole is a *center* point, hence the RightConnected y-topology).
2. Murray closed-form mapping at all 4 staggered locations (FF, FC, CF, CC).
3. circshift by Nλ÷4 so pole 1 sits at i=1 and pole 2 at i=Nλ/2+1.
4. Halo fill of the coordinates through the zipper(+1)/periodic path.
5. Metric terms: Δx/Δy haversine arc lengths, Az spherical quadrilateral areas
   (``src/tripolar_grid_utils.jl:4-45``), followed by the same halo fill.
6. South continuation of the metrics with closed-form LatitudeLongitudeGrid values
   (``src/tripolar_grid.jl:277-300``).

Generation runs host-side in float64 numpy (the reference also generates on CPU,
``src/tripolar_grid.jl:68-71``) and ships dtype-converted arrays to the device —
mirroring the reference's single ``on_architecture`` transfer at
``src/tripolar_grid.jl:304-330``. The resulting ``TripolarGrid`` is a frozen pytree of
JAX arrays resident in HBM; all sizes/halos are static metadata so everything downstream
jit-compiles with static shapes.

Known deliberate deviation: the reference's ``continue_south!`` loops
(``src/tripolar_grid.jl:336-369``) have an index-range quirk (the offset-derived loop
bounds overwrite interior row 1 for columns i <= Nx-Hx and skip the easternmost columns
of the halo). Here the continuation overwrites exactly the south-halo rows (j < 1) for
all columns — the sane semantics. The affected rows sit on land below the southernmost
latitude in every reference workload, so no physics is altered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from ..ops import zipper
from ..ops.location import CC, CF, FC, FF
from . import geometry as geo
from .latlon import latlon_metrics_1d

__all__ = ["TripolarGrid", "build_tripolar_arrays", "with_halo"]


# --------------------------------------------------------------------------------------
# Degree-exact trigonometry (Julia's sind/cosd/tand are exact at multiples of 90°;
# the Murray mapping's north-pole special case at src/generate_tripolar_coordinates.jl:70-77
# relies on x and y being *exactly* zero there).
# --------------------------------------------------------------------------------------

def _sind(x):
    x = np.asarray(x, dtype=np.float64)
    r = np.mod(x, 360.0)
    out = np.sin(np.radians(r))
    # Exact signed zeros at multiples of 180°, matching Julia's sinpi convention
    # (sind(-180.0) == -0.0): the sign of the zero decides the atan(y/x) branch on the
    # λ = ±180 meridian — get it wrong and the whole column lands 180° off.
    out = np.where(np.mod(r, 180.0) == 0.0, np.copysign(0.0, x), out)
    out = np.where(r == 90.0, 1.0, out)
    out = np.where(r == 270.0, -1.0, out)
    return out


def _cosd(x):
    return _sind(np.asarray(x, dtype=np.float64) + 90.0)


def _tand(x):
    return _sind(x) / _cosd(x)


# --------------------------------------------------------------------------------------
# Murray (1996) mapping
# --------------------------------------------------------------------------------------

def _murray_mapping(lam1d, phi1d, Nx, focal_distance, first_pole_longitude):
    """Closed-form Murray mapping at one staggered location.

    Port of the per-point math in ``_compute_tripolar_coordinates!``
    (``src/generate_tripolar_coordinates.jl:53-89``), vectorized over the (Ny, Nx)
    index space with layout [j, i]. Returns (λ2D, φ2D) in degrees.
    """
    lam = np.asarray(lam1d, dtype=np.float64)[None, :]  # (1, Nx)
    phi = np.asarray(phi1d, dtype=np.float64)[:, None]  # (Ny, 1)
    a = focal_distance

    psi = np.arcsinh(_tand((90.0 - phi) / 2.0) / a)
    x = a * _sind(lam) * np.cosh(psi)
    y = a * _cosd(lam) * np.sinh(psi)

    with np.errstate(divide="ignore", invalid="ignore"):
        lam2 = -(180.0 / math.pi) * np.arctan(y / x)

    # Exactly at the north pole (x == 0 == y) the longitude is undefined; pick the
    # value continuous with the surrounding points (i==1 -> -90, else 90; reference
    # lines :74-77, 1-based i). The index tests are expressed on the 1-D longitude
    # instead (i==0 <=> lam==-180, i<Nx/2 <=> lam<0 for the canonical [-180,180)
    # input) so that a circshifted 1-D input yields the circshifted output directly
    # — the caller folds the reference's 8 full-array circshifts (:119-130) into a
    # free 1-D roll.
    on_pole = (x == 0.0) & (y == 0.0)
    lam2 = np.where(on_pole, np.where(lam == -180.0, -90.0, 90.0), lam2)

    phi2 = 90.0 - (360.0 / math.pi) * np.arctan(np.sqrt(x * x + y * y))

    # Hemisphere shift (:82, Julia i <= Nλ÷2 is 1-based), pole-longitude shift (:86),
    # wrap to [0, 360) (:87).
    lam2 = lam2 + np.where(lam < 0.0, -90.0, 90.0)
    lam2 = lam2 + first_pole_longitude + 90.0
    lam2 = geo.convert_to_0_360(lam2)
    return lam2, phi2


def newton_phi_nodes(southernmost_latitude, Ny, spacing, tol=1e-12, max_iter=50):
    """Jitted Newton shooting solve for a prescribed latitude-spacing law.

    The reference snapshot places the cofocal-ellipse family at uniformly spaced
    latitudes (``src/tripolar_grid.jl:95-97``) — the *explicit* Murray (1996)
    construction, which needs no iteration by design (docs/grids.md discusses why).
    Production tripolar meshes (the ORCA family) instead prescribe a variable
    resolution law Δφ ∝ f(φ) (e.g. equatorial refinement); placing Ny rows between
    ``southernmost_latitude`` and 90 under such a law is a two-point problem: march
    ``φ_{j+1} = φ_j + s·f(φ_j + s·f(φ_j)/2)`` (midpoint rule) and find the scale
    ``s`` that lands φ_{Ny-1} = 90 exactly. That scalar root is found here by Newton
    iteration with the derivative dφ_end/ds computed by jax.grad *through the scan*
    — the whole solve is one jitted function.

    ``spacing``: positive callable f(φ° in [-90, 90]) -> relative spacing weight
    (jnp-traceable). Returns float64 numpy centers, phi[0] = southernmost, phi[-1] = 90.
    """
    import jax
    import jax.numpy as jnp

    lo, hi = float(southernmost_latitude), 90.0

    with jax.enable_x64(True):  # grid gen is float64 regardless of session dtype
        def march(s):
            def body(phi, _):
                nxt = phi + s * spacing(phi + 0.5 * s * spacing(phi))
                return nxt, nxt
            return jax.lax.scan(body, jnp.asarray(lo, jnp.float64), None, length=Ny - 1)

        def g(s):
            return march(s)[0] - hi

        dg = jax.grad(g)

        @jax.jit
        def solve(s0):
            def cond(carry):
                s, it = carry
                return (jnp.abs(g(s)) > tol) & (it < max_iter)

            def body(carry):
                s, it = carry
                return s - g(s) / dg(s), it + 1

            s, _ = jax.lax.while_loop(cond, body, (s0, 0))
            return s, march(s)[1]

        # initial scale from the mean weight over the range (uniform-law exact)
        w = jnp.mean(jax.vmap(spacing)(jnp.linspace(lo, hi, 65, dtype=jnp.float64)))
        s, interior = solve(jnp.asarray((hi - lo) / ((Ny - 1) * w), jnp.float64))
        phis = np.concatenate([[lo], np.asarray(interior, dtype=np.float64)])

    # NaN-robust: a degenerate law yields NaN nodes, which must also land here
    if not (abs(phis[-1] - hi) <= 1e-8 and np.all(np.diff(phis) > 0)):
        raise ValueError(
            "phi_spacing Newton solve did not converge to a monotone latitude "
            f"distribution (endpoint {phis[-1]!r}); is the spacing law positive?")
    phis[-1] = hi  # pin the pole row exactly (Newton residual <= tol)
    return phis


def _embed_with_halo(interior_yx, Hx, Hy):
    """Embed an interior (Ny, Nx) array into a halo-inclusive array (halo zeroed).

    Only the halo strips are zero-filled — a full ``np.zeros`` pass costs a second
    write of the whole array, which dominates construction on bandwidth-poor hosts."""
    Ny, Nx = interior_yx.shape
    out = np.empty((Ny + 2 * Hy, Nx + 2 * Hx), dtype=interior_yx.dtype)
    out[:Hy, :] = 0.0
    out[Hy + Ny :, :] = 0.0
    out[:, :Hx] = 0.0
    out[:, Hx + Nx :] = 0.0
    out[Hy : Hy + Ny, Hx : Hx + Nx] = interior_yx
    return out


def _fill_coord_halos(A, loc, Nx, Ny, Hx, Hy):
    """Coordinate/metric halo fill: zipper(+1) north, periodic x, open south
    (``src/tripolar_grid.jl:147-152``: manual BCs with sign +1 for coords/metrics)."""
    # inplace: A is the fresh buffer from _embed_with_halo — avoid ~1 GB of
    # copy-on-write memcpy across the 20 coordinate/metric fills at 1/4 degree
    return zipper.fill_halos(A, loc, 1, Nx, Ny, Hx, Hy, south="none", fold=True, xp=np,
                             inplace=True)


def build_tripolar_arrays(
    size,
    southernmost_latitude=-80.0,
    halo=(4, 4, 4),
    radius=geo.R_EARTH,
    z=(0.0, 1.0),
    north_poles_latitude=55.0,
    first_pole_longitude=70.0,
    backend="auto",
    phi_spacing=None,
):
    """Build all tripolar coordinate/metric arrays in float64 numpy.

    Returns a dict of halo-inclusive (Ny+2Hy, Nx+2Hx) arrays for the 8 coordinates and
    12 metrics, plus 1-D z data — the full member list of the reference's assembled
    ``OrthogonalSphericalShellGrid`` (``src/tripolar_grid.jl:304-330``, SURVEY.md O1).
    Keyword names and defaults replicate the reference constructor signature
    (``src/tripolar_grid.jl:59-66``).
    """
    Nx, Ny, Nz = size
    Hx, Hy, Hz = halo
    if Nx % 2 != 0:
        raise ValueError("The number of cells in the longitude dimension should be even!")
    if not (0 < Hx <= Nx and 0 < Hy <= Ny):
        raise ValueError(f"halo {halo} must be positive and no larger than size {size}")

    focal_distance = _tand((90.0 - north_poles_latitude) / 2.0)

    # 1-D coordinates (src/tripolar_grid.jl:90-97). λ faces start at -180.
    dlam = 360.0 / Nx
    lamF1 = -180.0 + dlam * np.arange(Nx, dtype=np.float64)
    lamC1 = lamF1 + dlam / 2.0
    if phi_spacing is None:
        # uniform latitude placement (src/tripolar_grid.jl:95-97)
        phiC1 = np.linspace(southernmost_latitude, 90.0, Ny)
        dphi = phiC1[1] - phiC1[0]
        phiF1 = phiC1 - dphi / 2.0
    else:
        # prescribed-spacing placement via the jitted Newton shooting solve; faces
        # sit midway between consecutive centers (= the uniform rule when the law
        # is constant), with the south face extrapolated.
        phiC1 = newton_phi_nodes(southernmost_latitude, Ny, phi_spacing)
        phiF1 = np.empty_like(phiC1)
        phiF1[1:] = 0.5 * (phiC1[1:] + phiC1[:-1])
        phiF1[0] = phiC1[0] - 0.5 * (phiC1[1] - phiC1[0])

    # Murray mapping at the 4 staggered locations; λ1D pairs with x-location, φ1D with
    # y-location (src/generate_tripolar_coordinates.jl:56-59). The native C++/OpenMP
    # kernels (native/tripolar_gen.cpp) accelerate large grids — the reference's own
    # noted bottleneck at sub-kilometer resolution (src/tripolar_grid.jl:68-71).
    from . import native as _native

    use_native = backend == "native" or (
        backend == "auto" and Nx * Ny >= 512 * 256 and _native.available()
    )
    if backend == "native" and not _native.available():
        raise RuntimeError("native grid-generation backend requested but unavailable")
    if use_native:
        mapper = lambda l1, p1: _native.murray_coords(
            l1, p1, Nx, focal_distance, first_pole_longitude)
    else:
        mapper = lambda l1, p1: _murray_mapping(
            l1, p1, Nx, focal_distance, first_pole_longitude)
    # circshift by Nλ÷4 puts pole 1 at i=1 and pole 2 at i=Nλ/2+1
    # (src/tripolar_grid.jl:119-130). The mapping is pointwise in the 1-D longitude
    # (its index tests are longitude-valued), so the 8 full-array circshifts become a
    # free roll of the two 1-D inputs — at 1/12 degree that saves ~0.5 GB of memcpy.
    shift = Nx // 4
    lamF1 = np.roll(lamF1, shift)
    lamC1 = np.roll(lamC1, shift)

    lam_ff, phi_ff = mapper(lamF1, phiF1)
    lam_fc, phi_fc = mapper(lamF1, phiC1)
    lam_cf, phi_cf = mapper(lamC1, phiF1)
    lam_cc, phi_cc = mapper(lamC1, phiC1)

    coords = {
        "lam_ff": lam_ff, "phi_ff": phi_ff, "lam_fc": lam_fc, "phi_fc": phi_fc,
        "lam_cf": lam_cf, "phi_cf": phi_cf, "lam_cc": lam_cc, "phi_cc": phi_cc,
    }

    # Halo fill of the coordinates through the zipper(+1)/periodic path
    # (src/tripolar_grid.jl:137-186).
    loc_of = {"ff": FF, "fc": FC, "cf": CF, "cc": CC}
    for name in list(coords):
        loc = loc_of[name.split("_")[1]]
        coords[name] = _fill_coord_halos(_embed_with_halo(coords[name], Hx, Hy), loc, Nx, Ny, Hx, Hy)

    lamFF, phiFF = coords["lam_ff"], coords["phi_ff"]
    lamFC, phiFC = coords["lam_fc"], coords["phi_fc"]
    lamCF, phiCF = coords["lam_cf"], coords["phi_cf"]
    lamCC, phiCC = coords["lam_cc"], coords["phi_cc"]

    # Metric terms over the interior, reading coordinate halos for the neighbor points
    # (port of _calculate_metrics!, src/tripolar_grid_utils.jl:4-45).
    J = slice(Hy, Hy + Ny)
    Jp = slice(Hy + 1, Hy + Ny + 1)
    Jm = slice(Hy - 1, Hy + Ny - 1)
    I = slice(Hx, Hx + Nx)
    Ip = slice(Hx + 1, Hx + Nx + 1)
    Im = slice(Hx - 1, Hx + Nx - 1)

    def hav(lam, phi, Ja, Ia, Jb, Ib):
        return geo.haversine(lam[Ja, Ia], phi[Ja, Ia], lam[Jb, Ib], phi[Jb, Ib], radius, xp=np)

    if use_native:
        metrics = _native.metric_arcs(coords, Nx, Ny, Hx, Hy, radius)
        dx_cc, dx_fc, dx_cf, dx_ff = (metrics[k] for k in ("dx_cc", "dx_fc", "dx_cf", "dx_ff"))
        dy_cc, dy_fc, dy_cf, dy_ff = (metrics[k] for k in ("dy_cc", "dy_fc", "dy_cf", "dy_ff"))
        az_cc, az_fc, az_cf, az_ff = (metrics[k] for k in ("az_cc", "az_fc", "az_cf", "az_ff"))
    else:
        dx_cc = hav(lamFC, phiFC, J, Ip, J, I)
        dx_fc = hav(lamCC, phiCC, J, I, J, Im)
        dx_cf = hav(lamFF, phiFF, J, Ip, J, I)
        dx_ff = hav(lamCF, phiCF, J, I, J, Im)

        dy_cc = hav(lamCF, phiCF, Jp, I, J, I)
        dy_fc = hav(lamFF, phiFF, Jp, I, J, I)
        dy_cf = hav(lamCC, phiCC, J, I, Jm, I)
        dy_ff = hav(lamFC, phiFC, J, I, Jm, I)

        def cart(phi, lam, Ja, Ia):
            return geo.lat_lon_to_cartesian(phi[Ja, Ia], lam[Ja, Ia], 1.0, xp=np)

        # Az_CC: spherical quadrilateral of the four surrounding FF nodes (:23-28).
        az_cc = geo.spherical_area_quadrilateral(
            cart(phiFF, lamFF, J, I), cart(phiFF, lamFF, J, Ip),
            cart(phiFF, lamFF, Jp, Ip), cart(phiFF, lamFF, Jp, I), xp=np,
        ) * radius**2
        # Az_FC / Az_CF as edge-length products for kinetic-energy conservation (:30-35).
        az_fc = dy_fc * dx_fc
        az_cf = dy_cf * dx_cf
        # Az_FF: spherical quadrilateral of the four surrounding CC nodes (:37-43).
        az_ff = geo.spherical_area_quadrilateral(
            cart(phiCC, lamCC, Jm, Im), cart(phiCC, lamCC, Jm, I),
            cart(phiCC, lamCC, J, I), cart(phiCC, lamCC, J, Im), xp=np,
        ) * radius**2

    metrics = {
        "dx_cc": dx_cc, "dx_fc": dx_fc, "dx_cf": dx_cf, "dx_ff": dx_ff,
        "dy_cc": dy_cc, "dy_fc": dy_fc, "dy_cf": dy_cf, "dy_ff": dy_ff,
        "az_cc": az_cc, "az_fc": az_fc, "az_cf": az_cf, "az_ff": az_ff,
    }

    # Halo fill of the metrics through the same zipper(+1)/periodic path
    # (src/tripolar_grid.jl:230-273).
    for name in list(metrics):
        loc = loc_of[name.split("_")[1]]
        metrics[name] = _fill_coord_halos(_embed_with_halo(metrics[name], Hx, Hy), loc, Nx, Ny, Hx, Hy)

    # South continuation with closed-form LatitudeLongitudeGrid metrics
    # (src/tripolar_grid.jl:277-300; Δyᶠᶠ<-Δyᶠᶜ and Δyᶜᶜ<-Δyᶜᶠ are the reference's own
    # reuse — for a uniform grid all four Δy are the same scalar R·Δφ). Like the
    # reference's continue_south! loop bounds (j in Hy+1:1, src/tripolar_grid.jl:341),
    # the overwrite includes interior row j=1: the Δyᶜᶠ/Δyᶠᶠ values there read the never-
    # filled south coordinate halo and are garbage otherwise. Unlike the reference we
    # overwrite *all* columns (its i-range quirk skips the easternmost Hx+... columns).
    j_cont = np.arange(1 - Hy, 2)  # 1-based rows: south halo plus interior row 1
    ll = latlon_metrics_1d(
        j_cont, southernmost_latitude=southernmost_latitude, Ny=Ny, radius=radius, dlam_deg=dlam
    )
    for name in metrics:
        kind = name.split("_")[0]
        if kind == "dy":
            metrics[name][: Hy + 1, :] = ll["dy"]
        else:
            metrics[name][: Hy + 1, :] = ll[name][:, None]

    # z coordinate (src/tripolar_grid.jl:91: generate_coordinate over a (z_bottom,
    # z_top) tuple -> uniform spacing; Oceananigans's generate_coordinate also accepts
    # an interface ARRAY -> stretched layers, supported here the same way).
    z_seq = np.asarray(z, np.float64).ravel()
    if z_seq.size == 2:
        z0, z1 = float(z_seq[0]), float(z_seq[1])
        z_f = np.linspace(z0, z1, Nz + 1)
        z_interfaces = None
    elif z_seq.size == Nz + 1:
        if not np.all(np.diff(z_seq) > 0):
            raise ValueError("z interfaces must be strictly increasing (bottom to top)")
        z_f = z_seq
        z0, z1 = float(z_f[0]), float(z_f[-1])
        z_interfaces = tuple(float(v) for v in z_f)
    else:
        raise ValueError(
            f"z must be a (z_bottom, z_top) tuple or Nz+1={Nz + 1} interfaces, "
            f"got {z_seq.size} values")
    z_c = 0.5 * (z_f[:-1] + z_f[1:])
    dz = (z1 - z0) / Nz  # MEAN spacing; per-layer thickness lives in z_f
    Lz = z1 - z0

    out = dict(coords)
    out.update(metrics)
    out.update({"z_f": z_f, "z_c": z_c})
    out["meta"] = dict(
        Nx=Nx, Ny=Ny, Nz=Nz, Hx=Hx, Hy=Hy, Hz=Hz,
        radius=float(radius), Lz=float(Lz), dz=float(dz),
        southernmost_latitude=float(southernmost_latitude),
        north_poles_latitude=float(north_poles_latitude),
        first_pole_longitude=float(first_pole_longitude),
        z_bounds=(z0, z1),
        phi_spacing=phi_spacing,
        z_interfaces=z_interfaces,
    )
    return out


# --------------------------------------------------------------------------------------
# The TripolarGrid pytree
# --------------------------------------------------------------------------------------

_ARRAY_FIELDS = [
    "lam_cc", "lam_fc", "lam_cf", "lam_ff",
    "phi_cc", "phi_fc", "phi_cf", "phi_ff",
    "dx_cc", "dx_fc", "dx_cf", "dx_ff",
    "dy_cc", "dy_fc", "dy_cf", "dy_ff",
    "az_cc", "az_fc", "az_cf", "az_ff",
    "z_f", "z_c",
]

_META_FIELDS = [
    "Nx", "Ny", "Nz", "Hx", "Hy", "Hz",
    "radius", "Lz", "dz",
    "southernmost_latitude", "north_poles_latitude", "first_pole_longitude",
    "z_bounds", "phi_spacing", "z_interfaces",
]


@dataclasses.dataclass(frozen=True)
class TripolarGrid:
    """Frozen pytree of precomputed tripolar coordinate/metric arrays (SURVEY.md O1).

    Array members are halo-inclusive ``(Ny+2Hy, Nx+2Hx)`` with layout [y, x] (x on the
    minor (contiguous) dimension); sizes/halos/mapping parameters are static metadata, so the grid
    can be closed over or passed through ``jax.jit`` with static shapes. The
    ``conformal_mapping`` payload of the reference (``Tripolar`` struct,
    ``src/tripolar_grid.jl:6-10``) lives in the three ``*_latitude``/``*_longitude``
    metadata fields, which is what makes ``with_halo`` reconstruction possible.
    """

    # coordinates (degrees)
    lam_cc: Any; lam_fc: Any; lam_cf: Any; lam_ff: Any
    phi_cc: Any; phi_fc: Any; phi_cf: Any; phi_ff: Any
    # metrics (meters / square meters)
    dx_cc: Any; dx_fc: Any; dx_cf: Any; dx_ff: Any
    dy_cc: Any; dy_fc: Any; dy_cf: Any; dy_ff: Any
    az_cc: Any; az_fc: Any; az_cf: Any; az_ff: Any
    # vertical coordinate
    z_f: Any; z_c: Any
    # static metadata
    Nx: int; Ny: int; Nz: int; Hx: int; Hy: int; Hz: int
    radius: float; Lz: float; dz: float
    southernmost_latitude: float; north_poles_latitude: float; first_pole_longitude: float
    z_bounds: tuple
    # optional latitude-spacing law (callable, static): None = uniform placement;
    # otherwise rows are placed by the jitted Newton shooting solve (newton_phi_nodes)
    phi_spacing: Any = None
    # stretched vertical coordinate: tuple of Nz+1 interface positions (bottom->top)
    # when z was given as an interface array; None = uniform layers over z_bounds
    z_interfaces: Any = None

    # ---- construction ----
    @staticmethod
    def make(
        size,
        southernmost_latitude=-80.0,
        halo=(4, 4, 4),
        radius=geo.R_EARTH,
        z=(0.0, 1.0),
        north_poles_latitude=55.0,
        first_pole_longitude=70.0,
        dtype=None,
        phi_spacing=None,
    ):
        """Construct a TripolarGrid; signature mirrors the reference constructor
        (``src/tripolar_grid.jl:59-66``). ``dtype`` plays the role of the reference's
        ``FT`` argument (default float32; pass jnp.float64 under x64)."""
        import jax.numpy as jnp

        if dtype is None:
            dtype = jnp.float32
        raw = build_tripolar_arrays(
            size,
            southernmost_latitude=southernmost_latitude,
            halo=halo,
            radius=radius,
            z=z,
            north_poles_latitude=north_poles_latitude,
            first_pole_longitude=first_pole_longitude,
            phi_spacing=phi_spacing,
        )
        meta = raw.pop("meta")
        # Ship all 2-D arrays as ONE stacked host->device transfer and split with ONE
        # jitted unstack: every eager op (including each individual slice) would
        # pay a dispatch and a compile of its own.
        import jax

        names_2d = [k for k in _ARRAY_FIELDS if k not in ("z_f", "z_c")]
        stacked = np.stack([raw[k] for k in names_2d]).astype(np.dtype(dtype), copy=False)
        dev = jnp.asarray(stacked)
        parts = jax.jit(lambda s: tuple(s[i] for i in range(len(names_2d))))(dev)
        arrays = dict(zip(names_2d, parts))
        arrays["z_f"] = jnp.asarray(raw["z_f"], dtype=dtype)
        arrays["z_c"] = jnp.asarray(raw["z_c"], dtype=dtype)
        return TripolarGrid(**arrays, **meta)

    # ---- convenience ----
    @property
    def size(self):
        return (self.Nx, self.Ny, self.Nz)

    @property
    def halo(self):
        return (self.Hx, self.Hy, self.Hz)

    @property
    def shape2d(self):
        """Halo-inclusive (y, x) shape of 2-D fields on this grid."""
        return (self.Ny + 2 * self.Hy, self.Nx + 2 * self.Hx)

    @property
    def interior2d(self):
        """(y, x) slices selecting the interior of a halo-inclusive 2-D field."""
        return (slice(self.Hy, self.Hy + self.Ny), slice(self.Hx, self.Hx + self.Nx))

    def interior(self, A):
        jy, jx = self.interior2d
        return A[..., jy, jx]

    @property
    def dtype(self):
        return self.lam_cc.dtype

    @property
    def conformal_mapping(self):
        return dict(
            north_poles_latitude=self.north_poles_latitude,
            first_pole_longitude=self.first_pole_longitude,
            southernmost_latitude=self.southernmost_latitude,
        )


try:  # register as a JAX pytree (dataclass registration keeps meta static)
    import jax

    jax.tree_util.register_dataclass(
        TripolarGrid, data_fields=_ARRAY_FIELDS, meta_fields=_META_FIELDS
    )
except Exception:  # pragma: no cover - numpy-only environments
    pass


def cartesian_nodes(grid: TripolarGrid, loc="ff"):
    """Unit-sphere cartesian (x, y, z) interior node arrays at a staggered location.

    Equivalent of the reference's ``get_cartesian_nodes_and_vertices`` node half
    (used by ``examples/visualize_tripolar_grid.jl:41-45`` and the orthogonality
    test ``test/test_tripolar_grid.jl``)."""
    lam = grid.interior(getattr(grid, f"lam_{loc}"))
    phi = grid.interior(getattr(grid, f"phi_{loc}"))
    return geo.lat_lon_to_cartesian(np.asarray(phi), np.asarray(lam), 1.0, xp=np)


def with_halo(grid: TripolarGrid, new_halo) -> TripolarGrid:
    """Regenerate the grid with a different halo from its conformal-mapping parameters.

    Port of ``with_halo(new_halo, ::TripolarGrid)`` (``src/with_halo.jl:5-23``) — a full
    re-run of the constructor, required by the split-explicit free surface which widens
    the y-halo to make the barotropic substep loop communication-free
    (``test/runtests.jl:58-71``)."""
    return TripolarGrid.make(
        grid.size,
        southernmost_latitude=grid.southernmost_latitude,
        halo=tuple(new_halo),
        radius=grid.radius,
        z=grid.z_interfaces if grid.z_interfaces is not None else grid.z_bounds,
        north_poles_latitude=grid.north_poles_latitude,
        first_pole_longitude=grid.first_pole_longitude,
        dtype=grid.dtype,
        phi_spacing=grid.phi_spacing,
    )
