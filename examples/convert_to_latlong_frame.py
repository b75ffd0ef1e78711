"""Rotate vector fields between the tripolar (native) frame and the geographic frame.

JAX analog of the reference's ``examples/convert_to_latlong_frame.jl``: a
purely zonal geographic velocity (u=1, v=0) is rotated into the tripolar grid's native
frame (what you'd use to initialize a zonal jet on the grid), then rotated back —
demonstrating the round trip is the identity. The rotation assumes local orthogonality
of the mesh, with the local angle derived from how latitude varies along the native
grid axes (utils/rotation.py; reference recipe at
``examples/convert_to_latlong_frame.jl:12-55``).
"""
from __future__ import annotations

import numpy as np

import orthogonalsphericalshellgrids_tpu as osg
from orthogonalsphericalshellgrids_tpu.utils.rotation import (
    to_latlon_frame, to_native_frame)


def main():
    # 2-degree grid with the north singularities at 35N (reference's configuration)
    grid = osg.TripolarGrid.make(size=(180, 90, 1), north_poles_latitude=35.0)

    # purely zonal geographic velocity at cell centers
    u_ll = np.ones(grid.shape2d, np.float64)
    v_ll = np.zeros(grid.shape2d, np.float64)

    # geographic -> native (tripolar) frame
    u_tr, v_tr = to_native_frame(grid, u_ll, v_ll)

    # native -> geographic round trip
    u_back, v_back = to_latlon_frame(grid, np.asarray(u_tr), np.asarray(v_tr))

    iy, ix = grid.interior2d
    err_u = float(np.max(np.abs(np.asarray(u_back)[iy, ix] - 1.0)))
    err_v = float(np.max(np.abs(np.asarray(v_back)[iy, ix])))
    print(f"round-trip max|u-1| = {err_u:.2e}, max|v| = {err_v:.2e}")

    # far from the fictitious poles the mapping approaches lat-lon, so the native
    # frame deflection of a zonal flow decays toward zero going south
    phi = np.asarray(grid.interior(grid.phi_cc))
    v_i = np.abs(np.asarray(v_tr)[iy, ix])
    for cut in (0.0, -40.0):
        print(f"max native-frame deflection south of {cut:+.0f}deg: "
              f"{float(np.max(v_i[phi < cut])):.2e}")


if __name__ == "__main__":
    main()
