"""Visualize a tripolar grid.

JAX analog of the reference's ``examples/visualize_tripolar_grid.jl``:
generate a 60x30 tripolar grid with the north singularities moved to 60N, convert the
Face-Face and Center-Center nodes to unit-sphere cartesian coordinates, and render the
two hemispheres side by side (matplotlib replaces GLMakie). The key feature to see:
no gridline-convergence singularity at the true North Pole — the two fictitious poles
sit at 60N over land, while the South Pole singularity stays inside Antarctica.

Run: python examples/visualize_tripolar_grid.py  (writes tripolar_grid_nodes.png)
"""
from __future__ import annotations

import numpy as np

import orthogonalsphericalshellgrids_tpu as osg
from orthogonalsphericalshellgrids_tpu.grids.tripolar import cartesian_nodes


def main(out="tripolar_grid_nodes.png"):
    grid = osg.TripolarGrid.make(size=(60, 30, 1), north_poles_latitude=60.0)

    xF, yF, zF = cartesian_nodes(grid, "ff")
    xC, yC, zC = cartesian_nodes(grid, "cc")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 6))
    for k, elev in ((1, 60.0), (2, -60.0)):
        ax = fig.add_subplot(1, 2, k, projection="3d")
        ax.plot_wireframe(xF, yF, zF, color="black", linewidth=0.3)
        ax.plot_wireframe(xC, yC, zC, color="tab:blue", linewidth=0.3)
        ax.scatter([0, 0], [0, 0], [1, -1], color="red", s=40)  # true poles
        ax.view_init(elev=elev, azim=40)
        ax.set_box_aspect((1, 1, 1))
        ax.set_axis_off()
    fig.suptitle("Tripolar grid nodes: Northern (left) / Southern (right) hemisphere")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
