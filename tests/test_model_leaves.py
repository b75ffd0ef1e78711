"""What a model build allocates on the device: the planes its XLA step reads, and
nothing else (no operand packs for a kernel), on any backend. Every array leaf has
a registered distributed layout (parallel/layouts.py)."""

import numpy as np

import jax
import jax.numpy as jnp

import orthogonalsphericalshellgrids_tpu as osg
from orthogonalsphericalshellgrids_tpu.models import (
    SplitExplicitFreeSurface, make_layered_model, make_model)
from orthogonalsphericalshellgrids_tpu.parallel import layouts

MODEL_LEAVES = {
    "inv_dx_fc", "inv_dy_cf", "inv_az_ff", "inv_vol_c", "inv_dx_fc_e", "inv_dy_cf_e",
    "inv_az_cc_e", "dy_fc_e", "dx_cf_e", "h_u_e", "h_v_e", "mask_u_e", "mask_v_e",
    "weights", "f_ff", "taux", "tauy",
}
LAYERED_LEAVES = {"mask_c3", "mask_u3", "mask_v3", "dzu", "dzv", "inv_h_u", "inv_h_v",
                  "bot_u", "bot_v"}


def _own_leaves(model):
    """(name, leaf) of the model's own array fields (not grid / ib containers)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(model):
        names = [k.name for k in path if hasattr(k, "name")]
        if names and names[0] == "baro":
            names = names[1:]
        if names and names[0] not in ("grid", "grid_ext", "ib"):
            out[".".join(names)] = leaf
    return out


def _grid(nz):
    return osg.TripolarGrid.make((48, 32, nz), dtype=jnp.float32, z=(-1000.0, 0.0),
                                 first_pole_longitude=45.0, north_poles_latitude=25.0)


def _bottom(lam, phi):
    return np.where(phi < -78, 1.0, -1000.0)


def test_single_layer_build_allocates_only_step_planes():
    # every closure on, so no closure-specific plane could hide
    m = make_model(_grid(1), free_surface=SplitExplicitFreeSurface(substeps=12),
                   bottom_height=_bottom, coriolis=True, nu_h=1e3, kappa_h=1e2,
                   bottom_drag=("quadratic", 2.5e-3),
                   wind_stress=lambda l, p: (1e-4 * np.cos(np.deg2rad(p)), 0 * p))
    leaves = _own_leaves(m)
    assert set(leaves) == MODEL_LEAVES
    assert all(np.ndim(a) <= 2 for a in leaves.values())
    layouts.classify_tree(m)  # raises on an unregistered leaf


def test_layered_build_allocates_only_step_planes():
    nz = 4
    m = make_layered_model(_grid(nz), free_surface=SplitExplicitFreeSurface(substeps=12),
                           bottom_height=_bottom, tracers=("T", "S"),
                           buoyancy="linear_eos", coriolis=True, nu_h=1e3, kappa_h=1e2,
                           nu_v=1e-3, kappa_v=1e-5, bottom_drag=("quadratic", 2.5e-3))
    leaves = _own_leaves(m)
    assert set(leaves) == MODEL_LEAVES | LAYERED_LEAVES
    for name in LAYERED_LEAVES - {"inv_h_u", "inv_h_v"}:
        assert leaves[name].shape == (nz,) + m.grid.shape2d, name
    layouts.classify_tree(m)
