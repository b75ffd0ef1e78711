"""Temporally blocked barotropic subcycle for NVIDIA GPUs (Pallas through Triton).

The XLA formulation (``models/hydrostatic.py::barotropic_substeps_xla``) streams
about 20 planes of the extended grid per substep: the state (η, U, V), the forcing
(GU, GV), nine static planes and the three SM05 accumulators. At 1/4° a plane is
~4 MB and the loop's working set exceeds the H100's 50 MB L2, so every substep
goes back to HBM.

This kernel tiles the (y, x) plane and runs up to ``k`` substeps per launch on each
tile:

- each program reads a ``BY x BX`` window: its ``(BY-2k) x (BX-2k)`` output centre
  plus a ring of ``k`` cells, which is the stencil's reach over ``k`` substeps
  (validity shrinks one cell per substep, as in the widened-halo loop); the inputs
  are zero-padded once so that every window is a contiguous in-bounds block;
- the shifted neighbour reads between substeps go through a program-private
  scratch window with a one-cell border (written, barrier, read back), which stays
  in L1/L2;
- the statics, the forcing and the accumulators stay in registers for the
  launch's (unrolled) substeps;
- only the centre is written back, so HBM sees the state, forcing and statics
  once per ``k`` substeps instead of once per substep, against a redundancy of
  ``BY*BX / ((BY-2k)*(BX-2k))`` in compute and window loads.

It serves the widened-halo loop (no per-substep x-wrap), which is the only loop
``make_model`` builds. Every operation is the scan's, in the scan's order; results
agree with it on the valid region up to FMA contraction (``tests/test_pallas.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["barotropic_substeps_triton", "DEFAULT_TILE", "DEFAULT_K",
           "DEFAULT_NUM_WARPS"]

DEFAULT_TILE = (32, 128)
DEFAULT_K = 5
DEFAULT_NUM_WARPS = 8

_STATICS = ("dy_fc", "dx_cf", "inv_az", "h_u", "inv_dx", "h_v", "inv_dy",
            "mask_u", "mask_v")
_XPAD = 4  # scratch column offset: keeps the centre store 16-byte aligned


def _kernel(*refs, BY, BX, k, kk, n_px, s0, g, first, last, interpret):
    n_in = 5 + len(_STATICS) + 2 + (0 if first else 3) + (0 if last else 3)
    ins, outs = refs[:n_in], refs[n_in:]
    eta_r, U_r, V_r, GU_r, GV_r = ins[:5]
    (dyfc_r, dxcf_r, iaz_r, hu_r, idx_r, hv_r, idy_r, mu_r, mv_r) = ins[5:14]
    w_r, dtau_r = ins[14:16]
    scr = outs[-1]

    def barrier():
        # the interpreter runs programs one at a time; a barrier only exists on
        # the device
        if not interpret:
            pltriton.debug_barrier()

    py = pl.program_id(0)
    px = pl.program_id(1)
    r0 = py * (BY - 2 * k)
    c0 = px * (BX - 2 * k)
    pid = py * n_px + px

    def win(ref):
        return ref[pl.ds(r0, BY), pl.ds(c0, BX)]

    def sidx(plane, dr=0, dc=0):  # this program's scratch window, shifted
        # constant indices: Python ints for the Triton lowering (which rejects
        # array constants there); int32 in the interpreter, whose slices need one
        # index type with program_id's when x64 is on
        i32 = jnp.int32 if interpret else int
        return (pid, i32(plane), pl.ds(i32(1 + dr), BY), pl.ds(i32(_XPAD + dc), BX))

    def sput(plane, val):
        scr[sidx(plane)] = val

    def sget(plane, dr, dc):
        return scr[sidx(plane, dr, dc)]

    dtau = dtau_r[0]
    # the statics and the forcing, read once per launch and held in registers
    dyfc, dxcf, iaz = win(dyfc_r), win(dxcf_r), win(iaz_r)
    gH_u, gH_v = g * win(hu_r), g * win(hv_r)
    idx, idy, mu, mv = win(idx_r), win(idy_r), win(mu_r), win(mv_r)
    GU, GV = win(GU_r), win(GV_r)
    eta, U, V = win(eta_r), win(U_r), win(V_r)
    P = dyfc * U
    Q = dxcf * V
    sput(0, P)
    sput(1, Q)
    barrier()
    if first:
        zero = jnp.zeros((BY, BX), eta.dtype)
        ea, Ua, Va = zero, zero, zero
    else:
        ea, Ua, Va = (win(a_r) for a_r in ins[16:19])

    for s in range(kk):  # unrolled: kk is small and static
        # div = (δx(Δy U) + δy(Δx V)) / Az at cell centres
        div = ((sget(0, 0, 1) - P) + (sget(1, 1, 0) - Q)) * iaz
        eta = eta - dtau * div
        sput(2, eta)
        barrier()
        U = (U - dtau * (gH_u * (eta - sget(2, 0, -1)) * idx - GU)) * mu
        V = (V - dtau * (gH_v * (eta - sget(2, -1, 0)) * idy - GV)) * mv
        P = dyfc * U
        Q = dxcf * V
        sput(0, P)
        sput(1, Q)
        barrier()
        w = w_r[s0 + s]
        ea, Ua, Va = ea + w * eta, Ua + w * U, Va + w * V

    r = jax.lax.broadcasted_iota(jnp.int32, (BY, BX), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (BY, BX), 1)
    centre = (r >= k) & (r < BY - k) & (c >= k) & (c < BX - k)
    vals = (ea, Ua, Va) + (() if last else (eta, U, V))
    for ref, val in zip(outs[:-1], vals):
        pltriton.store(ref.at[pl.ds(r0, BY), pl.ds(c0, BX)], val, mask=centre)


def barotropic_substeps_triton(eta, U, V, GU, GV, statics, dtau, weights, g, *,
                               tile=DEFAULT_TILE, k=DEFAULT_K,
                               num_warps=DEFAULT_NUM_WARPS, interpret=False):
    """SM05-averaged forward-backward substeps of (η, U, V) without a per-substep
    x-wrap; returns the averaged (η, U, V) like ``barotropic_substeps_xla``.

    ``statics`` maps the names in ``_STATICS`` to extended-grid planes (the
    model's ``dy_fc_e``, ``dx_cf_e``, ``inv_az_cc_e``, ``h_u_e``, ``inv_dx_fc_e``,
    ``h_v_e``, ``inv_dy_cf_e``, ``mask_u_e``, ``mask_v_e``); ``g`` is the static
    gravitational acceleration. ``tile`` is the (BY, BX) window (powers of two),
    ``k`` the substeps per launch; the loop takes ceil(n_sub / k) launches."""
    Ye, Xe = eta.shape
    BY, BX = tile
    n_sub = int(weights.shape[0])
    k = max(1, min(k, n_sub))
    CY, CX = BY - 2 * k, BX - 2 * k
    if CY < 1 or CX < 1:
        raise ValueError(f"tile {tile} leaves no output centre at k={k}")
    n_py, n_px = -(-Ye // CY), -(-Xe // CX)
    Yp, Xp = n_py * CY + 2 * k, n_px * CX + 2 * k
    dt = eta.dtype
    # under shard_map the outputs vary over the mesh axes the state varies over
    vma = jax.typeof(eta).vma
    plane = jax.ShapeDtypeStruct((Yp, Xp), dt, vma=vma)
    scratch = jax.ShapeDtypeStruct((n_py * n_px, 3, BY + 2, BX + 2 * _XPAD), dt,
                                   vma=vma)

    def pad(a):
        return jnp.pad(a, ((k, Yp - Ye - k), (k, Xp - Xe - k)))

    stat = [pad(statics[n]) for n in _STATICS]
    forcing = [pad(GU), pad(GV)]
    scal = [weights.astype(dt), jnp.reshape(jnp.asarray(dtau, dt), (1,))]

    state = [pad(eta), pad(U), pad(V)]
    accs = []
    for s0 in range(0, n_sub, k):
        kk = min(k, n_sub - s0)
        first, last = s0 == 0, s0 + kk >= n_sub
        # the next launch reads its windows' rings from this launch's state
        # outputs: start them from zeros so the padding stays finite
        fresh = [] if last else [jnp.zeros((Yp, Xp), dt)] * 3
        n_in = 5 + len(stat) + 2 + len(accs)
        kern = functools.partial(
            _kernel, BY=BY, BX=BX, k=k, kk=kk, n_px=n_px, s0=s0, g=float(g),
            first=first, last=last, interpret=interpret)
        out = pl.pallas_call(
            kern,
            out_shape=[plane] * (3 + len(fresh)) + [scratch],
            grid=(n_py, n_px),
            input_output_aliases={n_in + i: 3 + i for i in range(len(fresh))},
            backend="triton",
            interpret=interpret,
            compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                    num_stages=1),
            name="barotropic_substeps",
        )(*state, *forcing, *stat, *scal, *accs, *fresh)
        accs = list(out[:3])
        if not last:
            state = list(out[3:6])
    return tuple(a[k:k + Ye, k:k + Xe] for a in accs)
