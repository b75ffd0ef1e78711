"""Chip smoke test: the 1/4-degree Bickley-jet and 1/4-degree x 10-layer T/S-gyre
steps on one NVIDIA GPU, checked against the same formulation on the CPU.

    python chip_smoke.py          # one card: both models + the barotropic kernel
    python chip_smoke.py --four   # four cards: the sharded paths against serial

Each model is built through its example's ``build`` and stepped through
``multi_step`` / ``layered_multi_step`` in scanned blocks of 10 steps, as a user
runs it. Per model it prints the compiled step's memory analysis, each field's
error against a CPU run of the same steps, the invariants, the steady ms/step
(informational; no profiler) and the device's peak memory. The last line of
stdout is one JSON object ``{"ok": true, "device": {...}}``; any failed phase
exits non-zero before it is printed, as does a machine where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

BLOCK = 10          # steps per jitted call, as in the examples' drivers
COMPARE_BLOCKS = 2  # blocks run on both the GPU and the CPU and compared
TIME_BLOCKS = 5     # further blocks timed on the GPU

# Per-field tolerance on max|gpu - cpu| / max|cpu| over the interior after
# COMPARE_BLOCKS * BLOCK float32 steps. The step has no matrix products, so TF32
# never enters; the two runs differ only by FMA contraction and summation order.
# Their spread is bounded by float32's own rounding band over these 20 steps,
# which float32 against float64 on the CPU measures (192 x 96 grid, same models):
# up to 1.7e-4 (Bickley eta) and 4.2e-4 (gyre eta; the gyre's v starts from
# rest and is 6e-4 m/s at most, so its relative band is 1.8e-4). Two float32 runs
# rounding differently can each sit anywhere in that band. A wrong stencil, sign
# or fold shows up at O(1e-2..1).
FIELD_RTOL = 1e-3
# The barotropic kernel against the XLA scan on the same card, one subcycle of
# 21 substeps: same operations in the same order, so only FMA contraction differs.
KERNEL_RTOL = 1e-5
# Free-surface volume: sum(eta * Az) relative to sum(|eta| * Az). It telescopes
# exactly in exact arithmetic; float32 leaves ~1e-7 per update.
VOLUME_RTOL = 1e-5
# Tracers may leave their initial range only by the advection schemes' small
# overshoots: horizontal WENO-5 has no limiter and the layered model's vertical
# tracer advection is centered, so the gyre's salinity gains new extrema of ~0.2%
# of its range within 20 steps (on the card and on the CPU alike). A sign or
# fold error moves a tracer by O(its range).
TRACER_SLACK = 1e-2  # as a fraction of the initial range


# the cards' "name, power.limit" lines, set by main() from nvidia-smi
CARD = "card not queried"


def card_info():
    """The cards' name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpus(n):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU: JAX's devices are {devs}")
    if len(devs) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPU(s), JAX sees {len(devs)}")
    return devs


def log(*a):
    print(*a, flush=True)


def peak_bytes(dev):
    stats = dev.memory_stats()  # None on the CPU
    return stats["peak_bytes_in_use"] if stats else "not reported"


def interior(a, H):
    """The interior of a halo-inclusive (..., y, x) array with halo (Hy, Hx)."""
    Hy, Hx = H
    return np.asarray(a)[..., Hy:a.shape[-2] - Hy, Hx:a.shape[-1] - Hx]


def field_halos(model):
    """Field name -> (Hy, Hx) of the grid it lives on."""
    g, ge = model.grid, model.grid_ext
    base, ext = (g.Hy, g.Hx), (ge.Hy, ge.Hx)
    return {"u": base, "v": base, "c": base, "eta": ext, "U": ext, "V": ext}


def compare_fields(state, ref, model, rtol, label):
    """max|a - b| / max|b| per field over the interior; raises past ``rtol``."""
    worst = 0.0
    for name, H in field_halos(model).items():
        a = interior(getattr(state, name), H).astype(np.float64)
        b = interior(getattr(ref, name), H).astype(np.float64)
        scale = max(float(np.max(np.abs(b))), 1e-30)
        err = float(np.max(np.abs(a - b))) / scale
        worst = max(worst, err)
        log(f"  {label} {name:3s} max|d|/max|ref| = {err:.3e}  (tol {rtol:.0e})")
        if not err <= rtol:
            raise AssertionError(f"{label}: field {name} differs by {err:.3e} > {rtol}")
    return worst


def check_invariants(model, state0, state, label):
    import jax

    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        if not bool(np.all(np.isfinite(np.asarray(leaf)))):
            raise AssertionError(f"{label}: non-finite values in {jax.tree_util.keystr(path)}")
    # each tracer inside its initial range (wet interior cells)
    g = model.grid
    H = (g.Hy, g.Hx)
    m = np.asarray(_mask_c(model))
    wet = interior(m.reshape((-1,) + m.shape[-2:]), H) > 0   # (nz or 1, y, x)
    c0 = interior(state0.c, H).reshape((-1,) + wet.shape)    # (tracers, nz or 1, y, x)
    c1 = interior(state.c, H).reshape((-1,) + wet.shape)
    ranges = []
    for a0, a1 in zip(c0, c1):
        lo, hi = a0[wet].min(), a0[wet].max()
        slack = TRACER_SLACK * (hi - lo)
        if a1[wet].min() < lo - slack or a1[wet].max() > hi + slack:
            raise AssertionError(f"{label}: tracer left [{lo}, {hi}]: now "
                                 f"[{a1[wet].min()}, {a1[wet].max()}]")
        ranges.append(f"[{a1[wet].min():.6g}, {a1[wet].max():.6g}] in "
                      f"[{lo:.6g}, {hi:.6g}] +- {slack:.2g}")
    # free-surface volume, with the fold's duplicated seam row at half weight
    # (models/diagnostics.py::seam_row_weights)
    ge = model.grid_ext
    az = interior(ge.az_cc, (ge.Hy, ge.Hx)).astype(np.float64)
    az[-1] *= 0.5
    eta = interior(state.eta, (ge.Hy, ge.Hx)).astype(np.float64)
    vol = abs(float(np.sum(eta * az))) / max(float(np.sum(np.abs(eta) * az)), 1e-30)
    log(f"  {label} all fields finite; tracer ranges ok ({'; '.join(ranges)}); "
        f"|sum(eta Az)|/sum(|eta| Az) = {vol:.2e} (tol {VOLUME_RTOL:.0e})")
    if not vol <= VOLUME_RTOL:
        raise AssertionError(f"{label}: free-surface volume drifted by {vol:.3e}")


def _mask_c(model):
    return model.mask_c3 if hasattr(model, "mask_c3") else model.ib.mask_c


def on_device(tree, dev, label):
    import jax

    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        if hasattr(leaf, "devices") and leaf.devices() != {dev}:
            raise AssertionError(f"{label}: {jax.tree_util.keystr(path)} is on "
                                 f"{leaf.devices()}, not {dev}")


def run_model(label, build, multi, dt, points):
    """Build on the GPU, compile, run, compare with the CPU, check, time."""
    import jax

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    from orthogonalsphericalshellgrids_tpu.grids import native

    t0 = time.perf_counter()
    model, state = build()
    jax.block_until_ready(state)
    log(f"[{label}] built in {time.perf_counter() - t0:.1f} s "
        f"(grid generator: {'native C++' if native.available() else 'numpy'})")
    on_device((model, state), gpu, label)
    # the CPU reference starts from host copies of the same arrays (the GPU state
    # is donated to the first block)
    model_c, state0 = jax.device_put(jax.device_get((model, state)), cpu)

    t0 = time.perf_counter()
    step = jax.jit(partial(multi, n_steps=BLOCK), donate_argnums=(1,))
    compiled = step.lower(model, state, dt).compile()
    log(f"[{label}] compiled in {time.perf_counter() - t0:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")

    s = state
    for _ in range(COMPARE_BLOCKS):
        s = compiled(model, s, dt)
    jax.block_until_ready(s)
    on_device(s, gpu, label)

    t0 = time.perf_counter()
    step_c = jax.jit(partial(multi, n_steps=BLOCK))
    ref = state0
    for _ in range(COMPARE_BLOCKS):
        ref = step_c(model_c, ref, dt)
    jax.block_until_ready(ref)
    log(f"[{label}] CPU reference ({COMPARE_BLOCKS * BLOCK} steps) in "
        f"{time.perf_counter() - t0:.1f} s")
    compare_fields(s, ref, model, FIELD_RTOL, label)
    check_invariants(model, state0, s, label)

    t0 = time.perf_counter()
    for _ in range(TIME_BLOCKS):
        s = compiled(model, s, dt)
    jax.block_until_ready(s)
    ms = (time.perf_counter() - t0) / (TIME_BLOCKS * BLOCK) * 1e3
    log(f"[{label}] steady {ms:.3f} ms/step = {points / ms * 1e3:.4g} grid-points/s "
        f"({gpu.device_kind}; {CARD}); peak_bytes_in_use = {peak_bytes(gpu)}")
    return model, s


def bickley():
    sys.path.insert(0, ROOT)
    from examples.bickley_jet import build
    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import multi_step

    return partial(build, nx=1440, ny=680, substeps=30), multi_step, 60.0, 1440 * 680


def gyre():
    sys.path.insert(0, ROOT)
    from examples.wind_driven_ts_gyre import build
    from orthogonalsphericalshellgrids_tpu.models.layered import layered_multi_step

    return (partial(build, nx=1440, ny=680, nz=10, substeps=30), layered_multi_step,
            40.0, 1440 * 680 * 10)


def baro_inputs(model, state, dt):
    """Filled (eta, U, V, GU, GV) as ``step`` hands them to the subcycle."""
    from orthogonalsphericalshellgrids_tpu.models import hydrostatic as H
    from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC

    g, ge = model.grid, model.grid_ext
    return (H._fill(ge, state.eta, CC, 1), H._fill(ge, state.U, FC, -1),
            H._fill(ge, state.V, CF, -1),
            H._fill(ge, H.embed_ext(g, ge, model.ib.h_u * state.Gu), FC, -1),
            H._fill(ge, H.embed_ext(g, ge, model.ib.h_v * state.Gv), CF, -1))


def kernel_vs_scan(model, state, dt=60.0, **kernel_kw):
    """One subcycle through the kernel and through the XLA scan, on the card;
    returns the worst field error on the extended interior."""
    import jax

    from orthogonalsphericalshellgrids_tpu.models import hydrostatic as H
    from orthogonalsphericalshellgrids_tpu.ops.baro_triton import (
        barotropic_substeps_triton)

    ge = model.grid_ext
    args = jax.jit(baro_inputs)(model, state, dt)
    out = jax.jit(lambda *a: barotropic_substeps_triton(
        *a, H.baro_statics(model), model.fractional_dt * dt, model.weights, model.g,
        **kernel_kw))(*args)
    ref = jax.jit(lambda *a: H.barotropic_substeps_xla(
        model, *a, dt, wrap_x_each_substep=False))(*args)
    worst = 0.0
    for name, a, b in zip(("eta_avg", "U_avg", "V_avg"), out, ref):
        a = interior(a, (ge.Hy, ge.Hx)).astype(np.float64)
        b = interior(b, (ge.Hy, ge.Hx)).astype(np.float64)
        err = float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-30)
        worst = max(worst, err)
        log(f"  kernel-vs-scan {name} at {ge.Ny + 2 * ge.Hy} x {ge.Nx + 2 * ge.Hx} x "
            f"{int(model.weights.shape[0])} substeps: max|d|/max|ref| = {err:.3e} "
            f"(tol {KERNEL_RTOL:.0e})")
    return worst


def step_with(model, state, multi, dt, impl):
    """The compiled BLOCK-step function whose subcycle is ``impl``: "kernel" is the
    model's own lowering (the kernel on a GPU), "xla" forces the scan."""
    import contextlib
    from unittest import mock

    import jax

    from orthogonalsphericalshellgrids_tpu.models import hydrostatic as H

    f = jax.jit(partial(multi, n_steps=BLOCK), donate_argnums=(1,))
    ctx = (mock.patch.object(H, "barotropic_substeps", H.barotropic_substeps_xla)
           if impl == "xla" else contextlib.nullcontext())
    with ctx:
        return f.lower(model, state, dt).compile()


def time_in_turns(model, state, multi, dt, fns, order, blocks=TIME_BLOCKS):
    """ms/step of each named step function, timed in the given order."""
    import jax

    s = state
    for f in fns.values():  # compile and warm each
        s = jax.block_until_ready(f(model, s, dt))
    times = {k: [] for k in fns}
    for name in order:
        t0 = time.perf_counter()
        for _ in range(blocks):
            s = fns[name](model, s, dt)
        jax.block_until_ready(s)
        times[name].append((time.perf_counter() - t0) / (blocks * BLOCK) * 1e3)
    return times, s


def baro_phase(model, state):
    """The barotropic kernel at the Bickley shape: compare once with the scan,
    then time the full step with each, in turns (xla, kernel, kernel, xla)."""
    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import multi_step

    err = kernel_vs_scan(model, state)
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"barotropic kernel differs from the scan by {err:.3e}")
    fns = {impl: step_with(model, state, multi_step, 60.0, impl)
           for impl in ("xla", "kernel")}
    times, state = time_in_turns(model, state, multi_step, 60.0, fns,
                                 ["xla", "kernel", "kernel", "xla"])
    for name, ts in times.items():
        log(f"[baro] full Bickley step with the {name:6s} subcycle: "
            + ", ".join(f"{t:.3f}" for t in ts) + " ms/step")
    return times


# -------------------------------------------------------------------------------------
# Four cards: the sharded paths against the serial step on card 0
# -------------------------------------------------------------------------------------

SHARDED_STEPS = 10
# Sharded against serial on the same card type: the same operations on the same
# data (bitwise equal in float64 on the CPU, tests/test_distributed*.py), but the
# shards' fusions (and the overlap split's strip recompute) may contract FMAs
# differently from the serial step's, within float32's rounding band as for
# FIELD_RTOL.
SHARDED_RTOL = FIELD_RTOL


def four_card_phase(bickley_spec=None, gyre_spec=None):
    """The 1-D and 2-D sharded Bickley steps and the 1-D sharded gyre step on four
    devices, each against the serial step on device 0 (the models of ``bickley()``
    and ``gyre()`` unless other (build, multi_step, dt, points) specs are given)."""
    import jax

    from orthogonalsphericalshellgrids_tpu.parallel import (
        distribute, distribute_layered, gather_layered_state, gather_state, make_mesh,
        sharded_layered_step_fn, sharded_step_fn)
    from orthogonalsphericalshellgrids_tpu.parallel.distributed2d import (
        distribute2d, gather_state2d, make_mesh2d, sharded_step_fn2d)
    from orthogonalsphericalshellgrids_tpu.models.hydrostatic import step
    from orthogonalsphericalshellgrids_tpu.models.layered import layered_step

    devs = jax.devices()[:4]

    def serial(model, state, fn, dt):
        f = jax.jit(fn)
        s = state
        for _ in range(SHARDED_STEPS):
            s = f(model, s, dt)
        return jax.block_until_ready(s)

    def sharded(fn, dist_state, dt):
        s = dist_state
        for _ in range(SHARDED_STEPS):
            s = fn(s, dt)
        s = jax.block_until_ready(s)
        leaves = [x for x in jax.tree_util.tree_leaves(s) if getattr(x, "ndim", 0) >= 2]
        for leaf in leaves:
            if len(leaf.devices()) != 4:
                raise AssertionError(f"a state leaf lives on {leaf.devices()} only")
        return s

    def report(label):
        log(f"  {label} peak_bytes_in_use per device: "
            + ", ".join(str(peak_bytes(d)) for d in devs))

    build_b, _, dt_b, _ = bickley_spec or bickley()
    model, state = build_b()
    ref = serial(model, state, step, dt_b)

    mesh = make_mesh(4)
    dm, ds = distribute(model, state, mesh)
    got = gather_state(sharded(sharded_step_fn(mesh, dm), ds, dt_b), model, 4)
    compare_fields(got, ref, model, SHARDED_RTOL, "bickley 1-D y mesh (4)")
    report("bickley 1-D")

    mesh2 = make_mesh2d(2, 2)
    dm, ds = distribute2d(model, state, mesh2)
    got = gather_state2d(sharded(sharded_step_fn2d(mesh2, dm, model.grid.Nx), ds, dt_b),
                         model, mesh2)
    compare_fields(got, ref, model, SHARDED_RTOL, "bickley 2-D (2 x 2) mesh")
    report("bickley 2-D")
    del dm, ds, got, ref, model, state

    build_g, _, dt_g, _ = gyre_spec or gyre()
    model, state = build_g()
    ref = serial(model, state, layered_step, dt_g)
    dm, ds = distribute_layered(model, state, mesh)
    got = gather_layered_state(sharded(sharded_layered_step_fn(mesh, dm), ds, dt_g),
                               model, 4)
    compare_fields(got, ref, model, SHARDED_RTOL, "gyre 1-D y mesh (4)")
    report("gyre 1-D")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded paths on four cards")
    args = p.parse_args(argv)
    n = 4 if args.four else 1
    devs = require_gpus(n)
    sys.path.insert(0, ROOT)
    global CARD
    CARD = card_info()
    log(CARD)
    d = devs[0]
    log(f"jax {__import__('jax').__version__}: platform={d.platform} "
        f"device_kind={d.device_kind} count={n}")
    if args.four:
        four_card_phase()
    else:
        b_model, b_state = run_model("bickley", *bickley())
        baro_phase(b_model, b_state)
        del b_model, b_state
        run_model("gyre", *gyre())
    print(json.dumps({"ok": True, "device": {"platform": d.platform,
                                             "kind": d.device_kind, "count": n}}),
          flush=True)


if __name__ == "__main__":
    main()
