"""Per-point work of one upwind WENO-5 reconstruction, and its XLA-fused rate.

1. **Analytic flop count**: walk ``ops/advection.py::_weno5_left`` op by op and
   count flops under explicit assumptions (listed below). Divided by a measured
   kernel time, it gives the reconstruction's achieved FLOP/s.
2. **XLA-fused rate**: the same reconstruction on rolled taps, scanned on the
   device and timed with ``block_until_ready`` — reconstruction-points/s of the
   plain XLA path at one shape.

Run: ``python benchmarks/weno_sol.py`` (prints the table, then the rate on the
default device).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from orthogonalsphericalshellgrids_tpu.ops.advection import _weno5_left


# ---------------------------------------------------------------------------------
# 1. Analytic flop accounting for ONE upwind WENO-5 reconstruction
# ---------------------------------------------------------------------------------
# Assumptions (stated so the count is checkable):
#   - every elementwise add/sub/mul = 1 flop; a fused multiply-add = 2 flops;
#   - divide = 1 flop; abs, select and stencil shifts = 0 flops;
#   - multiplies by literal constants count like any multiply; x**2 = 1 multiply.

# (name, flops) per point, derived from ops/advection.py::_weno5_left read
# top to bottom:
ANALYTIC = [
    # q0 = (2 m3 - 7 m2 + 11 m1) * (1/6): mul, fma, fma, mul
    ("q0", 6),
    # q1 = (-m2 + 5 m1 + 2 p0) * (1/6): fma(5*m1 - m2), fma(2*p0 + t), mul
    ("q1", 5),
    # q2 = (2 m1 + 5 p0 - p1) * (1/6): mul(2*m1), fma(5*p0 + t), sub(p1), mul(1/6)
    ("q2", 5),
    # b0 = 13/12*(m3-2m2+m1)^2 + 1/4*(m3-4m2+3m1)^2:
    #   t1 = fma(-2*m2 + m3) ; add(+m1)            -> 3 flops
    #   t2 = fma(-4*m2 + m3) ; fma(3*m1 + t)       -> 4 flops
    #   sq1 = mul ; sq2 = mul                      -> 2 flops
    #   b0 = mul(13/12*sq1) ; fma(1/4*sq2 + t)     -> 3 flops
    ("b0", 12),
    # b1 = 13/12*(m2-2m1+p0)^2 + 1/4*(m2-p0)^2: t1 fma+add (3), d sub (1),
    #   2 squares (2), mul+fma (3)
    ("b1", 9),
    ("b2", 12),                       # same shape as b0
    ("tau = |b0 - b2|", 1),           # sub + abs
    # a_k = w_k * (1 + (tau/(b_k+eps))^2), k=0,1,2:
    #   add(eps) 1; div 1; square 1; fma(w_k*r2 + w_k) counted as 1 -> 4 flops
    ("a0", 4),
    ("a1", 4),
    ("a2", 4),
    ("s = a0+a1+a2", 2),
    ("num = a0 q0 + a1 q1 + a2 q2", 5),   # mul, fma, fma
    ("num / s", 1),
    # stencil taps: 4 shifts (m1..m3, p1; p0 is the array itself) and the upwind
    # input-select (vel>=0 ? biased-left-taps : biased-right-taps): 5 selects on
    # the 5 taps + 1 compare (weno5_upwind_faces_from_centers)
    ("4 stencil rolls", 0),
    ("upwind input select (cmp + 5 sel)", 0),
]


def analytic_table():
    rows = list(ANALYTIC)
    return rows, sum(f for _, f in rows)


def xla_fused_rate(n_scan=80, W=1024, Xe=1536, dtype=jnp.float32, repeats=3):
    """Reconstruction-points/s of ``_weno5_left`` on rolled taps, XLA-fused and
    scanned ``n_scan`` times on the default device (best of ``repeats``)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((W, Xe)), dtype)

    def body(c, _):
        m1 = jnp.roll(c, 1, 1)
        m2 = jnp.roll(c, 2, 1)
        m3 = jnp.roll(c, 3, 1)
        p1 = jnp.roll(c, -1, 1)
        r = _weno5_left(m3, m2, m1, c, p1)
        # keep the iterate bounded so the work cannot be elided
        return r - 0.5 * jnp.sign(r) * jnp.abs(r) * 1e-3, None

    run = jax.jit(lambda c: jax.lax.scan(body, c, None, length=n_scan)[0])
    x = jax.block_until_ready(run(x))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        x = jax.block_until_ready(run(x))
        best = min(best, time.perf_counter() - t0)
    return W * Xe * n_scan / best


if __name__ == "__main__":
    rows, F = analytic_table()
    print("analytic per-point count (one upwind WENO-5 reconstruction):")
    for n, f in rows:
        print(f"  {n:38s} flops={f:3d}")
    print(f"  TOTAL flops={F}")
    d = jax.devices()[0]
    rate = xla_fused_rate()
    print(f"XLA-fused on {d.platform} ({d.device_kind}): {rate / 1e9:.2f} G recon-pts/s "
          f"= {rate * F / 1e12:.3f} TFLOP/s")
