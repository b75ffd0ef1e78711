"""Algorithmic work of one ``bickley_q`` step, from the formulation and not from any
implementation: floating-point operations per interior point per term, and the bytes
the step must move at the least (each prognostic field read and written once, each
static operand read once). Halo cells, recomputation and intermediate arrays are
the implementation's and are not counted, so a share of the peak stays a lower
bound that no implementation can push past 100%."""

WORD = 4  # float32

# flops per interior point; one WENO-5 reconstruction is 70, counted op by op as in
# benchmarks/weno_sol.py: candidates 16, smoothness indicators 33, tau 1, Z-weights
# 12, their sum 2, the weighted sum and its normalisation 6
STEP_FLOPS = {
    "vorticity": 6,                  # two metric products, two differences, one more, 1/Az
    "advecting velocities": 12,      # v_hat, u_hat: metric product, two averages, 1/dx
    "vorticity WENO-5 at u and v": 2 * 70,
    "kinetic energy": 8,
    "momentum tendencies": 10,       # q v_hat - dK/dx, masked; same for v
    "tracer WENO-5 in x and y": 2 * 70,
    "tracer fluxes and divergence": 11,
    "AB2 extrapolation and forcing": 14,  # three fields, h_u / h_v weighting, c update
    "corrector": 4,
}
SUBSTEP_FLOPS = 28   # divergence 6, eta 2, U 7, V 7, three weighted averages 6

# planes the step reads and writes once
PROGNOSTIC = ["u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc"]
STATIC = ["dx_fc", "dy_cf", "dx_cf", "dy_fc", "inv_dx_fc", "inv_dy_cf", "inv_az_ff",
          "inv_vol_c", "h_u", "h_v", "mask_u", "mask_v", "mask_c", "inv_h_u", "inv_h_v"]
# the subcycle's planes: inputs, statics (its kernel's operands), outputs
BARO_IN = ["eta", "U", "V", "GU", "GV"]
BARO_STATIC = ["dy_fc", "dx_cf", "inv_az_cc", "h_u", "inv_dx_fc", "h_v", "inv_dy_cf",
               "mask_u", "mask_v"]
BARO_OUT = ["eta_avg", "U_avg", "V_avg"]


def _points(cfg):
    b = cfg["build"]
    return b["nx"] * b["ny"]


def _substeps(cfg):
    from refcore import averaging_weights

    return len(averaging_weights(cfg["build"]["substeps"])[1])


def baro(cfg):
    n = _points(cfg)
    return {"flops": SUBSTEP_FLOPS * _substeps(cfg) * n,
            "bytes": WORD * n * (len(BARO_IN) + len(BARO_STATIC) + len(BARO_OUT))}


def step(cfg):
    n = _points(cfg)
    flops = sum(STEP_FLOPS.values()) * n + baro(cfg)["flops"]
    planes = 2 * len(PROGNOSTIC) + len(STATIC) + len(BARO_STATIC)
    return {"flops": flops, "bytes": WORD * n * planes}
