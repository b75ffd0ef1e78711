"""Algorithmic work of one ``gyre_q_z10`` step (see counts/bickley_q.py for the
rules): flops per interior point of each layer per term, per interior column for the
barotropic subcycle, and the bytes of each field read and written once and each
static operand read once."""

WORD = 4  # float32

LAYER_FLOPS = {
    "vorticity and Coriolis": 7,
    "advecting velocities": 12,
    "vorticity WENO-5 at u and v": 2 * 70,
    "kinetic energy": 8,
    "momentum tendencies": 8,
    "continuity w": 10,
    "vertical momentum advection": 14,
    "linear EOS, hydrostatic pressure and its gradient": 18,
    "vertical viscosity": 16,
    "quadratic bottom drag": 26,
    "horizontal viscosity": 28,
    "masking": 2,
    "tracers T and S: WENO-5 x, y, fluxes, centered z, vertical and horizontal diffusion": 2 * 179,
    "AB2 extrapolation": 12,
    "depth integrals of the forcing": 4,
    "predictor and depth-mean corrector": 10,
    "tracer update": 6,
}
SUBSTEP_FLOPS = 28

PROGNOSTIC_3D = ["u", "v", "T", "S", "Gu", "Gv", "GT", "GS"]
STATIC_3D = ["mask_c", "mask_u", "mask_v", "bot_u", "bot_v"]
PROGNOSTIC_2D = ["eta", "U", "V"]
STATIC_2D = ["dx_fc", "dy_cf", "dx_cf", "dy_fc", "dx_cc", "dy_cc", "dx_ff", "dy_ff",
             "az_cc", "az_fc", "az_cf", "az_ff", "f_ff", "taux", "inv_h_u", "inv_h_v"]
BARO_IN = ["eta", "U", "V", "GU", "GV"]
BARO_STATIC = ["dy_fc", "dx_cf", "inv_az_cc", "h_u", "inv_dx_fc", "h_v", "inv_dy_cf",
               "mask_u", "mask_v"]
BARO_OUT = ["eta_avg", "U_avg", "V_avg"]


def _shape(cfg):
    b = cfg["build"]
    return b["nx"] * b["ny"], b["nz"]


def _substeps(cfg):
    from refcore import averaging_weights

    return len(averaging_weights(cfg["build"]["substeps"])[1])


def baro(cfg):
    n, _ = _shape(cfg)
    return {"flops": SUBSTEP_FLOPS * _substeps(cfg) * n,
            "bytes": WORD * n * (len(BARO_IN) + len(BARO_STATIC) + len(BARO_OUT))}


def step(cfg):
    n, nz = _shape(cfg)
    flops = sum(LAYER_FLOPS.values()) * n * nz + baro(cfg)["flops"]
    planes = (nz * (2 * len(PROGNOSTIC_3D) + len(STATIC_3D))
              + 2 * len(PROGNOSTIC_2D) + len(STATIC_2D) + len(BARO_STATIC))
    return {"flops": flops, "bytes": WORD * n * planes}
