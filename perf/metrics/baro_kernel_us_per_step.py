"""Device microseconds per step of the barotropic subcycle kernel: the trace events
named ``barotropic_substeps`` (every launch), summed over the traced window, per
step traced."""

KERNEL = "barotropic_substeps"


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps or KERNEL not in ctx.trace["ops"]:
        return None
    return ctx.trace["ops"][KERNEL] / ctx.traced_steps * 1e6
