"""The barotropic kernel's share of its roofline: the least time its algorithmic
flops or bytes (perf/counts/<config>.py ``baro``) take at the published peak, over
its device time per step in the trace, in %."""

KERNEL = "barotropic_substeps"


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps or KERNEL not in ctx.trace["ops"]:
        return None
    work = ctx.counts.baro(ctx.cfg)
    least = max(work["flops"] / ctx.peak[ctx.dtype + "_flops"],
                work["bytes"] / ctx.peak["hbm_bytes_per_s"])
    return least / (ctx.trace["ops"][KERNEL] / ctx.traced_steps) * 100.0
