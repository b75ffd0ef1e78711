"""The whole step's share of the card's peak: the least time the step's algorithmic
flops or bytes (perf/counts/<config>.py) take at the published peak, over the
measured wall time per step of the window, in %."""


def read(ctx):
    if not ctx.window["steps"]:
        return None
    work = ctx.counts.step(ctx.cfg)
    least = max(work["flops"] / ctx.peak[ctx.dtype + "_flops"],
                work["bytes"] / ctx.peak["hbm_bytes_per_s"])
    return least / (ctx.window["seconds"] / ctx.window["steps"]) * 100.0
