"""Share of the traced window in which no operation ran on the card, in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["window_s"]:
        return None
    return (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"]) * 100.0
