"""Milliseconds per step spent in the simulation loop's callbacks (wizard, progress,
NaN check, output), from the harness's spans around each over the measured window."""

CALLBACKS = ("wizard", "progress", "nan_check", "output")


def read(ctx):
    spans = [s for s in ctx.window_spans if s[0] in CALLBACKS]
    if not spans or not ctx.window["steps"]:
        return None
    return sum(e - s for _, s, e in spans) / ctx.window["steps"] * 1e3
