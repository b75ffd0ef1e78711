"""Seconds of the configuration's build (grid, masks, model arrays, initial state),
host clock."""


def read(ctx):
    return ctx.setup.get("build_s")
