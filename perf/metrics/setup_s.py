"""Seconds from the harness's start until the window opens: JAX and the card,
build, compilation or cache load, and the compared first steps."""


def read(ctx):
    return ctx.setup["setup_s"]
