"""Seconds JAX spent tracing, lowering and compiling (or loading from its persistent
cache) in set-up, from its compile events; host clock."""


def read(ctx):
    return ctx.setup.get("compile_s")
