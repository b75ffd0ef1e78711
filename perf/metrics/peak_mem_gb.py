"""The card's peak bytes in use after the window, in GB (1e9 bytes)."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
