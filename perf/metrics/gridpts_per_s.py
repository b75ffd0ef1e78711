"""Grid points advanced per second: Nx * Ny * Nz times the steps completed in the
window, over the window's wall seconds (host clock; the window ends when the card
has finished its work)."""


def read(ctx):
    return ctx.points * ctx.window["steps"] / ctx.window["seconds"]
