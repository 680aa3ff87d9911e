"""setup_s: seconds from the process's start to the window's opening
(kernels built or loaded, weights and inputs made, shapes warmed)."""


def read(ctx):
    return ctx.setup_s
