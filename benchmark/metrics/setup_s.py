"""setup_s: from the start of the process to the start of the window:
imports, the solver's build (and the kernel's nvcc build in a checkout's
first run), the pool's draw and the warm-up requests."""


def read(ctx):
    return ctx.setup_s
