"""setup_s: seconds from the process's start to the window's start: imports,
weights made on the card, the program's loaders, kernels loaded or built,
warm-up (and for serving the schedule's lead before the window)."""


def read(ctx):
    return ctx.setup_s
