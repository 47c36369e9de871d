"""``setup_s``: seconds from the process's start to the window's first
call: imports, the card's context, the kernels' build or load, the
operands drawn from the seed, the sizes worked out, and the warm-up."""


def read(ctx):
    return ctx.setup_s
