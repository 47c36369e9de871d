"""``esc_partials_per_s``: the product's partial products (each entry
(i, k) of A times row k of B, counted once from the structure) of every
traced call over the seconds the device was busy."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.partials or t.busy_s <= 0:
        return None
    return ctx.partials * t.calls / t.busy_s
