"""``host_syncs_per_call``: the host's waits on the card inside a call
(``tracing.WAITS`` runtime calls in the profiler's CPU trace, inside the
call's span, its closing synchronisation left out), over the traced calls."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls:
        return None
    return t.host_waits / t.calls
