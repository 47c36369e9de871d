"""``entries_per_s``: the entries of every answer of the window over the
window's seconds, each call's seconds the host clock around the call and
its synchronisation.  A CSR answer counts its stored entries, a dense one
its m n."""


def read(ctx):
    if not ctx.call_s:
        return None
    return sum(ctx.entries) / sum(ctx.call_s)
