"""``port_syncs_per_call``: the host syncs the port names at their sites
(its ``smm.sync.<site>`` spans, :mod:`smmbench.spans`), over the traced
calls."""

from smmbench import spans


def read(ctx):
    r = spans.of(ctx)
    if r is None or not r.calls:
        return None
    return r.syncs / r.calls
