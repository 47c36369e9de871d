"""``port_gap_share``: the share of the traced window in which the card was
idle while the host was inside one of the port's own spans (``smm.*``,
:mod:`smmbench.spans`), in %: ``idle_share`` less the harness's gaps."""

from smmbench import spans


def read(ctx):
    r = spans.of(ctx)
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * r.port_idle_s / r.window_s
