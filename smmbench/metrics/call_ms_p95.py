"""``call_ms_p95``: the 95th percentile of the window's call times (host
clock around the call and its synchronisation), in milliseconds, with
numpy's linear interpolation between order statistics."""

import numpy as np


def read(ctx):
    if not ctx.call_s:
        return None
    return float(np.percentile(np.asarray(ctx.call_s, dtype=np.float64), 95)) * 1e3
