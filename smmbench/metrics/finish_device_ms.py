"""``finish_device_ms``: the device time of the operations launched inside
the port's ``smm.finish`` span (the dense routes' work after the product:
the triangle, the cast, the triple's mirror; :mod:`smmbench.spans`), per
traced call, in ms."""

from smmbench import spans


def read(ctx):
    r = spans.of(ctx)
    finish = r.spans.get("smm.finish") if r is not None else None
    if finish is None or not r.calls:
        return None
    return 1e3 * finish.device_s / r.calls
