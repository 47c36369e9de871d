"""``peak_device_gib``: ``torch.cuda.max_memory_allocated()`` over one warm
call after ``reset_peak_memory_stats()``, operands resident, in GiB."""


def read(ctx):
    return ctx.peak_call_bytes / 2**30 if ctx.peak_call_bytes else None
