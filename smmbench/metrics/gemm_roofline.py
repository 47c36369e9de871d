"""``gemm_roofline``: the least time of the dense products' work (one bf16
pass of the f32 products: 2 m n k operations, half for a triangle, both
products of a triple) over the device time of the kernels that the cell's
kernel map puts in the ``gemm`` stage (the splits and the GEMMs), in %."""

from smmbench import work


def read(ctx):
    t = ctx.trace
    w = (ctx.work or {}).get("gemm")
    if t is None or w is None or not t.stage_s.get("gemm"):
        return None
    return 100.0 * work.least_seconds(w) * t.calls / t.stage_s["gemm"]
