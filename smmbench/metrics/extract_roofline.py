"""``extract_roofline``: the least time of the extraction's work (the dense
answer, or its triangle, read once and its CSR written once, at the memory
rate) over the device time of the kernels that the cell's kernel map puts
in the ``extract`` stage (count, scan, fill), in %."""

from smmbench import work


def read(ctx):
    t = ctx.trace
    w = (ctx.work or {}).get("extract")
    if t is None or w is None or not t.stage_s.get("extract"):
        return None
    return 100.0 * work.least_seconds(w) * t.calls / t.stage_s["extract"]
