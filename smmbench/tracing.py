"""A ``torch.profiler`` trace of the traced window, read as the device's time.

The harness wraps each timed call and its synchronisation in the span
``STEP`` and the call alone in ``CALL``.  :func:`read` gives each device
operation to the step in which the host launched it (the runtime call
with the operation's correlation id), so a shift between the card's clock
and the host's moves no operation out of its step; it reads their union
(busy seconds) over the steps' seconds (the window), their time by stage
through the cell's kernel map, the operations that took most time, the
idle time by what the host was doing, and the host's waits on the card
inside the calls.
"""

from __future__ import annotations

import bisect
import dataclasses

STEP, CALL = "smmbench.step", "smmbench.call"
# Runtime calls in which the host waits for the card.
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
         "cudaMemcpy2D")
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def short_name(name: str) -> str:
    """``void (anonymous namespace)::fill_rows<float, true>(float const*, ...)``
    -> ``fill_rows<float, true>``."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip()


def base_name(name: str) -> str:
    """The kernel's name without namespaces and template arguments: ``fill_rows``."""
    return short_name(name).split("<")[0].split("::")[-1]


def events(prof):
    """(device operations, host events): host events as (start_us, end_us,
    name); device operations as (start_us, end_us, name, launch_us), the
    last the host time of the runtime call that launched it (None where
    the trace holds none)."""
    from torch.autograd import DeviceType

    device, host, launches = [], [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device.append((e.time_range.start, e.time_range.end, e.name, e.id))
        elif e.device_type == DeviceType.CPU:
            host.append((e.time_range.start, e.time_range.end, e.name))
            if e.name.startswith("cu"):
                launches[e.id] = e.time_range.start
    return [(s, e, n, launches.get(i)) for s, e, n, i in device], host


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


@dataclasses.dataclass
class Reading:
    calls: int
    window_s: float
    busy_s: float
    stage_s: dict        # stage -> device seconds of its kernels
    unknown_s: dict      # kernel the map does not know -> device seconds
    device_ops: list     # [(short name, seconds)], most first
    idle_gaps: list      # [(what the host was doing, idle seconds)], most first
    host_waits: int      # WAITS inside the calls


class _Host:
    """The innermost host event at an instant."""

    def __init__(self, host):
        self.events = sorted(host)
        self.starts = [s for s, _, _ in self.events]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 512, -1), -1):
            s, e, name = self.events[j]
            if e >= t and name != STEP:
                return name
        return "python"


def read(device, host, kernel_map: dict, skip_steps: int = 1, top: int = 10) -> Reading | None:
    """The trace's reading over its steps after the first ``skip_steps`` (the
    profiler's first step opens with a gap of milliseconds before its first
    kernel, which would read as idle); None when no device operation ran
    inside them."""
    steps = sorted((s, e) for s, e, n in host if n == STEP)[skip_steps:]
    if not steps:
        return None
    calls = [(s, e) for s, e, n in host if n == CALL and s >= steps[0][0]]
    stage_of = {k: stage for stage, kernels in kernel_map.items() for k in kernels}
    starts = [s for s, _ in steps]
    by_step = [[] for _ in steps]
    for s, e, name, launch in device:
        i = bisect.bisect_right(starts, s if launch is None else launch) - 1
        if i >= 0 and (s if launch is None else launch) < steps[i][1]:
            by_step[i].append((s, e, name))
    inside = [op for ops in by_step for op in ops]
    if not inside:
        return None
    busy_s = sum(e - s for ops in by_step for s, e in _union((s, e) for s, e, _ in ops)) / 1e6
    by_name, stage_s, unknown = {}, {}, {}
    for s, e, name in inside:
        sec = (e - s) / 1e6
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + sec
        if name.startswith(_NOT_KERNELS):
            continue
        stage = stage_of.get(base_name(name))
        if stage is None:
            unknown[base_name(name)] = unknown.get(base_name(name), 0.0) + sec
        else:
            stage_s[stage] = stage_s.get(stage, 0.0) + sec
    # Idle gaps by the host event at their middle.  Where the card's clock
    # puts a step's operations partly outside the step, they are moved
    # back inside it first, so the gaps add up to the idle time.
    host_at, gaps = _Host(host), {}
    for (lo, hi), ops in zip(steps, by_step):
        first = min((s for s, _, _ in ops), default=lo)
        last = max((e for _, e, _ in ops), default=hi)
        shift = lo - first if first < lo else min(0, hi - last)
        t = lo
        for s, e in _union((max(s + shift, lo), min(e + shift, hi)) for s, e, _ in ops):
            if s > t:
                what = host_at.at((t + s) / 2)
                gaps[what] = gaps.get(what, 0.0) + (s - t) / 1e6
            t = max(t, e)
        if hi > t:
            what = host_at.at((t + hi) / 2)
            gaps[what] = gaps.get(what, 0.0) + (hi - t) / 1e6
    calls.sort()
    call_starts = [s for s, _ in calls]

    def in_call(t):
        i = bisect.bisect_right(call_starts, t) - 1
        return i >= 0 and t < calls[i][1]
    waits = sum(1 for s, _, n in host if n in WAITS and in_call(s))
    return Reading(
        calls=len(steps), window_s=sum(e - s for s, e in steps) / 1e6,
        busy_s=busy_s, stage_s=stage_s, unknown_s=unknown,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top], host_waits=waits)
