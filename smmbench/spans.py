"""The port's own spans in a traced window: which of its layers launched
each device operation, and under which the card sat idle.

The port opens a ``torch.profiler`` range at each layer boundary of its
device-resident path (``sparse_matrix_mult_tpu_torch.utils.profiling.span``):
``smm.multiply`` or ``smm.triple_product`` around the call and, inside it,
``smm.densify``, ``smm.gemm``, ``smm.finish``, ``smm.extract``,
``smm.esc.expand``, ``smm.esc.sort``, ``smm.esc.compress``, and
``smm.sync.<site>`` around each host sync.  :func:`read` takes the events of
:func:`.tracing.events` over the steps :func:`.tracing.read` reads (all but
the first) and gives, per span name: its calls, host seconds, host self
seconds (the span less its child spans), the device seconds of the
operations launched inside it and in no deeper span (the runtime call with
the operation's correlation id, as :func:`.tracing.read` gives operations to
steps), and the idle seconds under it (each idle interval of a step, its
operations first moved back inside the step as :func:`.tracing.read` moves
them, goes to the innermost span open at its middle, or to the harness
where none is).  The card's clock is never compared with the host's.

A program that opens none of these spans reads as None.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys

from . import tracing

PREFIX = "smm."
SYNC = "smm.sync."
ENTRIES = ("smm.multiply", "smm.triple_product")


@dataclasses.dataclass
class Span:
    calls: int = 0
    host_s: float = 0.0
    self_s: float = 0.0      # host seconds less the child spans'
    device_s: float = 0.0    # operations launched in this span and in no deeper one
    idle_s: float = 0.0      # idle intervals whose middle lies in it and in no deeper one


@dataclasses.dataclass
class Reading:
    calls: int               # the steps read
    window_s: float          # their seconds
    spans: dict              # name -> Span
    harness_idle_s: float    # idle seconds under no span of the port
    outside_s: float         # device seconds launched inside a call but under no span of the port
    call_device_s: float     # device seconds launched inside the calls

    @property
    def port_idle_s(self) -> float:
        return sum(s.idle_s for s in self.spans.values())

    @property
    def syncs(self) -> int:
        return sum(s.calls for name, s in self.spans.items() if name.startswith(SYNC))


class _Nest:
    """The port's spans, nested by time (one host thread opens them all)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.parent, self.children_s, open_ = [], [0.0] * len(self.spans), []
        for i, (s, e, _) in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][1] <= s:
                open_.pop()
            up = open_[-1] if open_ else None
            if up is not None:
                self.children_s[up] += min(e, self.spans[up][1]) - s
            self.parent.append(up)
            open_.append(i)

    def at(self, t: float) -> str | None:
        """The name of the innermost span open at ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            if self.spans[i][1] >= t:
                return self.spans[i][2]
            i = self.parent[i]
        return None


def read(device, host, skip_steps: int = 1) -> Reading | None:
    """The port's spans over the steps after the first ``skip_steps``, from
    :func:`.tracing.events`' lists; None when no step, or no entry span of
    the port, lies there."""
    steps = sorted((s, e) for s, e, n in host if n == tracing.STEP)[skip_steps:]
    if not steps:
        return None
    starts = [s for s, _ in steps]

    def step_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t < steps[i][1] else None

    nest = _Nest([(s, e, n) for s, e, n in host
                  if n.startswith(PREFIX) and step_of(s) is not None])
    if not any(n in ENTRIES for _, _, n in nest.spans):
        return None
    table = {}
    for (s, e, name), children_s in zip(nest.spans, nest.children_s):
        span = table.setdefault(name, Span())
        span.calls += 1
        span.host_s += (e - s) / 1e6
        span.self_s += (e - s - children_s) / 1e6
    calls = sorted((s, e) for s, e, n in host if n == tracing.CALL and step_of(s) is not None)
    call_starts = [s for s, _ in calls]

    def in_call(t):
        i = bisect.bisect_right(call_starts, t) - 1
        return i >= 0 and t < calls[i][1]

    by_step = [[] for _ in steps]
    outside_s = call_device_s = 0.0
    for s, e, _, launch in device:
        t = s if launch is None else launch
        i = step_of(t)
        if i is None:
            continue
        by_step[i].append((s, e))
        sec = (e - s) / 1e6
        name = nest.at(t)
        if name is not None:
            table[name].device_s += sec
        if in_call(t):
            call_device_s += sec
            outside_s += sec if name is None else 0.0
    harness_idle_s = 0.0
    for (lo, hi), ops in zip(steps, by_step):
        first = min((s for s, _ in ops), default=lo)
        last = max((e for _, e in ops), default=hi)
        shift = lo - first if first < lo else min(0, hi - last)
        gaps, t = [], lo
        for s, e in tracing._union((max(s + shift, lo), min(e + shift, hi)) for s, e in ops):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        for a, b in gaps:
            name = nest.at((a + b) / 2)
            if name is None:
                harness_idle_s += (b - a) / 1e6
            else:
                table[name].idle_s += (b - a) / 1e6
    return Reading(calls=len(steps), window_s=sum(e - s for s, e in steps) / 1e6, spans=table,
                   harness_idle_s=harness_idle_s, outside_s=outside_s,
                   call_device_s=call_device_s)


def lines(r: Reading) -> list:
    """The span table, one line per span, in ms per traced call."""
    per = 1e3 / r.calls
    out = [f"span {name}: {s.calls / r.calls!r} a call, host {s.host_s * per:.6f} ms, "
           f"self {s.self_s * per:.6f} ms, device {s.device_s * per:.6f} ms, "
           f"idle {s.idle_s * per:.6f} ms" for name, s in sorted(r.spans.items())]
    out.append(f"span (harness): idle {r.harness_idle_s * per:.6f} ms")
    out.append(f"span (none, inside the call): device {r.outside_s * per:.6f} ms of "
               f"{r.call_device_s * per:.6f} ms launched in the call")
    return out


def _profiler(ctx):
    """The profiler of the run that made ``ctx``: the harness's ``run``,
    which calls the readers, holds it as its local ``profiler`` beside
    ``ctx`` (it hands the readers the trace's reading, not its events)."""
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if local.get("ctx") is ctx and "profiler" in local:
            return local["profiler"]
        frame = frame.f_back
    return None


def of(ctx, log=None) -> Reading | None:
    """The run's reading, made once and kept as ``ctx.spans``, its table
    printed on ``log`` (standard error): None untraced, or where the
    program opens none of the port's spans."""
    if not hasattr(ctx, "spans"):
        profiler = _profiler(ctx)
        ctx.spans = None if profiler is None else read(*tracing.events(profiler))
        if ctx.spans is not None:
            for line in lines(ctx.spans):
                print(f"[{__package__}] {line}", file=log or sys.stderr)
    return ctx.spans
