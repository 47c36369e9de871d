"""Timing and profiling helpers.

Counterpart of :mod:`sparse_matrix_mult_tpu.utils.profiling`: the same
``time_execution``, ``Timer`` and ``device_trace``.  Where JAX waits with
``block_until_ready``, :func:`time_execution` synchronizes every CUDA device
that holds a tensor of the result; :func:`device_trace` records a
``torch.profiler`` trace where JAX records a ``jax.profiler`` one.

:func:`span` names a stretch of the port's own work in such a trace.  The
port opens one at each layer boundary of its device-resident path; their
names are fixed (``smm.multiply``, ``smm.triple_product``, ``smm.densify``,
``smm.gemm``, ``smm.finish``, ``smm.extract``, ``smm.esc.expand``,
``smm.esc.sort``, ``smm.esc.compress``, ``smm.route.<stage>`` on the ESC
scipy routes, and ``smm.sync.<site>`` around each host sync).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import torch

__all__ = ["time_execution", "Timer", "device_trace", "span"]

_OFF = contextlib.nullcontext()


def _cuda_devices(result, found: set) -> set:
    """The CUDA devices of every tensor in ``result``: a tensor, a container
    dataclass (``CSRMatrix``, ``BSRMatrix``, ...), or a tuple, list or dict of
    them.  Anything else (numpy, scipy, numbers) holds none."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, (tuple, list)):
        for item in result:
            _cuda_devices(item, found)
    elif isinstance(result, dict):
        for item in result.values():
            _cuda_devices(item, found)
    elif dataclasses.is_dataclass(result) and not isinstance(result, type):
        for field in dataclasses.fields(result):
            _cuda_devices(getattr(result, field.name), found)
    return found


def time_execution(func: Callable, *args, sync: bool = True, **kwargs):
    """Run ``func`` and return ``(result, seconds)``; with ``sync`` the time
    includes the device work of every CUDA device the result lies on."""
    start = time.perf_counter()
    result = func(*args, **kwargs)
    if sync:
        for device in _cuda_devices(result, set()):
            torch.cuda.synchronize(device)
    return result, time.perf_counter() - start


class Timer:
    """Accumulating named timer for benchmark loops."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts.get(name, 0), 1)

    def report(self) -> str:
        lines = [
            f"{k}: total {v:.6f}s over {self.counts[k]} calls "
            f"(mean {self.mean(k):.6f}s)"
            for k, v in sorted(self.totals.items())
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the CPU, and CUDA when
    a card is present) into ``log_dir``: a Chrome trace, ``*.pt.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records;
    otherwise one shared no-op context.  The profiler's own state is the
    switch: entering a ``record_function`` costs ~10 us even when no
    profiler runs, the check ~0.1 us."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
