"""One run of one cell of ``BENCHMARK.json``.

Set-up draws the operands' structure from the seed on the card, builds
the port's containers, works out the sizes the traffic mix asks for, and
warms up every shape the window uses.  The window then calls the entry in
a closed loop, one caller, each call behind ``torch.cuda.synchronize()``
and timed by the host clock; before each call the operands' values are
drawn anew (outside its time), so no answer can be served again.  A
reservoir drawn from the seed keeps ``CHECKED_CALLS`` answers of the
window.  After the window the program's containers are let go, and the
kept answers are held to the float64 reference on operands drawn again
from the seed.  With ``trace`` the window runs under ``torch.profiler``
(at most ``TRACE_CALLS`` calls) and the per-layer metrics are read from it.

Every metric is a reader, ``metrics/<name>.py`` with ``read(ctx)``, which
returns a number or None (nothing to read).  ``ctx`` carries the
window's calls (``call_s``, ``entries``), ``setup_s``, ``peak_call_bytes``
and, traced, ``trace`` (:class:`.tracing.Reading`), ``work`` per call by
stage and ``partials`` per call.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
import types

import numpy as np
import torch

from . import entries, operands, tracing
from .reference import compare, products

BENCH = os.path.basename(os.path.dirname(os.path.abspath(__file__)))
# What a run of the port must never load: JAX, the JAX package and the
# harnesses built around it, by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_matrix_mult_tpu", "benchmarks_torch", "benchmarks")
WARMUP_CALLS = 2
TRACE_CALLS = 200
CHECKED_CALLS = 4


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def _named(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


class Cell:
    """What ``BENCHMARK.json`` and the cell's files say of one cell."""

    def __init__(self, root: str, workload: str):
        manifest = _load(os.path.join(root, "BENCHMARK.json"))
        self.root, self.name = root, workload
        self.workload = _named(manifest["workloads"], workload, "workload")
        self.config = _load(os.path.join(root, _named(manifest["configs"],
                                                      self.workload["config"], "config")["file"]))
        self.traffic = _load(os.path.join(root, BENCH, "traffic",
                                          self.workload["traffic"] + ".json"))
        self.kernel_map = self._kernel_map()

        def mine(metric):
            return workload in metric.get("workloads", [workload])
        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]

    def _kernel_map(self) -> dict:
        """Stage -> kernel names: ``kernel_maps/<cell>.json`` and every file
        in ``kernel_maps/<cell>/`` (a later kernel's entry)."""
        base = os.path.join(self.root, BENCH, "kernel_maps", self.name)
        paths = [base + ".json"] if os.path.exists(base + ".json") else []
        if os.path.isdir(base):
            paths += sorted(os.path.join(base, f) for f in os.listdir(base) if f.endswith(".json"))
        out = {}
        for path in paths:
            for stage, kernels in _load(path).items():
                out.setdefault(stage, []).extend(kernels)
        return out

    def reader(self, name: str):
        path = os.path.join(self.root, BENCH, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(f"{BENCH}_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Reservoir:
    """``size`` answers of the window, each call equally likely to be kept,
    drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.kept = size, {}
        self.rng = np.random.default_rng(operands.stream_seed(seed, "checked calls"))

    def offer(self, call: int, answer) -> None:
        if len(self.kept) < self.size:
            self.kept[call] = answer
            return
        slot = int(self.rng.integers(0, call + 1))
        if slot < self.size:
            del self.kept[sorted(self.kept)[slot]]
            self.kept[call] = answer


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False, started: float | None = None, log=sys.stderr) -> dict:
    """One run of ``workload``: its result (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, traced ``breakdown``, and
    ``checks`` last), or ``{"forbidden": [...]}`` when a forbidden module
    was loaded."""
    started = time.perf_counter() if started is None else started
    entered = time.perf_counter()
    device = torch.device(device)
    cell = Cell(root, workload)
    config, traffic = cell.config, cell.traffic
    made = operands.make(config, traffic["operands"], seed, device)
    subject = entries.Subject(traffic, config, made, device)
    _sync(device)
    sized = time.perf_counter()
    if control:
        subject.use_control()
    checked = CHECKED_CALLS
    on_card = device.type == "cuda"
    traced = trace and on_card

    def span(name):
        return torch.profiler.record_function(name) if traced else contextlib.nullcontext()

    def step(call: int):
        subject.refresh(seed, call)
        _sync(device)
        t = time.perf_counter()
        with span(tracing.STEP):
            with span(tracing.CALL):
                answer = subject.call()
            _sync(device)
        return answer, time.perf_counter() - t

    def peak() -> int:
        """The allocator's peak since the last reading, which it resets."""
        if not on_card:
            return 0
        bytes_ = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        return bytes_

    # Warm-up: every shape the window uses, holding as many answers as the
    # reservoir will, so the allocator has grown before the window opens.
    held = [step(-1 - i)[0] for i in range(WARMUP_CALLS + checked)]
    del held
    setup_peak = peak()
    step(-1)
    peak_call = peak()

    reservoir = _Reservoir(checked, seed)
    call_s, counts = [], []
    setup_s = time.perf_counter() - started
    print(f"[{BENCH}] setup_s {setup_s!r}: imports {entered - started!r}, CUDA context, operands "
          f"and sizes {sized - entered!r}, warm-up {started + setup_s - sized!r}", file=log)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiler = torch.profiler.profile(activities=activities) if traced else None
    with profiler or contextlib.nullcontext():
        opened = time.perf_counter()
        while time.perf_counter() - opened < seconds and not (trace and len(call_s) >= TRACE_CALLS):
            answer, s = step(len(call_s))
            call_s.append(s)
            counts.append(subject.entries(answer))
            reservoir.offer(len(call_s) - 1, answer)
            del answer
    window_peak = peak()

    info = subject.scipy_round_trip() if traced and not control else None
    ctx = types.SimpleNamespace(call_s=call_s, entries=counts, setup_s=setup_s,
                                peak_call_bytes=peak_call, trace=None,
                                work=subject.work(counts[-1]), partials=subject.partials)
    subject.close()
    del subject, made
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    loaded = forbidden_modules()
    if loaded:
        return dict(forbidden=loaded)
    checks = _check(config, traffic, seed, reservoir.kept, device)
    reservoir.kept.clear()
    correct = bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                   for c in checks.values())

    result = dict(correct=correct, attempted=len(call_s), failed=0, metrics={})
    dev = dict(platform="gpu" if on_card else device.type,
               kind=torch.cuda.get_device_name(device) if on_card else device.type,
               count=cell.workload["chips"],
               memory_peak_bytes=max(setup_peak, peak_call, window_peak))
    if profiler is not None:
        device_ops, host = tracing.events(profiler)
        ctx.trace = tracing.read(device_ops, host, cell.kernel_map)
        if ctx.trace is not None:
            dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
            result["breakdown"] = dict(device_ops=[list(x) for x in ctx.trace.device_ops],
                                       idle_gaps=[list(x) for x in ctx.trace.idle_gaps])
            for kernel, s in sorted(ctx.trace.unknown_s.items(), key=lambda kv: -kv[1]):
                print(f"[{BENCH}] kernel not in the map: {kernel} {s!r} s", file=log)
    metrics = cell.per_layer if trace else cell.end_to_end
    for metric in metrics:
        value = cell.reader(metric["name"])(ctx)
        if value is not None:
            result["metrics"][metric["name"]] = dict(value=value, unit=metric["unit"])
    result["device"] = dev
    if info is not None:
        print(f"[{BENCH}] {workload}: {info}", file=log)
    result["checks"] = checks
    return result


def _check(config: dict, traffic: dict, seed: int, kept: dict, device) -> dict:
    """The kept answers against the float64 reference, on operands drawn
    again from the seed: each compared number's worst over them, beside
    its limit (1 for ``value_share``: the configuration's own rtol and
    atol)."""
    ref_made = operands.make(config, traffic["operands"], seed, device)
    kwargs = traffic.get("kwargs", {})
    rtol, atol = config["rtol"], config["atol"]
    worst = {}
    for call, answer in sorted(kept.items()):
        a, b = (operands.call_operand(config, ref_made, name, seed, call, device)
                for name in traffic["operands"])
        if traffic["entry"] == "triple_product":
            full = bool(kwargs.get("compute_full_matrix"))
            reading = compare.dense_reading(answer, products.triple(a, b, full), rtol, atol,
                                            symmetric=full)
        else:
            blocks = products.product_blocks(a, b, bool(kwargs.get("symmetric")))
            reading = compare.csr_reading(answer, blocks, a.shape[0], rtol, atol)
        for key, value in reading.items():
            if key not in worst or value is None or (worst[key] is not None and value > worst[key]):
                worst[key] = value
    limits = dict(structure_mismatch=0, value_share=1.0, asymmetry=0)
    return {key: dict(value=value, limit=limits[key]) for key, value in worst.items()}
