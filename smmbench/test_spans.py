"""CPU tests of the reading of the port's spans (``spans.py``) and of the
metrics that read it: hand-made traces whose card clock is shifted
against the host's, and real CPU traces of the port's calls.

    python -m pytest smmbench -q
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu_torch as smt
from smmbench import harness, spans, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("port_gap_share", "finish_device_ms", "port_syncs_per_call")

# The first step is skipped.  In the second (1000-2000 us on the host) the
# call opens at 1001; smm.multiply holds smm.gemm and smm.extract, which
# holds smm.sync.counts.
HOST = [(0, 1000, tracing.STEP), (1, 900, tracing.CALL), (10, 800, "smm.multiply"),
        (20, 30, "smm.gemm"), (21, 22, "cudaLaunchKernel"),
        (1000, 2000, tracing.STEP), (1001, 1900, tracing.CALL), (1005, 1006, "cudaLaunchKernel"),
        (1010, 1800, "smm.multiply"), (1100, 1400, "smm.gemm"),
        (1120, 1121, "cudaLaunchKernel"), (1450, 1451, "cudaLaunchKernel"),
        (1500, 1700, "smm.extract"), (1510, 1511, "cudaLaunchKernel"),
        (1600, 1650, "smm.sync.counts"), (1605, 1606, "cudaMemcpyAsync"),
        (1950, 1951, "cudaLaunchKernel")]
# (start, end, name, launch): the first operation starts where the step
# starts and the last ends where it ends, so moving them back inside the
# step undoes any shift of the card's clock.
OPS = [(20, 900, "triu_gemm_kernel", 21),
       (1000, 1010, "densify", 1005),            # in the call, in no span of the port
       (1120, 1390, "triu_gemm_kernel", 1120),   # smm.gemm
       (1450, 1455, "fill", 1450),               # smm.multiply itself
       (1520, 1580, "fill_rows", 1510),          # smm.extract
       (1600, 1610, "Memcpy DtoH", 1605),        # smm.sync.counts
       (1995, 2000, "harness_kernel", 1950)]     # in the step, outside the call


def _shifted(us):
    return [(s + us, e + us, n, launch) for s, e, n, launch in OPS]


@pytest.mark.parametrize("shift_us", [0, 2000, -2000])
def test_operations_go_to_the_span_that_launched_them(shift_us):
    r = spans.read(_shifted(shift_us), HOST)
    assert r.calls == 1 and r.window_s == pytest.approx(1000e-6)
    assert sorted(r.spans) == ["smm.extract", "smm.gemm", "smm.multiply", "smm.sync.counts"]
    device = {name: s.device_s for name, s in r.spans.items()}
    assert device == {"smm.gemm": pytest.approx(270e-6), "smm.multiply": pytest.approx(5e-6),
                      "smm.extract": pytest.approx(60e-6),
                      "smm.sync.counts": pytest.approx(10e-6)}
    assert r.outside_s == pytest.approx(10e-6)
    assert r.call_device_s == pytest.approx(355e-6)
    assert r.syncs == 1


@pytest.mark.parametrize("shift_us", [0, 2000, -2000])
def test_idle_goes_to_the_span_open_at_its_middle(shift_us):
    r = spans.read(_shifted(shift_us), HOST)
    idle = {name: s.idle_s for name, s in r.spans.items()}
    # Gaps 1010-1120, 1390-1450, 1455-1520 under smm.multiply; 1580-1600
    # under smm.extract; 1610-1995 (middle 1802.5) under none.
    assert idle == {"smm.multiply": pytest.approx(235e-6), "smm.gemm": 0.0,
                    "smm.extract": pytest.approx(20e-6), "smm.sync.counts": 0.0}
    assert r.harness_idle_s == pytest.approx(385e-6)
    assert r.port_idle_s == pytest.approx(255e-6)
    busy = tracing.read(_shifted(shift_us), HOST, {}).busy_s
    assert r.port_idle_s + r.harness_idle_s == pytest.approx(r.window_s - busy)


def test_self_time_is_the_span_less_its_children():
    r = spans.read(OPS, HOST)
    host = {name: (s.calls, s.host_s, s.self_s) for name, s in r.spans.items()}
    assert host == {"smm.multiply": (1, pytest.approx(790e-6), pytest.approx(290e-6)),
                    "smm.gemm": (1, pytest.approx(300e-6), pytest.approx(300e-6)),
                    "smm.extract": (1, pytest.approx(200e-6), pytest.approx(150e-6)),
                    "smm.sync.counts": (1, pytest.approx(50e-6), pytest.approx(50e-6))}


def test_a_program_without_the_spans_reads_none():
    plain = [x for x in HOST if not x[2].startswith(spans.PREFIX)]
    assert spans.read(OPS, plain) is None
    assert spans.read(OPS, HOST, skip_steps=2) is None


def _readers():
    cell = harness.Cell(ROOT, "er_200k.csr")
    return {name: cell.reader(name) for name in METRICS}


def test_the_readers_read_a_kept_reading():
    ctx = types.SimpleNamespace(trace=None, spans=spans.read(OPS, HOST))
    got = {name: read(ctx) for name, read in _readers().items()}
    assert got == {"port_gap_share": pytest.approx(25.5), "finish_device_ms": None,
                   "port_syncs_per_call": 1.0}


def _port_call(kind):
    rng = np.random.default_rng(11)
    a_sp, b_sp = (sp.random(200, 200, density=0.02, format="csr", dtype=np.float32,
                            random_state=rng.integers(2**31)) for _ in range(2))
    a, b = smt.from_scipy(a_sp, device="cpu"), smt.from_scipy(b_sp, device="cpu")
    if kind == "esc":
        expand = int(np.diff(b_sp.indptr)[a_sp.indices].sum())
        return lambda: smt.multiply(a, b, expand_capacity=smt.bucket_capacity(expand),
                                    out_capacity=smt.bucket_capacity(expand))
    if kind == "dense_sym":
        return lambda: smt.multiply(a, b, symmetric=True, out_capacity=200 * 200)
    return lambda: torch.mm(torch.ones(8, 8), torch.ones(8, 8))


def _traced_run(call, steps=3):
    """What the harness's run holds once its window closes: the profiler
    of a few steps, and ``ctx``; then the new readers, called from here."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as profiler:
        for _ in range(steps):
            with torch.profiler.record_function(tracing.STEP):
                with torch.profiler.record_function(tracing.CALL):
                    call()
    ctx = types.SimpleNamespace(trace=None)
    return {name: read(ctx) for name, read in _readers().items()}, ctx


@pytest.mark.parametrize("kind, syncs, finish", [("esc", 1.0, None), ("dense_sym", 0.0, 0.0)])
def test_the_readers_find_the_runs_profiler(capsys, kind, syncs, finish):
    got, ctx = _traced_run(_port_call(kind))
    assert got["port_syncs_per_call"] == syncs and got["finish_device_ms"] == finish
    assert 0.0 <= got["port_gap_share"] <= 100.0
    assert ctx.spans.calls == 2 and ctx.spans.spans["smm.multiply"].calls == 2
    printed = capsys.readouterr().err.splitlines()
    assert len(printed) == len(ctx.spans.spans) + 2
    assert all(line.startswith("[smmbench] span ") for line in printed)


def test_the_readers_read_nothing_of_a_program_without_the_spans(capsys):
    got, ctx = _traced_run(_port_call("plain"))
    assert got == dict.fromkeys(METRICS) and ctx.spans is None
    assert capsys.readouterr().err == ""


def test_untraced_the_readers_read_nothing():
    ctx = types.SimpleNamespace(trace=None)
    assert {name: read(ctx) for name, read in _readers().items()} == dict.fromkeys(METRICS)
