"""The port's spans (``utils.profiling.span``) on its device-resident path,
on the CPU.

With no profiler running a span is one shared no-op context, and nothing
on the path enters ``torch.profiler.record_function``.  Under a profiler
each call opens the documented spans with the documented parents (by time
nesting), every aten operation inside the entry span lies inside one of
its child spans, the host syncs are named at their site, and the answers
are the same bits as without the profiler.  The ESC scipy routes' stages
are spans too, named as ``get_last_route_stages()`` names them.
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu_torch import api as tapi
from sparse_matrix_mult_tpu_torch.ops import dense_path as tdense
from sparse_matrix_mult_tpu_torch.ops import triple_product as ttriple
from sparse_matrix_mult_tpu_torch.ops.spgemm_esc import windowed_plan
from sparse_matrix_mult_tpu_torch.utils import profiling

DENSE = ["smm.densify", "smm.densify", "smm.gemm"]
ESC = ["smm.esc.expand", "smm.esc.sort", "smm.esc.compress"]
# case -> (its entry span, the entry's child spans in the order they open).
CASES = {
    "dense": ("smm.multiply", DENSE + ["smm.extract"]),
    "dense_sym": ("smm.multiply", DENSE + ["smm.finish", "smm.extract"]),
    "dense_sym_k1": ("smm.multiply", DENSE + ["smm.finish", "smm.extract"]),
    "triple": ("smm.triple_product", DENSE + ["smm.finish"]),
    "triple_full": ("smm.triple_product", DENSE + ["smm.finish"]),
    "triple_full_k1": ("smm.triple_product", DENSE + ["smm.finish"]),
    "esc_windowed": ("smm.multiply", ESC),
    "esc": ("smm.multiply", ESC),
}
SYNCS = {"esc_windowed": 1, "esc": 1}


def _operands(m, k, n, density, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(m, k, density=density, format="csr", random_state=rng.integers(2**31),
                  dtype=np.float32)
    b = sp.random(k, n, density=density, format="csr", random_state=rng.integers(2**31),
                  dtype=np.float32)
    return tsmm.from_scipy(a, device="cpu"), tsmm.from_scipy(b, device="cpu"), a, b


def _call(case, monkeypatch):
    """A zero-argument call of the case on small CPU operands."""
    if case.endswith("_k1"):
        monkeypatch.setattr(tdense, "_triu_kernel_ok", lambda *args: True)
        monkeypatch.setattr(ttriple, "_triu_kernel_ok", lambda *args: True)
    if case.startswith("triple"):
        h, q, _, _ = _operands(40, 30, 30, 0.2, 3)
        full = int("full" in case)
        return lambda: tsmm.triple_product(h, q, compute_full_matrix=full)
    if case.startswith("dense"):
        a, b, _, _ = _operands(48, 40, 48, 0.15, 4)
        sym = "sym" in case
        return lambda: tsmm.multiply(a, b, symmetric=sym, out_capacity=48 * 48)
    a, b, a_sp, b_sp = _operands(300, 300, 300, 0.01, 5)
    lens = np.diff(b_sp.indptr)[a_sp.indices]
    expand = int(lens.sum())
    kw = dict(expand_capacity=tsmm.bucket_capacity(expand),
              out_capacity=tsmm.bucket_capacity(min(expand, 300 * 300)))
    if case == "esc_windowed":
        window, tail = windowed_plan(a_sp.nnz, lens, expand)
        kw.update(window=window, tail_capacity=tsmm.bucket_capacity(tail) if tail else 0)
    return lambda: tsmm.multiply(a, b, **kw)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted(((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()))


def _spans(events):
    """[(name, start, end, parent name or None)] of the ``smm.`` spans, the
    parent the innermost other ``smm.`` span that contains the span."""
    spans = [(n, s, -ne) for s, ne, n in events if n.startswith("smm.")]
    out = []
    for i, (name, s, e) in enumerate(spans):
        parents = [(ps, pn) for j, (pn, ps, pe) in enumerate(spans)
                   if j != i and ps <= s and e <= pe and (ps, -pe) < (s, -e)]
        out.append((name, s, e, max(parents)[1] if parents else None))
    return out


def _leaves(answer):
    return answer if isinstance(answer, torch.Tensor) else (answer.indptr, answer.indices,
                                                             answer.values)


def test_no_profiler_no_span():
    assert not torch._C._autograd._profiler_enabled()
    off = profiling.span("smm.multiply")
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.span("smm.gemm") is off
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("smm.gemm") is not off


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_path_enters_no_record_function_without_a_profiler(case, monkeypatch):
    call = _call(case, monkeypatch)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    call()


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_call_opens_the_documented_spans(case, monkeypatch):
    entry, children = CASES[case]
    _, events = _profiled(_call(case, monkeypatch))
    spans = _spans(events)
    assert [(n, p) for n, _, _, p in spans if n == entry] == [(entry, None)]
    syncs = [(n, p) for n, _, _, p in spans if n.startswith("smm.sync.")]
    assert syncs == [("smm.sync.esc_counts", "smm.esc.expand")] * SYNCS.get(case, 0)
    rest = [(n, p) for n, _, _, p in spans if n != entry and not n.startswith("smm.sync.")]
    assert rest == [(n, entry) for n in children]


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_aten_op_of_a_call_lies_in_a_child_span(case, monkeypatch):
    entry, _ = CASES[case]
    _, events = _profiled(_call(case, monkeypatch))
    spans = _spans(events)
    (_, lo, hi, _), = [x for x in spans if x[0] == entry]
    children = [(s, e) for n, s, e, _ in spans if n != entry]
    ops = [(s, -ne, n) for s, ne, n in events if n.startswith("aten::") and lo <= s <= hi]
    assert ops
    loose = [n for s, e, n in ops if not any(cs <= s and e <= ce for cs, ce in children)]
    assert loose == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_profiler_changes_no_bit_of_the_answer(case, monkeypatch):
    call = _call(case, monkeypatch)
    plain = call()
    traced, _ = _profiled(call)
    for x, y in zip(_leaves(plain), _leaves(traced)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("route, limits, shape", [
    ("esc_windowed", dict(use_binned_esc=False, dense_path_limit=500),
     (120, 100, 120, 0.03, 0.03, 2)),
    ("esc", dict(use_binned_esc=False, dense_path_limit=500), (150, 40, 150, 0.05, 0.6, 3)),
    ("esc_chunks", dict(dense_path_limit=1000, esc_expand_limit=500, binned_expand_limit=500),
     (60, 60, 60, 0.1, 0.1, 5)),
])
def test_the_route_stages_are_spans_of_their_names(route, limits, shape):
    """Under the profiler each stage of an ESC scipy route opens the span
    ``smm.route.<stage>``: the spans' names are the stages' keys."""
    m, k, n, da, db, seed = shape
    a = sp.random(m, k, density=da, format="csr", random_state=seed)
    b = sp.random(k, n, density=db, format="csr", random_state=seed + 1)
    saved = tsmm.get_config()
    tsmm.set_config(host_compute_limit=0, auto_calibrate_link=False, link_fixed_s=1e-9,
                    link_up_bytes_per_s=1e15, link_down_bytes_per_s=1e15, host_rate_base=1.0,
                    **limits)
    try:
        _, events = _profiled(lambda: tsmm.sparse_matrix_multiply(a, b, device="cpu"))
    finally:
        tsmm.set_config(saved)
    assert tsmm.get_last_route() == route
    stages = tapi.get_last_route_stages()
    names = {n.removeprefix("smm.route.") for _, _, n in events if n.startswith("smm.route.")}
    assert names == set(stages)
