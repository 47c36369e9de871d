"""The port's ``utils`` (timing, profiling, logging) against the JAX
package's, and ``examples/demo_torch.py`` on the CPU."""

import glob
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu.utils as jutils
import sparse_matrix_mult_tpu_torch as tsmm
import sparse_matrix_mult_tpu_torch.utils as tutils
from sparse_matrix_mult_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_utils_export_jax_names():
    assert tutils.__all__ == jutils.__all__ == ["Timer", "time_execution", "get_logger"]
    assert callable(profiling.device_trace)


def test_timer_report_equals_jax():
    """The same sections, timed by each Timer, then given the same totals:
    the same report, line for line."""
    timers = [tutils.Timer(), jutils.Timer()]
    for timer in timers:
        for name in ("upload", "product", "upload"):
            with timer.section(name):
                pass
        assert timer.counts == {"upload": 2, "product": 1}
        timer.totals = {"upload": 0.25, "product": 1.5}
    assert timers[0].report() == timers[1].report()
    assert timers[0].report().splitlines() == [
        "product: total 1.500000s over 1 calls (mean 1.500000s)",
        "upload: total 0.250000s over 2 calls (mean 0.125000s)",
    ]
    assert timers[0].mean("upload") == timers[1].mean("upload") == 0.125


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to see what gets synchronized."""

    card = 0

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", self.card)


def _on_card(t: torch.Tensor, card: int) -> torch.Tensor:
    t = torch.Tensor._make_subclass(_OnCard, t)
    t.card = card
    return t


@pytest.fixture
def syncs(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    return calls


def test_time_execution_returns_the_result_and_a_time(syncs):
    a = sp.random(50, 50, density=0.1, format="csr", random_state=1)
    got, seconds = tutils.time_execution(tsmm.sparse_matrix_multiply, a, a, device="cpu")
    assert seconds > 0 and sp.issparse(got)
    np.testing.assert_allclose(got.toarray(), (a @ a).toarray(), rtol=1e-12)
    assert syncs == []  # scipy and CPU tensors need no synchronization
    t = tsmm.from_scipy(a, device="cpu")
    got, seconds = tutils.time_execution(tsmm.multiply, t, t, output_format="dense")
    assert isinstance(got, torch.Tensor) and seconds > 0 and syncs == []


def test_time_execution_syncs_every_card_of_the_result(syncs):
    """A CSRMatrix on card 1 and a tensor on card 0, in a tuple: each card is
    synchronized once; sync=False synchronizes none."""
    a = tsmm.from_scipy(sp.random(20, 20, density=0.2, format="csr", random_state=2),
                        device="cpu")
    csr = tsmm.CSRMatrix(_on_card(a.indptr, 1), _on_card(a.indices, 1),
                         _on_card(a.values, 1), a.shape)
    result = (csr, {"x": _on_card(torch.ones(3), 0)}, np.zeros(2))
    got, _ = tutils.time_execution(lambda: result)
    assert got is result
    assert sorted(str(d) for d in syncs) == ["cuda:0", "cuda:1"]
    syncs.clear()
    tutils.time_execution(lambda: result, sync=False)
    assert syncs == []


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]


@pytest.fixture
def fresh_loggers():
    """Both packages' loggers without handlers; restored afterwards."""
    loggers = [logging.getLogger(n) for n in ("sparse_matrix_mult_tpu_torch",
                                              "sparse_matrix_mult_tpu")]
    saved = [(lg, list(lg.handlers), lg.level) for lg in loggers]
    for lg in loggers:
        lg.handlers.clear()
    yield
    for lg, handlers, level in saved:
        lg.handlers[:] = handlers
        lg.setLevel(level)


@pytest.mark.parametrize("env,level", [(None, logging.WARNING), ("debug", logging.DEBUG),
                                       ("ERROR", logging.ERROR), ("nonsense", logging.WARNING)])
def test_get_logger_follows_jax(fresh_loggers, monkeypatch, env, level):
    if env is None:
        monkeypatch.delenv("SMM_TPU_LOG", raising=False)
    else:
        monkeypatch.setenv("SMM_TPU_LOG", env)
    got, want = tutils.get_logger(), jutils.get_logger()
    assert got.name == "sparse_matrix_mult_tpu_torch"
    assert got.level == want.level == level
    assert len(got.handlers) == 1 and isinstance(got.handlers[0], logging.StreamHandler)
    assert got.handlers[0].formatter._fmt == want.handlers[0].formatter._fmt
    assert tutils.get_logger() is got and len(got.handlers) == 1  # no second handler


def test_demo_prints_only_ok_lines():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "demo_torch.py"),
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 13 and all(line.startswith("[ok] ") for line in lines), proc.stdout
    assert lines[-1] == "[ok] demo complete on device cpu (host CPU)"
