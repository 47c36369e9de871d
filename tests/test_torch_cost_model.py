"""The router's host/device cost model in the port against the JAX package's,
on the CPU.

``_est_result_nnz`` and the decision of ``_host_route_wins`` must equal JAX's
for the same configuration (``auto_calibrate_link=False``, the same link and
host terms in both packages); the three branches of ``sparse_matrix_multiply``
must take JAX's route on each side of the flip, with JAX's product; and the
link calibration is the port's own: once per device, never swallowed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu import api as japi
from sparse_matrix_mult_tpu_torch import api

ORACLE = dict(rtol=1e-5, atol=1e-8)
# One configuration of the model for both packages: a host at 1e8 partials/s
# and a link of 2 ms fixed cost, 5 GB/s up and 2 GB/s down.
MODEL = dict(auto_calibrate_link=False, host_rate_base=1e8, link_fixed_s=2e-3,
             link_up_bytes_per_s=5e9, link_down_bytes_per_s=2e9, host_pack_rate=5e8)


@pytest.fixture
def config():
    """Set MODEL in both packages; restore both configurations afterwards."""
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()
    tsmm.set_config(**MODEL)
    jsmm.set_config(**MODEL)
    yield
    tsmm.set_config(saved_t)
    jsmm.set_config(saved_j)


@pytest.mark.parametrize("m,n", [(1, 1), (7, 300), (1000, 1000), (100_000, 50_000),
                                 (1_000_000, 1_000_000)])
def test_est_result_nnz_equals_jax(m, n):
    for expand in (0, 1, 10, 1000, 10**5, 10**7, 10**9, 10**12, 10**14):
        got = api._est_result_nnz(expand, m, n)
        assert got == japi._est_result_nnz(expand, m, n), (expand, m, n)
        assert 0 <= got <= m * n
    # The limits: hypersparse, nnz ~= expand; far past m*n partials, nnz = m*n.
    assert api._est_result_nnz(10**6, 10**6, 10**6) == pytest.approx(10**6, rel=1e-3)
    assert api._est_result_nnz(100 * m * n, m, n) == m * n


SHAPES = [(300, 300, 300, 0.01, 0.01), (2000, 500, 3000, 0.001, 0.02),
          (5000, 5000, 5000, 0.0005, 0.0005), (64, 20_000, 128, 0.05, 0.001)]


def _operands(m, k, n, da, db, seed=0):
    a = sp.random(m, k, density=da, format="csr", random_state=seed)
    b = sp.random(k, n, density=db, format="csr", random_state=seed + 1)
    return a, b


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("dense_out", [False, True], ids=["sparse_out", "dense_out"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[0]}x{s[1]}x{s[2]}" for s in SHAPES])
def test_host_route_wins_equals_jax(config, monkeypatch, shape, dense_out, f32):
    """The same decision as JAX at 60 expansions from 1e3 to 1e10 partials,
    both decisions among them.  ``f32``: the port's CUDA request uploads
    float32 (4-byte values), set for JAX through its ``_upload_dtype``."""
    a, b = _operands(*shape)
    device = "cuda" if f32 else "cpu"  # decided on the host: nothing touches a card
    assert api._upload_dtype(a, b, device)[0] == (torch.float32 if f32 else None)
    if f32:
        monkeypatch.setattr(japi, "_upload_dtype", lambda a_sp, b_sp: (jnp.float32, "fast"))
    val_bytes = 4 if f32 else 8
    out_bytes = val_bytes * a.shape[0] * b.shape[1] if dense_out else None
    decisions = []
    for expand in np.unique(np.geomspace(1e3, 1e10, 60).astype(np.int64)):
        got = api._host_route_wins(int(expand), a, b, device, out_bytes=out_bytes)
        assert got == japi._host_route_wins(int(expand), a, b, out_bytes=out_bytes), expand
        decisions.append(got)
    assert True in decisions and False in decisions


def test_route_costs_are_the_formula(config):
    """est_host and est_dev, term for term (JAX api.py:557-599)."""
    a, b = _operands(*SHAPES[1])
    m, n = a.shape[0], b.shape[1]
    expand = 3_000_000
    nnz = api._est_result_nnz(expand, m, n)
    reuse = max(expand / nnz, 1.0)
    est_host, est_dev = api._route_costs(expand, a, b, "cpu")
    assert est_host == pytest.approx(expand / (1e8 * math.sqrt(reuse)), rel=1e-12)
    down = min(12 * nnz / 2e9, 8 * m * n / 2e9 + m * n / 5e8)
    assert est_dev == pytest.approx(2e-3 + 12 * (a.nnz + b.nnz) / 5e9 + down, rel=1e-12)
    _, est_dev = api._route_costs(expand, a, b, "cpu", out_bytes=10**9)
    assert est_dev == pytest.approx(2e-3 + 12 * (a.nnz + b.nnz) / 5e9 + 10**9 / 2e9, rel=1e-12)


# Each side of the flip under MODEL with host_compute_limit 0 (the model
# decides every request): ~2e4 partials cost ~0.2 ms on the host, under the
# 2 ms link; ~2e7 at reuse ~54 cost ~26 ms there.
SMALL = (200, 200, 200, 0.05, 0.05)
LARGE = (600, 600, 600, 0.3, 0.3)


@pytest.mark.parametrize("side,route", [("small", "host"), ("large", None)])
@pytest.mark.parametrize("branch", ["sparse", "sparse_symmetric", "dense", "triple"])
def test_routes_equal_jax_on_each_side_of_the_flip(config, branch, side, route):
    tsmm.set_config(host_compute_limit=0)
    jsmm.set_config(host_compute_limit=0)
    a, b = _operands(*(SMALL if side == "small" else LARGE), seed=3)
    kw = dict(sparse=dict(), sparse_symmetric=dict(symmetric=True),
              dense=dict(output_format="dense"),
              triple=dict(use_triple_product=True, compute_full_matrix=1))[branch]
    got = tsmm.sparse_matrix_multiply(a, b, device="cpu", **kw)
    want = jsmm.sparse_matrix_multiply(a, b, **kw)
    route = route or ("triple" if branch == "triple" else "dense")
    assert tsmm.get_last_route() == jsmm.get_last_route() == route
    if branch == "triple":
        c = (a @ b @ a.T).toarray()
        ref = np.triu(c) + np.triu(c, 1).T
    else:
        ref = (a @ b).toarray()
        ref = np.triu(ref) if kw.get("symmetric") else ref
    got = got.toarray() if sp.issparse(got) else got
    want = want.toarray() if sp.issparse(want) else want
    np.testing.assert_allclose(got, want, **ORACLE)
    np.testing.assert_allclose(got, ref, **ORACLE)


@pytest.fixture
def bsr_scans(monkeypatch):
    """Count the router's calls of _bsr_route_ok (the O(nnz) occupancy scan)."""
    calls = []
    real = api._bsr_route_ok

    def counted(a_sp, device):
        calls.append(a_sp.shape)
        return real(a_sp, device)

    monkeypatch.setattr(api, "_bsr_route_ok", counted)
    return calls


def test_bsr_scan_stays_behind_the_model(config, bsr_scans):
    """Sparse output: the scan runs only when the model already says "host".
    A hypersparse request (the ESC rung when it stays on the device, which
    scans nothing) with the host priced out, then priced in."""
    a, b = _operands(3000, 3000, 3000, 0.003, 0.003, seed=5)
    tsmm.set_config(host_compute_limit=0, host_rate_base=1.0)
    tsmm.sparse_matrix_multiply(a, b, device="cpu")
    assert tsmm.get_last_route() == "esc_binned" and bsr_scans == []
    tsmm.set_config(host_rate_base=1e15)
    tsmm.sparse_matrix_multiply(a, b, device="cpu")
    assert tsmm.get_last_route() == "host" and bsr_scans == [a.shape]


@pytest.mark.parametrize("output_format", ["sparse", "dense"])
@pytest.mark.parametrize("host_rate_base", [1.0, 1e15], ids=["device", "host"])
def test_bsr_scan_runs_at_most_once(config, bsr_scans, output_format, host_rate_base):
    """A dense-route request scans A's occupancy at most once, whichever way
    the model decides."""
    a, b = _operands(*LARGE, seed=7)
    tsmm.set_config(host_compute_limit=0, host_rate_base=host_rate_base)
    tsmm.sparse_matrix_multiply(a, b, output_format, device="cpu")
    assert tsmm.get_last_route() == ("dense" if host_rate_base == 1.0 else "host")
    assert len(bsr_scans) <= 1


@pytest.fixture
def calibrations(monkeypatch):
    """A fresh calibration table, and the devices calibrated, in order."""
    monkeypatch.setattr(api, "_LINK_TERMS", {})
    calls = []
    real = api._calibrate_link

    def counted(device):
        calls.append(str(device))
        return real(device)

    monkeypatch.setattr(api, "_calibrate_link", counted)
    saved = tsmm.get_config()
    tsmm.set_config(auto_calibrate_link=True, host_compute_limit=0)
    yield calls
    tsmm.set_config(saved)


def test_calibration_writes_finite_positive_link_terms(calibrations):
    a, b = _operands(*SMALL)
    cfg = tsmm.get_config()
    api._route_costs(100_000, a, b, "cpu")
    terms = api._LINK_TERMS["cpu"]
    assert set(terms) == {"link_fixed_s", "link_up_bytes_per_s", "link_down_bytes_per_s"}
    assert all(math.isfinite(v) and v > 0 for v in terms.values())
    assert terms["link_fixed_s"] >= 1e-5
    assert min(terms["link_up_bytes_per_s"], terms["link_down_bytes_per_s"]) >= 1e6
    assert tsmm.get_config() == cfg  # kept per device, not written into the config


def test_calibration_runs_once_per_device(calibrations):
    """Two requests on the CPU calibrate it once; a card's terms already in
    the table price no CPU request."""
    api._LINK_TERMS["cuda:0"] = dict(link_fixed_s=1e9, link_up_bytes_per_s=1e6,
                                     link_down_bytes_per_s=1e6)
    a, b = _operands(*LARGE)
    for _ in range(2):
        tsmm.sparse_matrix_multiply(a, b, device="cpu")
    assert calibrations == ["cpu"]
    assert api._LINK_TERMS["cpu"]["link_fixed_s"] < 1.0
    assert api._LINK_TERMS["cuda:0"]["link_fixed_s"] == 1e9


def test_calibration_is_skipped_when_off(calibrations):
    tsmm.set_config(auto_calibrate_link=False)
    a, b = _operands(*LARGE)
    tsmm.sparse_matrix_multiply(a, b, device="cpu")
    assert calibrations == [] and api._LINK_TERMS == {}


def test_a_failed_probe_raises(calibrations, monkeypatch):
    """A probe that fails propagates out of the request: no silent host route."""
    def broken(x):
        raise RuntimeError("transfer failed")

    monkeypatch.setattr(api, "fetch_np", broken)
    a, b = _operands(*LARGE)
    with pytest.raises(RuntimeError, match="transfer failed"):
        api._calibrate_link("cpu")
    with pytest.raises(RuntimeError, match="transfer failed"):
        tsmm.sparse_matrix_multiply(a, b, device="cpu")
    assert api._LINK_TERMS == {}


def test_device_entry_points_never_ask_the_model(monkeypatch):
    """multiply and triple_product stay on the operands' device."""
    def asked(*args, **kw):
        raise AssertionError("the cost model was consulted")

    monkeypatch.setattr(api, "_route_costs", asked)
    a_sp, b_sp = _operands(50, 50, 50, 0.1, 0.1)
    a, b = tsmm.from_scipy(a_sp, device="cpu"), tsmm.from_scipy(b_sp, device="cpu")
    np.testing.assert_allclose(tsmm.multiply(a, b, output_format="dense").numpy(),
                               (a_sp @ b_sp).toarray(), **ORACLE)
    c = (a_sp @ b_sp @ a_sp.T).toarray()
    np.testing.assert_allclose(tsmm.triple_product(a, b).numpy(), np.triu(c), **ORACLE)
