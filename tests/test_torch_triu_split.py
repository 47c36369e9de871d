"""K1's bf16 split and its split3 routing (the plain versions, on the CPU)
against the JAX package: the split of ``triu_matmul.py::_kernel``, the
``_split3_within_oracle`` gate and the conditions under which each package
routes to split3 (the split3 product itself is held against the Pallas K1
in tests/test_torch_kernels.py).

The CUDA split and GEMM are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.ops import dense_path as jdense
from sparse_matrix_mult_tpu.types import CSRMatrix as JaxCSR
from sparse_matrix_mult_tpu_torch.ops import dense_path as tdense
from sparse_matrix_mult_tpu_torch.ops import triple_product as ttriple
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm

SPLIT_SHAPES = [(1, 1), (7, 13), (128, 64), (300, 500), (129, 700)]


def _jax_halves(x: np.ndarray):
    """The split of the JAX kernel's split3 branch (triu_matmul.py:71-74)."""
    xv = jnp.asarray(x)
    hi = xv.astype(jnp.bfloat16)
    lo = (xv - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return np.asarray(hi.astype(jnp.float32)), np.asarray(lo.astype(jnp.float32))


@pytest.fixture
def config():
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()
    yield
    tsmm.set_config(saved_t)
    jsmm.set_config(saved_j)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rows,k", SPLIT_SHAPES)
def test_split_bf16_plain_matches_jax_split(rows, k, transpose):
    """Two pieces are JAX's hi and lo bit for bit; the padding is zero."""
    rng = np.random.default_rng(rows * 1000 + k)
    x = (rng.standard_normal((rows, k)) * 10.0 ** rng.integers(-3, 4, (rows, k))).astype(np.float32)
    given = np.ascontiguousarray(x.T) if transpose else x
    got = tm.split_bf16(torch.from_numpy(given), 2, transpose=transpose)
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, -(-rows // tm.TILE) * tm.TILE, -(-k // tm.KSTEP) * tm.KSTEP)
    hi, lo = _jax_halves(x)
    pieces = got.to(torch.float32).numpy()
    np.testing.assert_array_equal(pieces[0, :rows, :k], hi)
    np.testing.assert_array_equal(pieces[1, :rows, :k], lo)
    assert not pieces[:, rows:].any() and not pieces[:, :, k:].any()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rows,k", SPLIT_SHAPES)
def test_split_bf16_plain_three_pieces_are_exact(rows, k, transpose):
    """Three pieces sum back to the f32 operand exactly (in f32, in order),
    and the first two are the two-piece split."""
    rng = np.random.default_rng(rows + 7 * k)
    x = (rng.standard_normal((rows, k)) * 10.0 ** rng.integers(-6, 7, (rows, k))).astype(np.float32)
    given = torch.from_numpy(np.ascontiguousarray(x.T) if transpose else x)
    three = tm.split_bf16(given, 3, transpose=transpose)[:, :rows, :k].to(torch.float32)
    assert torch.equal((three[0] + three[1]) + three[2], torch.from_numpy(x))
    two = tm.split_bf16(given, 2, transpose=transpose)[:, :rows, :k].to(torch.float32)
    assert torch.equal(three[:2], two)


def _fake_pair(m, k, n, tbar):
    """Operands whose capacities give ``tbar`` expected terms per entry, in
    both packages (the gate reads only shapes and capacities)."""
    cap = int((tbar * m * k * n) ** 0.5)
    idx, val = np.zeros(cap, np.int32), np.zeros(cap, np.float32)
    ja = JaxCSR(jnp.zeros(m + 1, jnp.int32), jnp.asarray(idx), jnp.asarray(val), (m, k))
    jb = JaxCSR(jnp.zeros(k + 1, jnp.int32), jnp.asarray(idx), jnp.asarray(val), (k, n))
    ta = tsmm.CSRMatrix.from_numpy(np.zeros(m + 1, np.int32), idx, val, (m, k), device="cpu")
    tb = tsmm.CSRMatrix.from_numpy(np.zeros(k + 1, np.int32), idx, val, (k, n), device="cpu")
    return (ja, jb), (ta, tb)


@pytest.mark.parametrize("tbar", [100.0, 5.0, 30.0, 1.0])
@pytest.mark.parametrize("m,k,n", [(1000, 1000, 1000), (500, 2000, 300), (2000, 2000, 2000),
                                   (300, 700, 300), (4096, 16384, 4096),
                                   (10000, 10000, 10000)])
def test_split3_gate_equals_jax(m, k, n, tbar, config):
    """The port's gate against the JAX package's (gate on, its default) on
    the cases of test_split3_gate_term_model and the main path's shapes."""
    (ja, jb), (ta, tb) = _fake_pair(m, k, n, tbar)
    got = tdense._split3_within_oracle(ta, tb)
    assert got == jdense._split3_within_oracle(ja, jb)
    if (m, k, n) == (1000, 1000, 1000) and tbar in (100.0, 5.0):
        assert got == (tbar == 100.0)


def _recording_k1(calls):
    def k1(a, b, transpose_b=False, split3=False):
        calls.append(split3)
        return tm.matmul_triu(a, b, transpose_b=transpose_b, split3=split3)
    return k1


def _recording_k1_pieces(calls):
    """K1's GEMM alone, recording whether its pieces are split3's halves."""
    def k1(ap, bp, m, n):
        calls.append(ap.shape[0] == 2)
        return tm.matmul_triu_pieces(ap, bp, m, n)
    return k1


@pytest.mark.parametrize("m,k", [(200, 300), (260, 140)])
@pytest.mark.parametrize("precision,dense", [("fast", True), (None, True), ("auto", True),
                                             ("fast", False)])
def test_split3_routing_in_the_dense_path(precision, dense, m, k, monkeypatch, config):
    """With the card's K1 branch forced: only an explicit "fast" takes
    split3, and only inside the gate (a dense product passes it, a sparse
    one does not); AUTO resolves to FAST and stays on the full-f32 branch.
    The result is the upper triangle within the branch's bound, and nothing
    is launched."""
    calls = []
    monkeypatch.setattr(tdense, "_triu_kernel_ok", lambda *args: True)
    monkeypatch.setattr(tdense, "matmul_triu", _recording_k1(calls))
    d = 0.5 if dense else 0.01
    a_sp = sp.random(m, k, density=d, format="csr", random_state=1)
    b_sp = sp.random(k, m, density=d, format="csr", random_state=2)
    a, b = tsmm.from_scipy(a_sp, device="cpu"), tsmm.from_scipy(b_sp, device="cpu")
    assert tdense._split3_within_oracle(a, b) == dense
    before = dict(LAUNCHES)
    got = tdense.spgemm_dense_out(a, b, symmetric=True, precision=precision).numpy()
    assert LAUNCHES == before
    assert calls == [precision == "fast" and dense]
    ref = np.triu((a_sp @ b_sp).toarray())
    scale = np.triu((abs(a_sp) @ abs(b_sp)).toarray())
    assert not np.tril(got, -1).any()
    assert np.all(np.abs(got - ref) <= (2.0**-16 if calls[0] else 1e-5) * scale + 1e-7)


@pytest.mark.parametrize("m,n", [(150, 120), (90, 200)])
@pytest.mark.parametrize("precision", ["fast", None])
def test_split3_routing_in_the_triple_product(precision, m, n, monkeypatch, config):
    """The triple product's K1 takes split3 on an explicit "fast" (no gate,
    as in the JAX package), never on AUTO (where K1's GEMM runs on the
    pieces H shares with ``H.Q``)."""
    calls = []
    monkeypatch.setattr(ttriple, "_triu_kernel_ok", lambda *args: True)
    monkeypatch.setattr(ttriple, "matmul_triu", _recording_k1(calls))
    monkeypatch.setattr(ttriple, "matmul_triu_pieces", _recording_k1_pieces(calls))
    h_sp = sp.random(m, n, density=0.2, format="csr", random_state=3)
    q_sp = sp.random(n, n, density=0.2, format="csr", random_state=4)
    h, q = tsmm.from_scipy(h_sp, device="cpu"), tsmm.from_scipy(q_sp, device="cpu")
    got = ttriple.triple_product_dense(h, q, 0, precision=precision).numpy()
    assert calls == [precision == "fast"]
    ref = np.triu((h_sp @ q_sp @ h_sp.T).toarray())
    scale = np.triu((abs(h_sp) @ abs(q_sp) @ abs(h_sp).T).toarray())
    assert np.all(np.abs(got - ref) <= (2.0**-15 if calls[0] else 1e-5) * scale + 1e-7)


def test_split_bf16_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tm.split_bf16(torch.zeros((4, 4)), 4)
    with pytest.raises(ValueError):
        tm.split_bf16(torch.zeros(4), 2)
    with pytest.raises(ValueError):
        tm.split_bf16(torch.empty((4, 4), device="meta"), 2)


@pytest.mark.parametrize("split3", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (300, 500, 200), (100, 700, 260)])
def test_matmul_triu_pieces_plain_computes_the_branch(m, k, n, split3):
    """K1's GEMM alone, on split_bf16's pieces (its plain version here),
    computes the branch its piece count names: within 1e-6 of (|A| |B|) of
    matmul_triu's plain version for that branch."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    pieces = 2 if split3 else 3
    got = tm.matmul_triu_pieces(tm.split_bf16(a, pieces), tm.split_bf16(b, pieces, transpose=True),
                                m, n)
    want = tm.matmul_triu_plain(a, b, split3=split3)
    assert got.shape == (m, n) and got.dtype == torch.float32
    unit = torch.matmul(a.abs().double(), b.abs().double())
    assert bool(((got - want).abs().double() <= 1e-6 * unit).all())


def test_matmul_triu_pieces_rejects_bad_pieces():
    a3 = tm.split_bf16(torch.ones((4, 4)), 3)
    with pytest.raises(ValueError):  # piece counts differ
        tm.matmul_triu_pieces(a3, tm.split_bf16(torch.ones((4, 4)), 2), 4, 4)
    with pytest.raises(ValueError):  # K differs
        tm.matmul_triu_pieces(a3, tm.split_bf16(torch.ones((4, 100)), 3), 4, 4)
    with pytest.raises(ValueError):  # not padded as split_bf16 pads
        tm.matmul_triu_pieces(a3[:, :4, :4], a3[:, :4, :4], 4, 4)
    with pytest.raises(ValueError):  # more rows than the pieces hold
        tm.matmul_triu_pieces(a3, a3, 200, 4)
