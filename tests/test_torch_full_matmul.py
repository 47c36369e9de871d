"""The full f32 matmul ``matmul_full`` (its plain version, on the CPU)
against the JAX package's ``jnp.dot(..., precision="highest")`` and f64
numpy, and the routes that reach it: ``policy_matmul`` FAST and SPLIT, the
triple product's card branch and chain, and the inversion.

The six passes of three bf16 pieces drop terms below f32 rounding, so the
plain version is held to 1e-6 of (|A| |B|) elementwise.  The CUDA kernel is
held against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.ops.triple_product import triple_product_dense as jax_triple
from sparse_matrix_mult_tpu_torch.models import inversion as tinv
from sparse_matrix_mult_tpu_torch.ops import matmul as tmatmul
from sparse_matrix_mult_tpu_torch.ops import triple_product as ttriple
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES
from sparse_matrix_mult_tpu_torch.ops.kernels import full_matmul as fm
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm
from sparse_matrix_mult_tpu_torch.parallel import distributed as td

# (m, k, n): one entry; off the tile and K-step edges; crossing both; a
# ring slot's panel (a slot's rows times one K block of B).
SHAPES = [(1, 1, 1), (130, 200, 70), (257, 65, 129), (48, 25, 300)]
TOL = 1e-6  # of (|A| |B|)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) * 10.0 ** rng.integers(-2, 3, (m, k))).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 10.0 ** rng.integers(-2, 3, (k, n))).astype(np.float32)
    return a, b


def _unit(a, b):
    return np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_full_plain_equals_jax_highest(m, k, n):
    """The six passes agree with JAX's HIGHEST f32 dot on the CPU and with
    the f64 product, within 1e-6 of (|A| |B|)."""
    a, b = _operands(m, k, n, m + k + n)
    got = fm.matmul_full(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    got = got.numpy().astype(np.float64)
    unit = _unit(a, b)
    want_jax = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b), precision="highest"))
    assert want_jax.dtype == np.float32
    assert np.all(np.abs(got - want_jax) <= TOL * unit)
    assert np.all(np.abs(got - a.astype(np.float64) @ b.astype(np.float64)) <= TOL * unit)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_transpose_b_form_is_bit_identical(m, k, n):
    """``a @ b.T`` of B given as (N, K) gives the bits of ``a @ b``."""
    a, b = (torch.from_numpy(x) for x in _operands(m, k, n, 3 * m + k))
    want = fm.matmul_full(a, b)
    assert torch.equal(fm.matmul_full(a, b.T.contiguous(), transpose_b=True), want)
    assert torch.equal(fm.matmul_full_plain(a, b), want)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_pieces_plain_upper_tiles_are_k1s(m, k, n):
    """On the same pieces, the full GEMM's plain version has K1's plain
    version's bits on every upper tile (ti <= tj)."""
    a, b = (torch.from_numpy(x) for x in _operands(m, k, n, m + 5 * n))
    ap, bp = tm.split_bf16(a, 3), tm.split_bf16(b, 3, transpose=True)
    got = fm.matmul_full_pieces(ap, bp, m, n)
    tiles = torch.arange(m)[:, None] // tm.TILE <= torch.arange(n) // tm.TILE
    assert torch.equal(got[tiles], tm.matmul_triu_pieces(ap, bp, m, n)[tiles])
    assert torch.equal(got, fm.matmul_full(a, b))


BAD = {
    "mismatched_k": (torch.ones((4, 5)), torch.ones((6, 3)), False, ValueError),
    "mismatched_k_transposed": (torch.ones((4, 5)), torch.ones((3, 6)), True, ValueError),
    "f64": (torch.ones((4, 5), dtype=torch.float64), torch.ones((5, 3)), False, TypeError),
    "not_contiguous": (torch.ones((5, 4)).T, torch.ones((5, 3)), False, ValueError),
    "three_d": (torch.ones((2, 4, 5)), torch.ones((5, 3)), False, ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_matmul_full_checks_raise(case):
    a, b, transpose_b, error = BAD[case]
    with pytest.raises(error):
        fm.matmul_full(a, b, transpose_b=transpose_b)


def test_matmul_full_pieces_rejects_bad_pieces():
    a3 = tm.split_bf16(torch.ones((4, 4)), 3)
    with pytest.raises(ValueError):  # two pieces: split3's, not HIGHEST's
        fm.matmul_full_pieces(tm.split_bf16(torch.ones((4, 4)), 2), a3, 4, 4)
    with pytest.raises(ValueError):  # K differs
        fm.matmul_full_pieces(a3, tm.split_bf16(torch.ones((4, 100)), 3), 4, 4)
    with pytest.raises(ValueError):  # not padded as split_bf16 pads
        fm.matmul_full_pieces(a3[:, :4, :4], a3[:, :4, :4], 4, 4)
    with pytest.raises(ValueError):  # more rows than the pieces hold
        fm.matmul_full_pieces(a3, a3, 4, 200)


@pytest.mark.parametrize("m,k,n", [(0, 5, 3), (4, 0, 3), (4, 5, 0), (0, 0, 0)])
@pytest.mark.parametrize("transpose_b", [False, True])
def test_empty_operands_give_zeros(m, k, n, transpose_b):
    a = torch.ones((m, k))
    b = torch.ones((n, k) if transpose_b else (k, n))
    before = dict(LAUNCHES)
    got = fm.matmul_full(a, b, transpose_b=transpose_b)
    assert LAUNCHES == before
    assert got.shape == (m, n) and got.dtype == torch.float32 and not got.any()


# ---------------------------------------------------------------- routes ----

def _recorder(calls, name, fn):
    def record(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    return record


@pytest.mark.parametrize("split3", [False, True])
@pytest.mark.parametrize("m,n", [(150, 120), (90, 200)])
def test_fast_dense_equals_jax_triple(m, n, split3, monkeypatch):
    """The triple's card branch on dense f32 H and Q, with the plain
    kernels: under HIGHEST H is split once (three splits in all: H, Q, T)
    and the same pieces are A of H.Q and B of T.H^T; its upper triangle
    agrees with JAX's triple_product_dense within the oracle (split3 within
    its three-pass bound)."""
    h_sp = sp.random(m, n, density=0.2, format="csr", random_state=m)
    q_sp = sp.random(n, n, density=0.2, format="csr", random_state=n)
    h_sp.data = 2.0 * h_sp.data - 1.0
    splits, pieces = [], {}
    real_split, real_full, real_triu = ttriple.split_bf16, ttriple.matmul_full_pieces, \
        ttriple.matmul_triu_pieces

    def split(x, p, transpose=False):
        out = real_split(x, p, transpose=transpose)
        splits.append(out)
        return out

    def full(ap, bp, mm, nn):
        pieces["full_a"] = ap
        return real_full(ap, bp, mm, nn)

    def triu(ap, bp, mm, nn):
        pieces["triu_b"] = bp
        return real_triu(ap, bp, mm, nn)

    monkeypatch.setattr(ttriple, "split_bf16", split)
    monkeypatch.setattr(ttriple, "matmul_full_pieces", full)
    monkeypatch.setattr(ttriple, "matmul_triu_pieces", triu)
    hd = torch.from_numpy(h_sp.toarray().astype(np.float32))
    qd = torch.from_numpy(q_sp.toarray().astype(np.float32))
    got = torch.triu(ttriple._fast_dense(hd, qd, split3)).numpy()
    if split3:
        assert splits == [] and pieces == {}
    else:
        assert len(splits) == 3 and pieces["full_a"] is pieces["triu_b"] is splits[0]
    want = np.asarray(jax_triple(jsmm.from_scipy(h_sp), jsmm.from_scipy(q_sp), 0))
    scale = np.triu((abs(h_sp) @ abs(q_sp) @ abs(h_sp).T).toarray())
    assert np.all(np.abs(got - want) <= (2.0**-15 if split3 else 1e-5) * scale + 1e-7)


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors take the card's policy; every full GEMM call (and its
    GEMM alone) is recorded and runs its plain version."""
    calls = []
    monkeypatch.setattr(tmatmul, "_on_card", lambda x: True)
    monkeypatch.setattr(tmatmul, "matmul_full", _recorder(calls, "matmul_full", fm.matmul_full))
    monkeypatch.setattr(ttriple, "matmul_full", _recorder(calls, "matmul_full", fm.matmul_full))
    monkeypatch.setattr(ttriple, "matmul_full_pieces",
                        _recorder(calls, "matmul_full_pieces", fm.matmul_full_pieces))
    return calls


@pytest.mark.parametrize("precision,calls_want", [("fast", 1), ("split", 3), ("strict", 0)])
def test_policy_matmul_reaches_matmul_full(precision, calls_want, on_card):
    """FAST is one full GEMM and SPLIT three; STRICT stays torch.matmul in
    the native dtype."""
    a, b = _operands(70, 90, 50, 5)
    a64 = torch.from_numpy(a.astype(np.float64)) * (1 + 1e-9)
    got = tmatmul.policy_matmul(a64, torch.from_numpy(b).double(), precision)
    assert on_card == ["matmul_full"] * calls_want
    assert got.dtype == torch.float64
    unit = _unit(a, b)
    want = a64.numpy() @ b.astype(np.float64)
    assert np.all(np.abs(got.numpy() - want) <= (1e-12 if precision == "strict" else TOL) * unit)


def test_policy_matmul_takes_ring_layouts(on_card, monkeypatch):
    """A ring's operands: a column slice of A (copied contiguous) and a
    transposed view of B (the transpose_b form, no copy): the bits of the
    contiguous product."""
    forms = []
    monkeypatch.setattr(tmatmul, "matmul_full",
                        lambda a, b, transpose_b=False: forms.append(transpose_b)
                        or fm.matmul_full(a, b, transpose_b=transpose_b))
    a, b = (torch.from_numpy(x) for x in _operands(64, 120, 80, 9))
    panel, bt = a[:, 30:90], b[30:90].T.contiguous()
    got = td._contract(panel, bt.T, torch.float32)
    assert forms == [True]
    assert torch.equal(got, fm.matmul_full(panel.contiguous(), b[30:90].contiguous()))


def test_triple_card_branch_reaches_matmul_full(on_card, monkeypatch):
    """The K1 branch: one full GEMM on the pieces under HIGHEST, one full
    product under split3."""
    monkeypatch.setattr(ttriple, "_triu_kernel_ok", lambda *args: True)
    h_sp = sp.random(90, 110, density=0.2, format="csr", random_state=1)
    q_sp = sp.random(110, 110, density=0.2, format="csr", random_state=2)
    h, q = tsmm.from_scipy(h_sp, device="cpu"), tsmm.from_scipy(q_sp, device="cpu")
    ttriple.triple_product_dense(h, q, 1)
    assert on_card == ["matmul_full_pieces"]
    ttriple.triple_product_dense(h, q, 1, precision="fast")
    assert on_card == ["matmul_full_pieces", "matmul_full"]


def test_triple_chain_reaches_matmul_full(on_card):
    """The chained FAST branch is JAX's two HIGHEST dots, H.Q then T.H^T."""
    h_sp = sp.random(60, 90, density=0.2, format="csr", random_state=3)
    q_sp = sp.random(90, 90, density=0.2, format="csr", random_state=4)
    hd = torch.from_numpy(h_sp.toarray().astype(np.float32))
    qd = torch.from_numpy(q_sp.toarray().astype(np.float32))
    got = ttriple._chain(hd, qd).numpy()
    assert on_card == ["matmul_full", "matmul_full"]
    want = (h_sp @ q_sp @ h_sp.T).toarray()
    scale = (abs(h_sp) @ abs(q_sp) @ abs(h_sp).T).toarray()
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-7)


def _inversion_problem(n_obs=24, n_state=60, seed=5):
    rng = np.random.default_rng(seed)
    h = sp.random(n_obs, n_state, density=0.2, format="csr", random_state=seed)
    a = sp.random(n_state, n_state, density=0.1, format="csr", random_state=seed + 1)
    sym = ((a + a.T) * 0.5).tocsr()
    q = (sym + sp.diags(1.0 + np.asarray(abs(sym).sum(axis=1)).ravel())).tocsr()
    return (tsmm.from_scipy(h, device="cpu"), tsmm.from_scipy(q, device="cpu"),
            torch.from_numpy(rng.standard_normal(n_obs)),
            torch.from_numpy(rng.standard_normal(n_state)),
            torch.from_numpy(0.5 + rng.random(n_obs)))


def test_inversion_reaches_matmul_full(on_card):
    """``Q H^T`` in invert, and ``Q H^T`` and ``(Q H^T) K^T`` in
    posterior_covariance, go through the full GEMM (the triple product's
    own products stay on its CPU branch here); the results agree with the
    native f64 run within f32 rounding."""
    h, q, y, x0, r = _inversion_problem()
    got = tinv.invert(h, q, y, x0, r)
    assert on_card == ["matmul_full"]
    cov = tinv.posterior_covariance(h, q, r)
    assert on_card == ["matmul_full"] * 3
    on_card.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmatmul, "_on_card", lambda x: False)
        want = tinv.invert(h, q, y, x0, r)
        want_cov = tinv.posterior_covariance(h, q, r)
    assert on_card == []
    for g, w in ((got.x_post, want.x_post), (got.p_diag, want.p_diag), (cov, want_cov)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
