"""The port's inversion workflow (models/inversion.py) against the JAX
package's, on the CPU, from the same numpy problem (the generator of
tests/test_inversion.py).

Both packages compute in f64 here; the factorisations differ (Cholesky
with the lower factor here, the upper one in JAX), hence rtol = 1e-10.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.models import inversion as jinv
from sparse_matrix_mult_tpu_torch.models import inversion as tinv

TOL = dict(rtol=1e-10, atol=1e-12)


def _problem(n_obs=12, n_state=40, seed=0):
    rng = np.random.default_rng(seed)
    H = sp.random(n_obs, n_state, density=0.3, format="csr", random_state=seed)
    # SPD prior covariance: A A^T + diag
    A = sp.random(n_state, n_state, density=0.1, format="csr", random_state=seed + 1)
    Q = (A @ A.T + sp.eye(n_state) * 2.0).tocsr()
    y = rng.standard_normal(n_obs)
    x0 = rng.standard_normal(n_state)
    r = rng.random(n_obs) + 0.5
    return H, Q, y, x0, r


def _both(mat):
    j = jsmm.from_scipy(mat)
    t = tsmm.CSRMatrix.from_numpy(*(np.asarray(x) for x in (j.indptr, j.indices, j.values)),
                                  j.shape, device="cpu")
    return j, t


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_invert_equals_jax(seed):
    H, Q, y, x0, r = _problem(seed=seed)
    (jh, th), (jq, tq) = _both(H), _both(Q)
    got = tinv.invert(th, tq, *(torch.from_numpy(v) for v in (y, x0, r)))
    want = jinv.invert(jh, jq, y, x0, r)
    assert isinstance(got, tinv.InversionResult) and got._fields == want._fields
    for field, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.float64, field
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=field, **TOL)
    # Posterior variances shrink relative to the prior.
    assert torch.all(got.p_diag <= torch.from_numpy(Q.diagonal()) + 1e-9)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_posterior_covariance_equals_jax(seed):
    H, Q, _, _, r = _problem(seed=seed)
    (jh, th), (jq, tq) = _both(H), _both(Q)
    got = tinv.posterior_covariance(th, tq, torch.from_numpy(r))
    want = np.asarray(jinv.posterior_covariance(jh, jq, r))
    assert got.shape == (40, 40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    res = tinv.invert(th, tq, torch.zeros(12, dtype=torch.float64),
                      torch.zeros(40, dtype=torch.float64), torch.from_numpy(r))
    np.testing.assert_allclose(torch.diagonal(got).numpy(), res.p_diag.numpy(), **TOL)


def test_rectangular_problem_against_the_dense_formula():
    """A wider problem (n_obs << n_state) against the textbook dense update."""
    H, Q, y, x0, r = _problem(n_obs=20, n_state=150, seed=11)
    _, th = _both(H)
    _, tq = _both(Q)
    got = tinv.invert(th, tq, *(torch.from_numpy(v) for v in (y, x0, r)))
    Hd, Qd = H.toarray(), Q.toarray()
    S = Hd @ Qd @ Hd.T + np.diag(r)
    K = Qd @ Hd.T @ np.linalg.inv(S)
    np.testing.assert_allclose(got.s.numpy(), S, rtol=1e-10)
    np.testing.assert_allclose(got.x_post.numpy(), x0 + K @ (y - Hd @ x0), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.p_diag.numpy(), np.diag(Qd - K @ Hd @ Qd), rtol=1e-8,
                               atol=1e-10)
