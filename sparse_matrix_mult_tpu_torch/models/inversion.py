"""Linear (Bayesian) inverse-problem workflow built on the triple product.

Counterpart of :mod:`sparse_matrix_mult_tpu.models.inversion`, formula for
formula.  Given observations ``y = H x + eps`` with a sparse Jacobian H
(n_obs x n_state), a sparse prior covariance Q (n_state x n_state), a prior
mean ``x0`` and a diagonal observation-noise covariance ``r_diag`` (n_obs):

* ``S = H Q H^T + diag(R)``  -- the triple product, mirrored to full;
* ``x_post = x0 + (Q H^T) S^{-1} (y - H x0)``;
* ``P_diag = diag(Q) - rowsum((Q H^T) * (S^{-1} H Q)^T)`` -- posterior
  marginal variances without forming the posterior covariance.

Dense operands are float32 on the card and keep their dtype on the CPU, as
the JAX package computes in float32 on the TPU.  The products the JAX
package writes as ``jnp.dot(..., precision="highest")`` (``Q H^T`` and, in
:func:`posterior_covariance`, ``(Q H^T) K^T``) go through
:func:`~sparse_matrix_mult_tpu_torch.ops.matmul.policy_matmul` (FAST): on
the card the six-pass bf16 GEMM ``matmul_full`` on the tensor cores, on the
CPU ``torch.matmul`` in the operands' dtype; the matrix-vector products
run in full FP32
(:func:`~sparse_matrix_mult_tpu_torch.ops.matmul.full_fp32`); S is factored
by Cholesky.  Plain eager functions: ``y``, ``x0`` and ``r_diag`` are
tensors on the operands' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.convert import csr_to_dense
from ..ops.matmul import full_fp32, policy_matmul
from ..ops.triple_product import triple_product_dense
from ..types import CSRMatrix

__all__ = ["InversionResult", "invert", "posterior_covariance"]


class InversionResult(NamedTuple):
    x_post: torch.Tensor  # (n_state,) posterior mean
    p_diag: torch.Tensor  # (n_state,) posterior marginal variances
    innovation: torch.Tensor  # (n_obs,) y - H x0
    s: torch.Tensor  # (n_obs, n_obs) innovation covariance (HQH^T + R)


def _dense_ops(h: CSRMatrix, q: CSRMatrix):
    compute = torch.float32 if h.device.type == "cuda" else None
    return csr_to_dense(h, compute), csr_to_dense(q, compute)


def _innovation_covariance(h: CSRMatrix, q: CSRMatrix, r_diag: torch.Tensor, dt):
    hqht = triple_product_dense(h, q, compute_full_matrix=1)
    return hqht.to(dt) + torch.diag(r_diag.to(dt))


def invert(h: CSRMatrix, q: CSRMatrix, y: torch.Tensor, x0: torch.Tensor,
           r_diag: torch.Tensor) -> InversionResult:
    """One batch linear-inversion step (posterior mean and marginal variances).

    ``h`` is the (n_obs, n_state) sparse Jacobian, ``q`` the (n_state,
    n_state) sparse prior covariance, ``r_diag`` the diagonal observation
    noise.
    """
    hd, qd = _dense_ops(h, q)
    dt = hd.dtype
    s = _innovation_covariance(h, q, r_diag, dt)
    qht = policy_matmul(qd, hd.T)  # (n_state, n_obs)
    with full_fp32():
        innov = y.to(dt) - torch.matmul(hd, x0.to(dt))
        chol = torch.linalg.cholesky(s)
        x_post = x0.to(dt) + torch.matmul(qht, torch.cholesky_solve(innov[:, None], chol)[:, 0])
        # Posterior marginal variances: diag(Q - Q H^T S^-1 H Q).
        kt = torch.cholesky_solve(qht.T, chol)  # (n_obs, n_state)
        p_diag = torch.diagonal(qd) - torch.sum(qht * kt.T, dim=1)
    return InversionResult(x_post=x_post, p_diag=p_diag, innovation=innov, s=s)


def posterior_covariance(h: CSRMatrix, q: CSRMatrix, r_diag: torch.Tensor) -> torch.Tensor:
    """Full posterior covariance ``Q - Q H^T (HQH^T + R)^{-1} H Q``.

    Materializes the (n_state, n_state) result; use :func:`invert` when only
    marginal variances are needed.
    """
    hd, qd = _dense_ops(h, q)
    s = _innovation_covariance(h, q, r_diag, hd.dtype)
    qht = policy_matmul(qd, hd.T)
    with full_fp32():
        kt = torch.cholesky_solve(qht.T, torch.linalg.cholesky(s))
    return qd - policy_matmul(qht, kt)
