"""Full f32 matmul on the tensor cores (``csrc/full_matmul.cu``), with its
plain version.

Stands for the JAX package's ``jnp.dot(a, b, precision="highest")`` on f32
operands (no Pallas kernel: XLA runs HIGHEST as six bf16 passes on the TPU's
matrix unit).  On the card each operand is split into three bf16 pieces
(exact, :func:`~.triu_matmul.split_bf16`) and the six passes 20, 11, 02, 10,
01, 00 are summed in fp32 over every 128x128 output tile, on K1's core: a
tile both kernels compute gets the same bits.  The plain version sums the
same six passes of the same pieces in full FP32.

:func:`matmul_full_pieces` is the GEMM alone, on such pieces.
"""

from __future__ import annotations

import torch

from . import _build
from .triu_matmul import KSTEP, TILE, matmul_triu_pieces_plain, split_bf16, split_bf16_plain

__all__ = ["matmul_full", "matmul_full_plain", "matmul_full_pieces", "matmul_full_pieces_plain"]

PIECES = 3  # HIGHEST: three bf16 pieces of each operand, six passes


def _dims(a: torch.Tensor, b: torch.Tensor, transpose_b: bool):
    """(m, n, k) of ``a @ b`` (``b`` is (K, N)), or of ``a @ b.T``."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("matmul_full takes 2-D matrices")
    m, k = a.shape
    n, kb = (b.shape[0], b.shape[1]) if transpose_b else (b.shape[1], b.shape[0])
    if kb != k:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} and {tuple(b.shape)}")
    return m, n, k


def _check_f32(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("matmul_full takes float32 operands")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_full takes contiguous operands")
    if max(m, n, k) >= 2**31:
        raise ValueError("matmul_full: dimensions must fit in int32")


def matmul_full_pieces_plain(ap: torch.Tensor, bp: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The six passes of the pieces summed in full FP32, in the order of
    K1's plain version (which computes every tile)."""
    return matmul_triu_pieces_plain(ap, bp, m, n)


def matmul_full_plain(a: torch.Tensor, b: torch.Tensor, transpose_b: bool = False) -> torch.Tensor:
    m, n, k = _dims(a, b, transpose_b)
    _check_f32(a, b, m, n, k)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    return matmul_full_pieces_plain(split_bf16_plain(a, PIECES),
                                    split_bf16_plain(b, PIECES, transpose=not transpose_b), m, n)


def matmul_full(a: torch.Tensor, b: torch.Tensor, transpose_b: bool = False) -> torch.Tensor:
    """``a @ b`` (``b`` is (K, N)), or ``a @ b.T`` with ``transpose_b`` (``b``
    is (N, K)), both f32, at HIGHEST: every entry of the (m, n) result.  On
    the card: :func:`split_bf16` for each operand, then the tensor-core GEMM
    (three launches); m, n or K of 0 gives zeros and launches nothing."""
    m, n, k = _dims(a, b, transpose_b)
    if not _build.is_cuda(a, b):
        return matmul_full_plain(a, b, transpose_b)
    _check_f32(a, b, m, n, k)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    return matmul_full_pieces(split_bf16(a, PIECES),
                              split_bf16(b, PIECES, transpose=not transpose_b), m, n)


def matmul_full_pieces(ap: torch.Tensor, bp: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The GEMM alone, on the three pieces :func:`split_bf16` made of A (m
    rows) and of B (n rows, K-major): the whole (m, n) product."""
    if ap.ndim != 3 or bp.ndim != 3 or ap.shape[0] != PIECES or bp.shape[0] != PIECES \
            or ap.shape[2] != bp.shape[2]:
        raise ValueError(f"mismatched pieces: {tuple(ap.shape)} and {tuple(bp.shape)}")
    if ap.shape[1] % TILE or bp.shape[1] % TILE or ap.shape[2] % KSTEP or not ap.shape[2]:
        raise ValueError("pieces must be padded to TILE rows and a multiple of KSTEP (split_bf16)")
    if m > ap.shape[1] or n > bp.shape[1]:
        raise ValueError(f"({m}, {n}) exceeds the pieces' rows {ap.shape[1]}, {bp.shape[1]}")
    if not _build.is_cuda(ap, bp):
        return matmul_full_pieces_plain(ap, bp, m, n)
    if ap.dtype != torch.bfloat16 or bp.dtype != torch.bfloat16:
        raise TypeError("matmul_full_pieces takes bfloat16 pieces")
    if not (ap.is_contiguous() and bp.is_contiguous()):
        raise ValueError("matmul_full_pieces takes contiguous pieces")
    c = torch.empty((m, n), dtype=torch.float32, device=ap.device)
    if m == 0 or n == 0:
        return c
    code = _build.launch(
        "smm_matmul_full_bf16", ap.device,
        ap.data_ptr(), bp.data_ptr(), c.data_ptr(), m, n, ap.shape[1], bp.shape[1], ap.shape[2],
        PIECES,
    )
    _build.LAUNCHES["matmul_full"] += 1
    _build.check(code, "matmul_full")
    return c
