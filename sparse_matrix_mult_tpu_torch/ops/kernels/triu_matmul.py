"""Upper-tile-only matmul on the tensor cores (``csrc/triu_matmul.cu``) and
the bf16 split it multiplies, each with its plain version.

K1 -- replaces ``sparse_matrix_mult_tpu/ops/pallas/triu_matmul.py::_kernel``
in both of its branches.  ``a @ b`` (or ``a @ b.T``) is computed only on the
128x128 output tiles with ``ti <= tj``; every other entry of the result is
undefined, so callers MUST mask with ``torch.triu``, which selects and never
multiplies (an unwritten entry may hold NaN).

* HIGHEST (``split3=False``): a full f32 product.  On the card each operand
  is split into three bf16 pieces (exact) and six bf16 passes are summed in
  fp32.  The plain version is ``torch.matmul`` in full FP32.
* split3 (``split3=True``): two bf16 halves ``x ~= hi + lo`` and the three
  passes ``hh + hl + lh``, as the JAX kernel's split3 branch; the dropped
  ``lo * lo`` term leaves a relative error of about 2^-16 per product.  The
  plain version sums the same three products of the halves in f32.

:func:`split_bf16` is the split kernel both branches start with: the bf16
pieces of an f32 operand, K-major and zero-padded for the GEMM's tiles;
:func:`matmul_triu_pieces` is the GEMM alone, on such pieces.
"""

from __future__ import annotations

import torch

from .._precision import full_fp32
from . import _build

__all__ = ["matmul_triu", "matmul_transpose_triu", "matmul_triu_pieces",
           "matmul_triu_pieces_plain", "matmul_triu_plain", "split_bf16", "split_bf16_plain",
           "TILE", "KSTEP"]

TILE = 128  # output tile edge; the pieces' rows are padded to it
KSTEP = 64  # the GEMM's K-step; the pieces' K is padded to it


def _pad(x: int, to: int) -> int:
    return -(-x // to) * to


def _split_shape(x: torch.Tensor, transpose: bool):
    """(rows, K) of the operand that ``x`` holds: ``x`` itself, or ``x.T``."""
    if x.ndim != 2:
        raise ValueError("split_bf16 takes a 2-D matrix")
    return (x.shape[1], x.shape[0]) if transpose else (x.shape[0], x.shape[1])


def _split_k_pad(k: int, k_pad: int | None) -> int:
    if k_pad is None:
        return _pad(max(k, 1), KSTEP)
    if k_pad < k or k_pad <= 0 or k_pad % KSTEP:
        raise ValueError(f"k_pad must be a positive multiple of {KSTEP} and >= {k}, got {k_pad}")
    return k_pad


def split_bf16_plain(x: torch.Tensor, pieces: int, transpose: bool = False,
                     k_pad: int | None = None) -> torch.Tensor:
    rows, k = _split_shape(x, transpose)
    out = torch.zeros((pieces, _pad(rows, TILE), _split_k_pad(k, k_pad)), dtype=torch.bfloat16,
                      device=x.device)
    rest = (x.T if transpose else x).to(torch.float32)
    for p in range(pieces):
        piece = rest.to(torch.bfloat16)
        out[p, :rows, :k] = piece
        rest = rest - piece.to(torch.float32)
    return out


def split_bf16(x: torch.Tensor, pieces: int, transpose: bool = False,
               k_pad: int | None = None) -> torch.Tensor:
    """The bf16 pieces of the f32 operand ``x`` (or of ``x.T`` with
    ``transpose``), K-major: a (pieces, rows_pad, k_pad) array, rows padded
    to :data:`TILE` and K to :data:`KSTEP` (or to ``k_pad``, a multiple of
    it) with zeros.  Each piece is the bf16 rounding of what the pieces
    before it left, so three pieces hold an f32 exactly and two are JAX's
    ``hi``/``lo`` halves."""
    if pieces not in (2, 3):
        raise ValueError(f"split_bf16 makes 2 or 3 pieces, not {pieces}")
    rows, k = _split_shape(x, transpose)
    k_pad = _split_k_pad(k, k_pad)
    if not _build.is_cuda(x):
        return split_bf16_plain(x, pieces, transpose, k_pad)
    if x.dtype != torch.float32:
        raise TypeError("the CUDA split_bf16 kernel takes a float32 matrix")
    if not x.is_contiguous():
        raise ValueError("split_bf16 takes a contiguous matrix")
    out = torch.empty((pieces, _pad(rows, TILE), k_pad), dtype=torch.bfloat16, device=x.device)
    code = _build.launch(
        "smm_split_bf16", x.device,
        x.data_ptr(), out.data_ptr(), rows, k, out.shape[1], out.shape[2], pieces, int(transpose),
    )
    _build.LAUNCHES["split_bf16"] += 1
    _build.check(code, "split_bf16")
    return out


def matmul_triu_plain(a: torch.Tensor, b: torch.Tensor, transpose_b: bool = False,
                      split3: bool = False) -> torch.Tensor:
    bt = b.T if transpose_b else b
    if not split3:
        with full_fp32():
            return torch.matmul(a, bt)
    m, k = a.shape
    ah, al = split_bf16_plain(a, 2)[:, :m, :k].to(torch.float32)
    bh, bl = split_bf16_plain(bt, 2, transpose=True)[:, : bt.shape[1], :k].to(torch.float32)
    with full_fp32():  # bf16 x bf16 products are exact in f32
        return torch.matmul(ah, bh.T) + torch.matmul(ah, bl.T) + torch.matmul(al, bh.T)


def matmul_triu(a: torch.Tensor, b: torch.Tensor, transpose_b: bool = False,
                split3: bool = False) -> torch.Tensor:
    """Upper-tile-only ``a @ b`` (``b`` is (K, N)), or ``a @ b.T`` with
    ``transpose_b`` (``b`` is (N, K)); ``split3`` takes the three-pass
    branch.  On the card: :func:`split_bf16` for each operand, then the
    tensor-core GEMM (three launches)."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("matmul_triu takes 2-D matrices")
    m, k = a.shape
    n, kb = (b.shape[0], b.shape[1]) if transpose_b else (b.shape[1], b.shape[0])
    if kb != k:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} and {tuple(b.shape)}")
    if not _build.is_cuda(a, b):
        return matmul_triu_plain(a, b, transpose_b, split3)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("the CUDA matmul_triu kernel takes float32 operands")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_triu takes contiguous operands")
    if max(m, n, k) >= 2**31:
        raise ValueError("matmul_triu: dimensions must fit in int32")
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32, device=a.device)
    pieces = 2 if split3 else 3
    return matmul_triu_pieces(split_bf16(a, pieces), split_bf16(b, pieces, transpose=not transpose_b),
                              m, n)


def matmul_triu_pieces_plain(ap: torch.Tensor, bp: torch.Tensor, m: int, n: int) -> torch.Tensor:
    pieces = ap.shape[0]
    c = torch.zeros((m, n), dtype=torch.float32, device=ap.device)
    with full_fp32():  # bf16 x bf16 products are exact in f32
        for i in range(pieces):
            for j in range(pieces - i):  # the passes whose pieces' orders sum below P
                c += torch.matmul(ap[i, :m].to(torch.float32), bp[j, :n].to(torch.float32).T)
    return c


def matmul_triu_pieces(ap: torch.Tensor, bp: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """K1's GEMM alone, on the pieces :func:`split_bf16` made of A (m rows)
    and of B (n rows, K-major): the upper tiles of the (m, n) product.  Two
    pieces each run split3's three passes, three run HIGHEST's six."""
    if ap.shape[0] != bp.shape[0] or ap.shape[2] != bp.shape[2] or ap.shape[0] not in (2, 3):
        raise ValueError(f"mismatched pieces: {tuple(ap.shape)} and {tuple(bp.shape)}")
    if ap.shape[1] % TILE or bp.shape[1] % TILE or ap.shape[2] % KSTEP:
        raise ValueError("pieces must be padded to TILE rows and a multiple of KSTEP (split_bf16)")
    if m > ap.shape[1] or n > bp.shape[1]:
        raise ValueError(f"({m}, {n}) exceeds the pieces' rows {ap.shape[1]}, {bp.shape[1]}")
    if not _build.is_cuda(ap, bp):
        return matmul_triu_pieces_plain(ap, bp, m, n)
    if ap.dtype != torch.bfloat16 or bp.dtype != torch.bfloat16:
        raise TypeError("matmul_triu_pieces takes bfloat16 pieces")
    if not (ap.is_contiguous() and bp.is_contiguous()):
        raise ValueError("matmul_triu_pieces takes contiguous pieces")
    c = torch.empty((m, n), dtype=torch.float32, device=ap.device)
    code = _build.launch(
        "smm_matmul_triu_bf16", ap.device,
        ap.data_ptr(), bp.data_ptr(), c.data_ptr(), m, n, ap.shape[1], bp.shape[1], ap.shape[2],
        ap.shape[0],
    )
    _build.LAUNCHES["matmul_triu"] += 1
    _build.check(code, "matmul_triu")
    return c


def matmul_transpose_triu(a: torch.Tensor, b: torch.Tensor, split3: bool = False) -> torch.Tensor:
    """Upper-tile-only ``a @ b.T`` (see :func:`matmul_triu`)."""
    return matmul_triu(a, b, transpose_b=True, split3=split3)
