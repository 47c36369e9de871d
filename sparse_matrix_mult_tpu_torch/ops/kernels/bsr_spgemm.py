"""BSR products (``csrc/bsr_spgemm.cu``), their plain versions, and the
host pair planner.

* K5 :func:`bsr_matmul_dense` -- BSR A x dense B -> dense; replaces
  ``sparse_matrix_mult_tpu/ops/pallas/bsr_spgemm.py::_kernel``.  On the card
  it is K1's tensor-core GEMM core with a gathered K, at HIGHEST precision as
  the JAX kernel: :func:`bsr_split` makes the bf16 pieces of both operands
  (two ``split_bf16`` launches), :func:`bsr_matmul_dense_pieces` multiplies
  them (one ``bsr_matmul_dense`` launch).
* K6 :func:`bsr_bsr_matmul_dense` -- BSR A x BSR B -> dense over the block
  pairs :func:`bsr_pair_plan` lists; replaces ``bsr_spgemm.py::_kernel_bb``.
  On the card it is the same GEMM core with a pair schedule, at HIGHEST:
  :func:`bsr_bsr_split` makes the pieces of both operands' stored blocks
  (two ``split_bf16`` launches), :func:`bsr_pair_runs` checks the tables and
  finds each output block's run of pairs (one ``bsr_pair_runs`` launch),
  :func:`bsr_bsr_matmul_dense_pieces` multiplies (one ``bsr_bsr_matmul_dense``
  launch), then reads the check's flag (the call's one host synchronisation).
  A whole call makes those launches from one host call.

Zero blocks are skipped: no load, no multiply.  The CUDA kernels take
float32 and 128x128 blocks only; the plain versions take any block size and
float dtype, and run their f32 products in full FP32 (never TF32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...types import bucket_capacity
from ...types_bsr import BSRMatrix, _tobsr_padded, bsr_to_dense
from .._precision import full_fp32
from . import _build
from .triu_matmul import KSTEP, TILE, split_bf16

__all__ = [
    "bsr_pair_plan",
    "bsr_split",
    "bsr_matmul_dense",
    "bsr_matmul_dense_plain",
    "bsr_matmul_dense_pieces",
    "bsr_matmul_dense_pieces_plain",
    "bsr_bsr_split",
    "bsr_pair_runs",
    "bsr_pair_runs_plain",
    "bsr_bsr_matmul_dense",
    "bsr_bsr_matmul_dense_plain",
    "bsr_bsr_matmul_dense_pieces",
    "bsr_bsr_matmul_dense_pieces_plain",
]

KERNEL_BLOCK = 128  # the only block edge the CUDA kernels take


def bsr_pair_plan(a_sp, b_sp, block_size: int, bs_a=None, bs_b=None):
    """Host-side block-pair schedule for :func:`bsr_bsr_matmul_dense`.

    Walks the two scipy operands' block patterns (the same
    :func:`_tobsr_padded` results as the containers, so slot ids line up;
    pass ``bs_a``/``bs_b`` to share them) and returns, sorted by output block
    (ci, cj), a dict with ``pa``/``pb`` (A/B block slots per pair),
    ``ci``/``cj`` (output block coordinates), ``first`` (run-start flags),
    ``mask`` (the (nbr, nbc) visited-block mask), ``n_pairs`` and
    ``n_a_blocks``.  The pair tables are padded to a power of two as in the
    JAX planner (padding pairs point at the dummy block-row ``nbr``).
    Returns ``None`` for an empty product.
    """
    if bs_a is None:
        bs_a = _tobsr_padded(a_sp, block_size)
    if bs_b is None:
        bs_b = _tobsr_padded(b_sp, block_size)
    na = int(bs_a.indptr[-1])
    nbr = len(bs_a.indptr) - 1
    nbc = -(-b_sp.shape[1] // block_size)
    if na == 0 or int(bs_b.indptr[-1]) == 0:
        return None
    rows_a = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(bs_a.indptr))  # block-row per A slot
    kk = bs_a.indices[:na].astype(np.int64)  # contraction block per A slot
    lens = np.diff(bs_b.indptr)[kk]
    ends = np.cumsum(lens)
    starts = ends - lens
    n_pairs = int(ends[-1])
    if n_pairs == 0:
        return None
    ta = np.repeat(np.arange(na, dtype=np.int64), lens)
    off = np.arange(n_pairs, dtype=np.int64) - np.repeat(starts, lens)
    tb = bs_b.indptr[kk[ta]].astype(np.int64) + off
    ci = rows_a[ta]
    cj = bs_b.indices[tb].astype(np.int64)
    order = np.lexsort((cj, ci))  # stable: runs grouped by output block
    pa, pb, ci, cj = ta[order], tb[order], ci[order], cj[order]
    first = np.ones(n_pairs, np.int32)
    first[1:] = ((ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])).astype(np.int32)
    mask = np.zeros((nbr, nbc), bool)
    mask[ci, cj] = True
    pad = bucket_capacity(n_pairs, minimum=1) - n_pairs

    def padded(x, fill):
        return np.concatenate([x.astype(np.int32), np.full(pad, fill, np.int32)])

    return dict(
        pa=padded(pa, 0),
        pb=padded(pb, 0),
        ci=padded(ci, nbr),  # padding accumulates into the dummy block-row
        cj=padded(cj, 0),
        first=padded(first, 1),
        mask=mask,
        n_pairs=n_pairs,
        n_a_blocks=na,
    )


def _check_kernel_operands(name: str, block_size: int, *tensors: torch.Tensor) -> None:
    if block_size != KERNEL_BLOCK:
        raise ValueError(f"the CUDA {name} kernel takes {KERNEL_BLOCK}x{KERNEL_BLOCK} blocks, "
                         f"got {block_size}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the CUDA {name} kernel takes float32 operands")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous operands")


def bsr_matmul_dense_plain(a: BSRMatrix, b_dense: torch.Tensor) -> torch.Tensor:
    """K5's plain version: ``bsr_to_dense(a) @ b_dense[:cols]``."""
    with full_fp32():
        return torch.matmul(bsr_to_dense(a), b_dense[: a.shape[1]])


def bsr_matmul_dense(a: BSRMatrix, b_dense: torch.Tensor) -> torch.Tensor:
    """``A_bsr @ B_dense -> dense`` with A's zero blocks skipped (K5).

    ``b_dense`` is (K, N) with K >= a.shape[1]; its rows past a.shape[1] are
    not read.  The result is (a.shape[0], N); block-rows of A with no stored
    block give zero rows.  Only the first ``block_capacity`` block slots are
    read, also where ``indptr`` counts more blocks (:func:`bsr_from_dense`).
    On the card: :func:`bsr_split`, then :func:`bsr_matmul_dense_pieces`.
    """
    if b_dense.ndim != 2 or b_dense.shape[0] < a.shape[1]:
        raise ValueError(
            f"b_dense must be (K, N) with K >= {a.shape[1]}, got {tuple(b_dense.shape)}")
    if not _build.is_cuda(a.indptr, a.indices, a.blocks, b_dense):
        return bsr_matmul_dense_plain(a, b_dense)
    _check_kernel_operands("bsr_matmul_dense", a.block_size, a.blocks, b_dense)
    (m, k), n = a.shape, int(b_dense.shape[1])
    if max(m, n, b_dense.shape[0]) >= 2**31:
        raise ValueError("bsr_matmul_dense: dimensions must fit in int32")
    if m == 0 or n == 0 or k == 0 or a.block_capacity == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=b_dense.device)
    return bsr_matmul_dense_pieces(*bsr_split(a, b_dense), a, n)


def bsr_split(a: BSRMatrix, b_dense: torch.Tensor):
    """The bf16 pieces K5's GEMM multiplies (:func:`split_bf16`, three each):
    A's block slots in rows form, ``(3, cap * b, b)``, and B's first
    ``a.shape[1]`` rows, transposed, K-major, ``(3, n_pad, a.nbc * b)``
    with ``n_pad`` N rounded up to 128.  B's rows from ``a.shape[1]`` on are
    never read; the pieces are zero there."""
    bsz = a.block_size
    ap = split_bf16(a.blocks.reshape(a.block_capacity * bsz, bsz), 3)
    bp = split_bf16(b_dense[: a.shape[1]], 3, transpose=True, k_pad=a.nbc * bsz)
    return ap, bp


def _check_pieces(ap: torch.Tensor, bp: torch.Tensor, a: BSRMatrix, n: int) -> None:
    bsz, cap = a.block_size, a.block_capacity
    if ap.shape != (3, cap * bsz, bsz) or bp.ndim != 3 or bp.shape[0] != 3:
        raise ValueError(f"A's pieces must be (3, {cap * bsz}, {bsz}) and B's (3, n_pad, k_pad), "
                         f"got {tuple(ap.shape)} and {tuple(bp.shape)}")
    if bp.shape[2] != a.nbc * bsz or bp.shape[1] % 128 or not 0 <= n <= bp.shape[1]:
        raise ValueError(f"B's pieces {tuple(bp.shape)} do not fit A {a.shape} and n = {n} "
                         "(bsr_split)")


def bsr_matmul_dense_pieces_plain(ap: torch.Tensor, bp: torch.Tensor, a: BSRMatrix,
                                  n: int) -> torch.Tensor:
    """The six passes of the pieces, summed in f32 over A's stored blocks."""
    m, k = a.shape
    c = torch.zeros((m, n), dtype=torch.float32, device=ap.device)
    blocks = ap.reshape(3, a.block_capacity, a.block_size, a.block_size).to(torch.float32)
    with full_fp32():  # bf16 x bf16 products are exact in f32
        for i in range(3):
            ai = bsr_to_dense(BSRMatrix(indptr=a.indptr, indices=a.indices, blocks=blocks[i],
                                        shape=a.shape))
            for j in range(3 - i):  # the passes whose pieces' orders sum below 3
                c += torch.matmul(ai, bp[j, :n, :k].to(torch.float32).T)
    return c


def bsr_matmul_dense_pieces(ap: torch.Tensor, bp: torch.Tensor, a: BSRMatrix,
                            n: int) -> torch.Tensor:
    """K5's GEMM alone, on the pieces :func:`bsr_split` made of ``a`` and of
    B: the (a.shape[0], n) product, every entry written."""
    _check_pieces(ap, bp, a, n)
    if not _build.is_cuda(ap, bp, a.indptr, a.indices):
        return bsr_matmul_dense_pieces_plain(ap, bp, a, n)
    if ap.dtype != torch.bfloat16 or bp.dtype != torch.bfloat16:
        raise TypeError("bsr_matmul_dense_pieces takes bfloat16 pieces")
    if a.block_size != KERNEL_BLOCK:
        raise ValueError(f"the CUDA bsr_matmul_dense kernel takes {KERNEL_BLOCK}x{KERNEL_BLOCK} "
                         f"blocks, got {a.block_size}")
    if not (ap.is_contiguous() and bp.is_contiguous()):
        raise ValueError("bsr_matmul_dense_pieces takes contiguous pieces")
    m = a.shape[0]
    c = torch.empty((m, n), dtype=torch.float32, device=ap.device)
    if m == 0 or n == 0:
        return c
    code = _build.launch(
        "smm_bsr_matmul_dense_bf16", ap.device,
        a.indptr.data_ptr(), a.indices.data_ptr(), ap.data_ptr(), bp.data_ptr(), c.data_ptr(),
        a.nbr, a.block_capacity, m, n, bp.shape[1], bp.shape[2],
    )
    _build.LAUNCHES["bsr_matmul_dense"] += 1
    _build.check(code, "bsr_matmul_dense")
    return c


def _check_plan(a: BSRMatrix, b: BSRMatrix, tables, mask) -> None:
    if a.block_size != b.block_size:
        raise ValueError(f"block sizes differ: {a.block_size} and {b.block_size}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} and {b.shape}")
    n = tables[0].shape
    if any(t.ndim != 1 or t.shape != n or t.dtype != torch.int32 for t in tables):
        raise ValueError("pa, pb, ci, cj and first must be int32 vectors of one length")
    if tuple(mask.shape) != (a.nbr, b.nbc):
        raise ValueError(f"mask must be ({a.nbr}, {b.nbc}), got {tuple(mask.shape)}")


def bsr_bsr_matmul_dense_plain(a: BSRMatrix, b: BSRMatrix, pa, pb, ci, cj, first, mask):
    """K6's plain version: every pair's block product in one batched
    ``torch.bmm``, added into its output block with ``index_add_``.  Pairs
    in the dummy block-row ``nbr`` (the padding of a JAX-style plan) land in
    an extra block-row that is dropped."""
    bsz, nbr, nbc = a.block_size, a.nbr, b.nbc
    with full_fp32():
        prods = torch.bmm(a.blocks[pa.long()], b.blocks[pb.long()])
    out = torch.zeros(((nbr + 1) * nbc, bsz, bsz), dtype=prods.dtype, device=prods.device)
    out.index_add_(0, ci.long() * nbc + cj.long(), prods)
    out = out[: nbr * nbc].reshape(nbr, nbc, bsz, bsz)
    out = torch.where(mask.reshape(nbr, nbc, 1, 1), out, 0)  # select, never multiply
    return out.transpose(1, 2).reshape(nbr * bsz, nbc * bsz)[: a.shape[0], : b.shape[1]]


def bsr_bsr_split(a: BSRMatrix, b: BSRMatrix):
    """The bf16 pieces K6's GEMM multiplies (:func:`split_bf16`, three each):
    A's block slots in rows form, ``(3, cap_a * bs, bs)``, and B's block
    slots transposed as one ``(cap_b * bs, bs)`` matrix, ``(3, bs, cap_b *
    bs)`` (rows and K padded as :func:`split_bf16` pads them): its columns
    ``[s * bs, (s + 1) * bs)`` are block s transposed, K-major."""
    bsz = a.block_size
    ap = split_bf16(a.blocks.reshape(a.block_capacity * bsz, bsz), 3)
    bp = split_bf16(b.blocks.reshape(b.block_capacity * bsz, bsz), 3, transpose=True)
    return ap, bp


def _pad(x: int, to: int) -> int:
    return -(-x // to) * to


def _check_pair_pieces(ap: torch.Tensor, bp: torch.Tensor, a: BSRMatrix, b: BSRMatrix) -> None:
    bsz = a.block_size
    want_a = (3, _pad(a.block_capacity * bsz, TILE), _pad(max(bsz, 1), KSTEP))
    want_b = (3, _pad(bsz, TILE), _pad(max(b.block_capacity * bsz, 1), KSTEP))
    if tuple(ap.shape) != want_a or tuple(bp.shape) != want_b:
        raise ValueError(f"K6's pieces must be {want_a} and {want_b} (bsr_bsr_split), got "
                         f"{tuple(ap.shape)} and {tuple(bp.shape)}")


def bsr_pair_runs_plain(a: BSRMatrix, b: BSRMatrix, pa, pb, ci, cj):
    """:func:`bsr_pair_runs`'s plain version: ``searchsorted`` of every
    output block in the keys ``ci * nbc + cj``, and the flag of the range
    and order checks."""
    nbr, nbc = a.nbr, b.nbc
    keys = ci.long() * nbc + cj.long()
    blocks = torch.arange(nbr * nbc + 1, dtype=torch.int64, device=keys.device)
    bounds = torch.searchsorted(keys, blocks, out_int32=True)
    off = ((pa < 0) | (pa >= a.block_capacity) | (pb < 0) | (pb >= b.block_capacity)
           | (ci < 0) | (ci > nbr) | (cj < 0) | (cj >= nbc)).any()
    unsorted = (keys[1:] < keys[:-1]).any()
    return bounds, (off.to(torch.int32) | (unsorted.to(torch.int32) << 1)).reshape(1)


def _check_kernel_tables(tables, mask) -> None:
    if mask.dtype != torch.bool:
        raise TypeError("mask must be a bool tensor")
    if not (mask.is_contiguous() and all(t.is_contiguous() for t in tables)):
        raise ValueError("bsr_bsr_matmul_dense takes contiguous pair tables and mask")


def _run_state(a: BSRMatrix, b: BSRMatrix, device):
    """``bounds`` and ``state`` for the run check: ``state`` is three int32
    words the launch zeroes, the flag, then the block counter that K6's GEMM
    claims its output blocks from."""
    return (torch.empty(a.nbr * b.nbc + 1, dtype=torch.int32, device=device),
            torch.empty(3, dtype=torch.int32, device=device))


def _pair_runs(a: BSRMatrix, b: BSRMatrix, pa, pb, ci, cj):
    """:func:`bsr_pair_runs` on the card: ``(bounds, state)``."""
    if any(t.dtype != torch.int32 or t.shape != pa.shape or t.ndim != 1 or not t.is_contiguous()
           for t in (pa, pb, ci, cj)):
        raise ValueError("bsr_pair_runs takes contiguous int32 vectors of one length")
    bounds, state = _run_state(a, b, pa.device)
    code = _build.launch(
        "smm_bsr_pair_runs", pa.device,
        pa.data_ptr(), pb.data_ptr(), ci.data_ptr(), cj.data_ptr(), pa.shape[0], a.block_capacity,
        b.block_capacity, a.nbr, b.nbc, bounds.data_ptr(), state.data_ptr(),
    )
    _build.LAUNCHES["bsr_pair_runs"] += 1
    _build.check(code, "bsr_pair_runs")
    return bounds, state


def bsr_pair_runs(a: BSRMatrix, b: BSRMatrix, pa, pb, ci, cj):
    """Each output block's run of pairs, and a check of the tables, in one
    pass: ``(bounds, flag)``.  Block ``i * nbc + j`` owns pairs ``[bounds[i
    * nbc + j], bounds[i * nbc + j + 1])`` (``bounds`` int32, ``nbr * nbc +
    1`` long): the pairs whose key ``ci * nbc + cj`` is its own, in tables
    sorted by key; the planner's padding pairs (block-row ``nbr``) lie past
    ``bounds[-1]``.  ``flag`` (int32, one element) has bit 1 set when a slot
    lies past either capacity or a block off the output (the dummy block-row
    ``nbr`` is allowed), bit 2 when the keys are out of order."""
    if not _build.is_cuda(pa, pb, ci, cj):
        return bsr_pair_runs_plain(a, b, pa, pb, ci, cj)
    bounds, state = _pair_runs(a, b, pa, pb, ci, cj)
    return bounds, state[:1]


def _raise_on(flag: torch.Tensor) -> None:
    """Read :func:`bsr_pair_runs`'s flag: the one host synchronisation of a
    K6 call.  A slot past either capacity or a block off the output raises
    ``IndexError``, tables out of order ``ValueError``."""
    bad = int(flag)
    if bad & 1:
        raise IndexError("bsr_bsr_matmul_dense: a pair table entry is out of range")
    if bad & 2:
        raise ValueError("bsr_bsr_matmul_dense: the pair tables are not sorted by output block")


def bsr_bsr_matmul_dense_pieces_plain(ap: torch.Tensor, bp: torch.Tensor, a: BSRMatrix,
                                      b: BSRMatrix, pa, pb, ci, cj, first, mask):
    """The six passes of the pieces: K6's plain version on the f32 blocks of
    piece i of A and piece j of B, summed over i + j < 3."""
    bsz, cap_a, cap_b = a.block_size, a.block_capacity, b.block_capacity
    blocks_a = ap[:, : cap_a * bsz, :bsz].to(torch.float32).reshape(3, cap_a, bsz, bsz)
    blocks_b = (bp[:, :bsz, : cap_b * bsz].to(torch.float32).reshape(3, bsz, cap_b, bsz)
                .permute(0, 2, 3, 1).contiguous())  # [piece][slot][k][col]
    c = None
    for i in range(3):
        for j in range(3 - i):  # the passes whose pieces' orders sum below 3
            part = bsr_bsr_matmul_dense_plain(dataclasses.replace(a, blocks=blocks_a[i]),
                                              dataclasses.replace(b, blocks=blocks_b[j]),
                                              pa, pb, ci, cj, first, mask)
            c = part if c is None else c + part
    return c


def bsr_bsr_matmul_dense_pieces(ap: torch.Tensor, bp: torch.Tensor, a: BSRMatrix, b: BSRMatrix,
                                pa, pb, ci, cj, first, mask):
    """K6's run check and GEMM alone, on the pieces :func:`bsr_bsr_split`
    made of ``a`` and ``b``: the (a.shape[0], b.shape[1]) product, every
    entry written."""
    tables = (pa, pb, ci, cj, first)
    _check_plan(a, b, tables, mask)
    _check_pair_pieces(ap, bp, a, b)
    if not _build.is_cuda(ap, bp, *tables, mask):
        return bsr_bsr_matmul_dense_pieces_plain(ap, bp, a, b, *tables, mask)
    if ap.dtype != torch.bfloat16 or bp.dtype != torch.bfloat16:
        raise TypeError("bsr_bsr_matmul_dense_pieces takes bfloat16 pieces")
    if a.block_size != KERNEL_BLOCK:
        raise ValueError(f"the CUDA bsr_bsr_matmul_dense kernel takes {KERNEL_BLOCK}x"
                         f"{KERNEL_BLOCK} blocks, got {a.block_size}")
    _check_kernel_tables(tables, mask)
    if not (ap.is_contiguous() and bp.is_contiguous()):
        raise ValueError("bsr_bsr_matmul_dense_pieces takes contiguous pieces")
    bounds, state = _pair_runs(a, b, pa, pb, ci, cj)
    m, n = a.shape[0], b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=ap.device)
    if m and n:
        # Safe on tables the flag refuses (csrc/bsr_spgemm.cu): launched before
        # the flag is read, so the device runs the call's kernels back to back.
        code = _build.launch(
            "smm_bsr_bsr_matmul_dense_bf16", c.device,
            bounds.data_ptr(), pa.data_ptr(), pb.data_ptr(), mask.data_ptr(), ap.data_ptr(),
            bp.data_ptr(), c.data_ptr(), state[1:].data_ptr(), a.nbr, b.nbc, a.block_capacity,
            b.block_capacity, m, n,
        )
        _build.LAUNCHES["bsr_bsr_matmul_dense"] += 1
        _build.check(code, "bsr_bsr_matmul_dense")
    _raise_on(state[:1])
    return c


def bsr_bsr_matmul_dense(a: BSRMatrix, b: BSRMatrix, pa, pb, ci, cj, first, mask):
    """``A_bsr @ B_bsr -> dense`` over the block pairs of
    :func:`bsr_pair_plan` (K6).

    ``pa/pb/ci/cj/first`` are the plan's int32 tables, sorted by output block;
    they may be the ``n_pairs`` real pairs or the JAX planner's padded
    tables (padding pairs, in block-row ``nbr``, are skipped).  ``mask`` is
    the (nbr, nbc) visited-block mask; blocks no pair visits are zero.  On
    the card: the launches of :func:`bsr_bsr_split` and
    :func:`bsr_bsr_matmul_dense_pieces`, made from one host call; a slot past
    either capacity or a block off the output raises ``IndexError``, tables
    out of order ``ValueError``.
    """
    tables = (pa, pb, ci, cj, first)
    _check_plan(a, b, tables, mask)
    if not _build.is_cuda(a.blocks, b.blocks, *tables, mask):
        return bsr_bsr_matmul_dense_plain(a, b, pa, pb, ci, cj, first, mask)
    _check_kernel_operands("bsr_bsr_matmul_dense", a.block_size, a.blocks, b.blocks)
    m, n = a.shape[0], b.shape[1]
    if min(a.block_capacity, b.block_capacity, m, n) == 0:  # no block to multiply
        _raise_on(bsr_pair_runs(a, b, pa, pb, ci, cj)[1])
        return torch.zeros((m, n), dtype=torch.float32, device=a.blocks.device)
    _check_kernel_tables(tables, mask)
    # bsr_bsr_split, the run check and the GEMM in one host call: the same
    # launches as bsr_bsr_matmul_dense_pieces(*bsr_bsr_split(a, b), ...).
    dev, bsz, cap_a, cap_b = a.blocks.device, a.block_size, a.block_capacity, b.block_capacity
    ap = torch.empty((3, cap_a * bsz, bsz), dtype=torch.bfloat16, device=dev)
    bp = torch.empty((3, bsz, cap_b * bsz), dtype=torch.bfloat16, device=dev)
    bounds, state = _run_state(a, b, dev)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    code = _build.launch(
        "smm_bsr_bsr_matmul_dense_f32", dev,
        a.blocks.data_ptr(), b.blocks.data_ptr(), ap.data_ptr(), bp.data_ptr(), pa.data_ptr(),
        pb.data_ptr(), ci.data_ptr(), cj.data_ptr(), pa.shape[0], mask.data_ptr(),
        bounds.data_ptr(), state.data_ptr(), c.data_ptr(), a.nbr, b.nbc, cap_a, cap_b, m, n,
    )
    _build.LAUNCHES["split_bf16"] += 2
    _build.LAUNCHES["bsr_pair_runs"] += 1
    _build.LAUNCHES["bsr_bsr_matmul_dense"] += 1
    _build.check(code, "bsr_bsr_matmul_dense")
    _raise_on(state[:1])
    return c
