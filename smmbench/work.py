"""The work each stage of an entry must do, counted from shapes and entry
counts, and the card's peaks.

A stage's work is its bytes (each input read once, each output written
once) and its operations.  Its least time is the larger of the bytes at
the memory rate and the operations at ONE pass of the bf16 tensor-core
peak: the fastest dense rate that can give an f32 product.  The count is
the mathematics', whatever implements it: a product that runs six bf16
passes, or three, is held to the same work, so no implementation can
read over 100%.  The splits into bf16 pieces are part of the GEMM stage's
time and none of its work.
"""

from __future__ import annotations

F32 = 4
# One H100 SXM at 700 W (NVIDIA's data sheet): the memory rate and the dense
# bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def work(nbytes: float, flops: float = 0.0) -> dict:
    return dict(bytes=float(nbytes), flops=float(flops))


def add(*works: dict) -> dict:
    return work(sum(w["bytes"] for w in works), sum(w["flops"] for w in works))


def least_seconds(w: dict) -> float:
    """The least time the card could take for work ``w``."""
    return max(w["bytes"] / HBM_BYTES_PER_S, w["flops"] / BF16_FLOPS_PER_S)


def csr_bytes(rows: int, nnz: int, elt: int = F32) -> int:
    """Bytes of a CSR matrix: int32 row pointers, and int32 indices and values of nnz entries."""
    return 4 * (rows + 1) + (4 + elt) * nnz


def triu_entries(m: int, n: int) -> int:
    """Entries (i, j) of an m x n matrix with i <= j: its upper triangle."""
    r = min(m, n)
    return r * n - r * (r - 1) // 2


def gemm_upper(m: int, n: int, k: int) -> dict:
    """The upper triangle of (m, k) @ (k, n) in f32: both operands read, the
    triangle written, 2 k operations per entry of the triangle."""
    tri = triu_entries(m, n)
    return work(F32 * (m * k + k * n + tri), 2 * tri * k)


def gemm_full(m: int, n: int, k: int) -> dict:
    """(m, k) @ (k, n) in f32: both operands read, C written, 2 k operations per entry."""
    return work(F32 * (m * k + k * n + m * n), 2 * m * n * k)


def extract_upper(m: int, n: int, nnz: int) -> dict:
    """The upper triangle of a dense f32 matrix read, its nnz entries written as CSR."""
    return work(F32 * triu_entries(m, n) + csr_bytes(m, nnz))


def extract_full(m: int, n: int, nnz: int) -> dict:
    """A dense f32 matrix read, its nnz entries written as CSR."""
    return work(F32 * m * n + csr_bytes(m, nnz))


def entry_work(entry: str, kwargs: dict, shapes: list, out_entries: int) -> dict:
    """Work per call by stage of the port's entry ``entry`` on operands of
    ``shapes``, whose answer stores ``out_entries`` entries: ``gemm`` (the
    dense products a dense route computes) and ``extract`` (its dense
    result turned into CSR)."""
    if entry == "multiply":
        (m, k), (_, n) = shapes
        if kwargs.get("symmetric"):
            return dict(gemm=gemm_upper(m, n, k), extract=extract_upper(m, n, out_entries))
        return dict(gemm=gemm_full(m, n, k), extract=extract_full(m, n, out_entries))
    if entry == "triple_product":
        (m, n), _ = shapes
        return dict(gemm=add(gemm_full(m, n, n), gemm_upper(m, m, n)))
    raise ValueError(f"no work count for entry {entry!r}")
