"""Compute: the dense route, the sparse-output ESC engines, the triple
product, precision-policy matmuls, CSR <-> dense conversion, and the
hand-written CUDA kernels under :mod:`.kernels`."""

from .dense_path import spgemm_dense_out, spgemm_sparse_out
from .kernels.bsr_spgemm import bsr_bsr_matmul_dense, bsr_matmul_dense, bsr_pair_plan
from .matmul import policy_matmul
from .spgemm_binned import binned_plan, spgemm_esc_binned
from .spgemm_esc import (
    expansion_size,
    precompute_window_table,
    spgemm_esc,
    spgemm_esc_windowed,
    windowed_plan,
)
from .triple_product import triple_product_dense

__all__ = [
    "spgemm_dense_out",
    "spgemm_sparse_out",
    "spgemm_esc",
    "spgemm_esc_windowed",
    "spgemm_esc_binned",
    "binned_plan",
    "precompute_window_table",
    "windowed_plan",
    "expansion_size",
    "triple_product_dense",
    "policy_matmul",
    "bsr_matmul_dense",
    "bsr_bsr_matmul_dense",
    "bsr_pair_plan",
]
