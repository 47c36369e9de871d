"""cuBLAS's FP32 setting for the products that must stay full FP32, shared
by the precision policy (:mod:`.matmul`) and the kernels' plain versions
(:mod:`.kernels`)."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_fp32"]


@contextlib.contextmanager
def full_fp32():
    """cuBLAS f32 products in full FP32 (no TF32) inside the block; the
    caller's setting is restored on exit."""
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = prev
