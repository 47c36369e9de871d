"""Configuration for the PyTorch/CUDA sparse-multiply port.

The routing thresholds and the precision policy of
:mod:`sparse_matrix_mult_tpu.config`, trimmed to what the ported slice
reads.  Two differences:

* ``device`` names where the scipy-in/scipy-out entry point computes.  It is
  never probed: with the default ``"cuda"`` and no GPU, torch raises.
* There are no per-kernel switches.  A CUDA tensor runs the hand-written
  kernel; a CPU tensor runs the kernel's plain PyTorch version.  The one
  force switch, ``force_bsr``, is the counterpart of ``force_pallas_bsr``.
  K1's split3 branch has no switch either: the caller's explicit
  ``precision="fast"`` selects it, as in JAX (see :mod:`.ops.dense_path`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Config", "get_config", "set_config", "Precision"]


class Precision:
    """Compute-precision policies for the GPU path (the CPU computes native f64).

    * ``FAST``   -- float32 operands, full-FP32 products (never TF32).
    * ``SPLIT``  -- double-float (hi/lo) operand split, three f32 products
      recombined in f64.
    * ``STRICT`` -- full float64.
    * ``AUTO``   -- FAST up to ``auto_split_terms`` expected terms per output
      element, SPLIT above; STRICT only on request.
    """

    FAST = "fast"
    SPLIT = "split"
    STRICT = "strict"
    AUTO = "auto"


@dataclasses.dataclass
class Config:
    # Device of the scipy-in/scipy-out entry point (``sparse_matrix_multiply``).
    device: str = "cuda"
    precision: str = Precision.AUTO
    # AUTO upgrades FAST -> SPLIT above this many expected terms per entry.
    auto_split_terms: int = 1 << 16
    # Dense route only when rows*cols of every involved matrix is at most this.
    dense_path_limit: int = 1 << 28
    # Dense-route outputs up to this many elements are packed on the host.
    host_extract_limit: int = 1 << 22
    # At or below this many partial products the scipy entry point multiplies
    # on the host (native Gustavson kernel).
    host_compute_limit: int = 1 << 19
    # Partial-product budgets of the ESC engines; the router compares the
    # expansion against them to decide between ESC and the dense route.
    esc_expand_limit: int = 1 << 22
    # Row-binned ESC engine (ops/spgemm_binned.py): lane width (slots sorted
    # together) and slice window of its host plan, and its single-dispatch
    # budget.  Past ``binned_expand_limit`` the router takes row chunks.
    use_binned_esc: bool = True
    binned_lane_width: int = 4096
    binned_window: int = 8
    binned_expand_limit: int = 1 << 25
    # BSR route: block edge of the BSR kernels (K5, K6), and block-sparse
    # operands -- at most this fraction of A's (block_size x block_size)
    # blocks occupied -- go through them on CUDA.  The CUDA kernels take 128
    # only: with another block size CUDA requests keep the dense route, and
    # only ``force_bsr`` (the plain versions on the CPU) uses it.
    block_size: int = 128
    use_bsr: bool = True
    bsr_occupancy_cutoff: float = 0.25
    # Take the BSR route whatever the device and size (the CPU tests run the
    # kernels' plain versions through it).
    force_bsr: bool = False
    # Route only to Gustavson-structure strategies (keeps exact-zero entries).
    keep_structure: bool = False
    # Print the reference's "Multiplication resulted in a zero matrix." notice.
    zero_result_notice: bool = True

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_config = Config()


def get_config() -> Config:
    return _config


def set_config(cfg: Optional[Config] = None, **kw) -> Config:
    global _config
    if cfg is not None:
        _config = cfg
    if kw:
        _config = _config.replace(**kw)
    return _config
