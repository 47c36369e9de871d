"""Configuration for the PyTorch/CUDA sparse-multiply port.

The routing thresholds, the host/device cost model and the precision policy of
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
    # Host/device cost model of the scipy-in/scipy-out entry point, above the
    # hard limit (api._route_costs): the host wins when
    #   partials / (host_rate_base * sqrt(reuse))
    #     < link_fixed_s + up_bytes / link_up_bytes_per_s + down_cost,
    # reuse = partials / expected nnz(C).  The download term is the cheaper of
    # packed CSR and the raw panel plus a host pack at host_pack_rate
    # elements/s.  Each default is what chip_smoke.py phase 20 (cost-model)
    # measured on one NVIDIA H100 80GB HBM3, 700.00 W, behind its PCIe link,
    # on a host of 8 CPUs (OMP_NUM_THREADS unset):
    # spgemm_host's least-squares rate over reuse ~1, ~10 and ~100 (8.1e7,
    # 7.4e8 and 2.1e9 partials/s: residuals of -48%, +48%, +31%);
    host_rate_base: float = 1.572e8
    # the link as the 2 MiB probe of _calibrate_link measured it late in the
    # run (a 200 MiB pageable download ran at 2.42e9 B/s, 3.5x below the
    # probe's rate, the upload at 7.25e9; in a fresh process the probe read
    # downloads at 6.6e8 B/s);
    link_fixed_s: float = 2.432e-5
    link_up_bytes_per_s: float = 7.049e9
    link_down_bytes_per_s: float = 8.382e9
    # dense_pack of the 12,288^2 float32 panel of the dense route.
    host_pack_rate: float = 9.038e8
    # Measure the link of each device at its first routing decision (a
    # one-element round trip, a 2 MiB download and upload) and price that
    # device's requests with it in place of the three link_* fields.
    auto_calibrate_link: bool = True
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
    # Axis name of a row mesh (parallel/mesh.py).
    mesh_axis: str = "rows"
    # Per-slot dense working-set budget of the distributed layer: past it the
    # densifying rings hand host operands to the sparse local contraction
    # (parallel/distributed.py).
    dense_shard_budget_bytes: int = 4 << 30

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
