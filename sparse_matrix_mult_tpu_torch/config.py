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
    # hard limit (api._route_costs).  On the CPU it is JAX's formula, term for
    # term: the host wins when
    #   partials / (host_rate_base * sqrt(reuse))
    #     < link_fixed_s + up_bytes / link_up_bytes_per_s + down_cost,
    # reuse = partials / expected nnz(C).  The download term is the cheaper of
    # packed CSR and the raw panel plus a host pack at host_pack_rate
    # elements/s.  On CUDA each side prices the host work of the route it
    # takes (api._cuda_route_costs) at the rates below.  Every rate is a fit
    # of chip_smoke.py phase 20 on its own fit points, on the host of one
    # NVIDIA H100 80GB HBM3, 700.00 W (8 CPUs, OMP_NUM_THREADS unset).  The
    # CUDA ones are the geometric mean of two runs of that phase, each in a
    # process of its own, in one chip call (each comment gives both runs'
    # values; host rates vary up to 2.5x between machines, PERF.md).
    # JAX's spgemm_host rate, fitted over reuse ~1, ~10 and ~100 (an earlier
    # run of the same phase);
    host_rate_base: float = 1.572e8
    # the link as the probe of _calibrate_link measures it (8 MiB each way,
    # to and from pinned host memory);
    link_fixed_s: float = 4.17e-5
    link_up_bytes_per_s: float = 4.99e10
    link_down_bytes_per_s: float = 5.78e10
    # dense_pack of the 12,288^2 float32 panel of the dense route.
    host_pack_rate: float = 6.585e8
    # CUDA only.  fetch_np's host copy of a download into an array of the
    # result's dtype (the f64 cast fused into it) whose pages are already
    # written, bytes of that array/s (staged downloads of 4 and 12 MiB cast to
    # f64, results under the mmap threshold, net of the link; 3.935e10 and
    # 2.495e10, NVIDIA H100 80GB HBM3, 700.00 W); an array past the threshold
    # adds its fresh pages at host_fetch_page_rate;
    host_copy_rate: float = 3.133e10
    # the first writes of a host array past glibc's 32 MiB mmap threshold
    # (api._MMAP_BYTES), which lands in fresh pages, bytes/s (np.ones of 64
    # and 128 MiB net of filling a written array; 6.010e9 and 6.496e9, NVIDIA
    # H100 80GB HBM3, 700.00 W); the rates below are net of it;
    host_page_rate: float = 6.248e9
    # but the fresh pages of a fetch_np result, which its copy threads fault
    # in together, bytes/s (fitted with host_csr_rate on the ESC route's
    # "download" stage, its results past the threshold setting it; 1.159e10
    # and 1.070e10, NVIDIA H100 80GB HBM3, 700.00 W);
    host_fetch_page_rate: float = 1.114e10
    # from_scipy's host work per uploaded entry, net of the link (three
    # synchronous transfers per operand), as the ESC route's "upload" stage
    # times it (4.940e8 and 4.574e8, NVIDIA H100 80GB HBM3, 700.00 W);
    host_upload_rate: float = 4.754e8
    # the ESC engine on the card (windowed) as the ESC route's "engine" stage
    # times it: a fixed time (its launches and its one host sync; 1.209e-3 and
    # 1.034e-3, NVIDIA H100 80GB HBM3, 700.00 W) and partials at
    # esc_engine_rate (2.526e9 and 2.423e9, NVIDIA H100 80GB HBM3, 700.00 W);
    esc_fixed_s: float = 1.118e-3
    esc_engine_rate: float = 2.474e9
    # spgemm_host as partials / host_partial_rate + output entries /
    # host_entry_rate (least squares over four products whose output stays
    # under the mmap threshold: hypersparse at 40,000^2 and 90,000^2,
    # sp.random at reuse ~10 and ~100; 2.938e9 and 2.426e9, 2.006e8 and
    # 1.547e8, NVIDIA H100 80GB HBM3, 700.00 W) + the fresh pages of a larger
    # output at host_out_page_rate (its threads fault them in together: slower
    # than host_page_rate; 3.863e9 and 3.060e9, NVIDIA H100 80GB HBM3, 700.00
    # W);
    host_partial_rate: float = 2.670e9
    host_entry_rate: float = 1.762e8
    # but the output entries of A's rows of one stored entry, each a copy of
    # one B row, at host_copy_entry_rate (api._single_row_entries; fitted net
    # of the partials term on chip_smoke.py's COPY_ENTRY_POINTS: one entry per
    # row of a 20,000 x 30,000 A times a 30,000^2 hypersparse B of 3e6
    # entries, and of a 30,000 x 10,000 A times 10,000^2 of 5e5; 7.432e8 and
    # 5.164e8, NVIDIA H100 80GB HBM3, 700.00 W);
    host_copy_entry_rate: float = 6.195e8
    host_out_page_rate: float = 3.438e9
    # to_scipy of a packed result on the card (api._to_scipy_cost): what is
    # left of the ESC route's "download" stage net of the link, the host
    # copies and the fresh pages (csr_matrix, the staging ring's fixed work),
    # entries/s (1.125e9 and 1.472e9, NVIDIA H100 80GB HBM3, 700.00 W);
    host_csr_rate: float = 1.287e9
    # scipy's CSR row slice (get_csr_submatrix), entries/s: each chunk's rows
    # of A on the chunked routes and each esc_chunks part's [:rows] (fitted on
    # the "download" stage, net of the rest of it, of the row-chunked products
    # cut at the default ESC budget, whose parts are the size the router
    # prices at it: 150,000^2 in 4 chunks and 800,000^2 in 10; 1.198e8 and
    # 1.145e8, NVIDIA H100 80GB HBM3, 700.00 W);
    host_slice_rate: float = 1.171e8
    # one copy of a CSR's entries by numpy or the native library into fresh
    # arrays, net of their pages (host_page_rate), entries/s: each of
    # stitch_csr's two (the parts' concatenation, the output) and csr_triu's
    # (fitted on the "stitch" stage of the same products; 6.180e8 and 5.861e8,
    # NVIDIA H100 80GB HBM3, 700.00 W);
    stitch_copy_rate: float = 6.019e8
    # windowed_plan (with its gather of B's row lengths), A entries/s, as the
    # ESC route's "windowed_plan" stage times it (1.504e8 and 1.445e8, NVIDIA
    # H100 80GB HBM3, 700.00 W);
    esc_plan_rate: float = 1.474e8
    # _fetch_full_triu's index rebuild (_full_triu_csr), entries/s (9.607e8
    # and 9.765e8, NVIDIA H100 80GB HBM3, 700.00 W);
    triu_rebuild_rate: float = 9.686e8
    # an f64 array of m*n elements: the host route's toarray, np.triu and its
    # mirror, elements/s (8.327e8 and 7.957e8, NVIDIA H100 80GB HBM3, 700.00
    # W);
    host_f64_rate: float = 8.140e8
    # scipy's csr_matrix of a small dense panel (outputs up to
    # host_extract_limit), elements/s (4.543e7 and 4.219e7, NVIDIA H100 80GB
    # HBM3, 700.00 W);
    dense_csr_rate: float = 4.378e7
    # scipy's serial SpGEMM, partials/s (the triple's host route; 2.309e8 and
    # 2.369e8, NVIDIA H100 80GB HBM3, 700.00 W).
    scipy_partial_rate: float = 2.339e8
    # Measure the link of each device at its first routing decision (a
    # one-element round trip, an 8 MiB pinned download and upload) and price
    # that device's requests with it in place of the three link_* fields.
    auto_calibrate_link: bool = True
    # Partial-product budgets of the ESC engines; the router compares the
    # expansion against them to decide between ESC and the dense route.
    esc_expand_limit: int = 1 << 22
    # Row-binned ESC engine (ops/spgemm_binned.py): lane width (slots sorted
    # together) and slice window of its host plan, and its single-dispatch
    # budget.  Past ``binned_expand_limit`` the router takes row chunks.  On
    # CUDA the ladder skips the binned rung unless ``binned_esc_on_cuda``
    # (its host planner costs more than the windowed engine it replaces:
    # 0.21 s against 0.02 s at 2e7 partials on the H100 host), and the
    # windowed rung takes its budget.
    use_binned_esc: bool = True
    binned_esc_on_cuda: bool = False
    binned_lane_width: int = 4096
    binned_window: int = 8
    binned_expand_limit: int = 1 << 25
    # BSR route: block edge of the BSR kernels (K5, K6).  A goes through
    # them on CUDA when at most ``cuda_bsr_occupancy_cutoff`` of its
    # (block_size x block_size) blocks are occupied; 0 (the default) sends
    # every CUDA request to the dense route without a scan: chip_smoke.py's
    # bsr-crossover found the BSR route slower end to end at every occupancy
    # it measured (0.002-0.25 at 8192^2, 0.002-0.005 at 16,384^2; NVIDIA H100
    # 80GB HBM3, 700.00 W).  On the route, B goes through K6 when at most
    # ``bsr_occupancy_cutoff`` (JAX's constant) of its blocks are occupied,
    # else through K5.  The CUDA kernels take 128 only: with another block
    # size CUDA requests keep the dense route, and only ``force_bsr`` (the
    # plain versions on the CPU) uses it.
    block_size: int = 128
    use_bsr: bool = True
    cuda_bsr_occupancy_cutoff: float = 0.0
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
