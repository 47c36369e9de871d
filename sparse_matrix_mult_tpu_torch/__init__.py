"""sparse_matrix_mult_tpu_torch: the PyTorch/CUDA port of sparse_matrix_mult_tpu.

The JAX package ``sparse_matrix_mult_tpu`` is the reference this port is
held against; the port imports neither it nor ``jax``.  The port carries
the dense route of ``sparse_matrix_multiply`` -- sparse x sparse -> sparse or
dense, symmetric (upper triangle) or not -- with its BSR rung for
block-sparse operands and the host short-circuit for small problems, the
triple product ``H Q H^T`` (``use_triple_product=True`` and the
device-resident ``triple_product``) with the inversion workflow of
``models.inversion``, the device-resident ``multiply``, and the BSR
container with its BSR x dense product (``bsr_multiply_dense``).  On an
NVIDIA Hopper
GPU its kernels are hand-written CUDA (``csrc/``), built with ``nvcc`` at
first use; on the CPU every kernel runs its plain PyTorch version.
"""

from ._version import __version__
from .api import get_last_route, multiply, sparse_matrix_multiply, triple_product
from .config import Config, Precision, get_config, set_config
from .ops.kernels.bsr_spgemm import bsr_matmul_dense as bsr_multiply_dense
from .types import CSRMatrix, bucket_capacity, from_dense, from_scipy, to_scipy
from .types_bsr import BSRMatrix, bsr_from_dense, bsr_from_scipy, bsr_to_dense

__all__ = [
    "sparse_matrix_multiply",
    "multiply",
    "triple_product",
    "get_last_route",
    "bsr_multiply_dense",
    "CSRMatrix",
    "from_scipy",
    "to_scipy",
    "from_dense",
    "bucket_capacity",
    "BSRMatrix",
    "bsr_from_scipy",
    "bsr_from_dense",
    "bsr_to_dense",
    "Config",
    "Precision",
    "get_config",
    "set_config",
    "__version__",
]
