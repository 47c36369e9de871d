"""``types.row_ids_from_indptr`` against the JAX package's, its three call
sites against the code they replaced, and the public names of every module
of the JAX package against its counterpart in the port."""

import importlib
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.types import row_ids_from_indptr as jax_row_ids
from sparse_matrix_mult_tpu_torch.types import CSRMatrix, row_ids_from_indptr
from sparse_matrix_mult_tpu_torch.types_bsr import bsr_from_scipy

# The module: ``ops.spgemm_esc`` as an attribute is the function of that name.
esc = importlib.import_module("sparse_matrix_mult_tpu_torch.ops.spgemm_esc")

# (row lengths, capacity): empty first and last rows, runs of empty rows,
# capacity above and at nnz, below it (JAX drops the row ends past it), a
# matrix of no rows and a capacity of 0.
CASES = [
    ([0, 2, 0, 0, 3, 0], 8),
    ([0, 2, 0, 0, 3, 0], 5),
    ([0, 2, 0, 0, 3, 0], 3),
    ([3, 1, 4, 1, 5], 14),
    ([3, 1, 4, 1, 5], 32),
    ([0, 0, 0], 4),
    ([0, 0, 0], 0),
    ([], 4),
    ([], 0),
    ([7], 7),
    ([0, 7], 9),
]


def _indptr(lengths):
    return np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)]).astype(np.int32)


def _random_lengths(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, rng.integers(1, 60))
    lengths[rng.random(lengths.shape) < 0.3] = 0
    return lengths


@pytest.mark.parametrize("lengths,capacity",
                         CASES + [(_random_lengths(s), int(_random_lengths(s).sum()) + s)
                                  for s in range(6)],
                         ids=[f"case{i}" for i in range(len(CASES))]
                         + [f"random{s}" for s in range(6)])
def test_row_ids_from_indptr_equals_jax(lengths, capacity):
    indptr = _indptr(lengths)
    want = np.asarray(jax_row_ids(jnp.asarray(indptr), capacity))
    got = row_ids_from_indptr(torch.from_numpy(indptr), capacity)
    assert got.dtype == torch.int32 and got.shape == (capacity,)
    np.testing.assert_array_equal(got.numpy(), want)
    # Positions from indptr[-1] on count every row end: the number of rows.
    nnz = int(indptr[-1])
    assert bool((got[nnz:] == len(lengths)).all())


def test_row_ids_from_indptr_is_exported():
    assert "row_ids_from_indptr" in tsmm.types.__all__
    assert tsmm.types.row_ids_from_indptr is row_ids_from_indptr


# The code of the three call sites before they called row_ids_from_indptr.
def _csr_row_ids_before(a: CSRMatrix):
    counts = (a.indptr[1:] - a.indptr[:-1]).long()
    nnz = int(a.nnz)
    rid = torch.repeat_interleave(torch.arange(a.rows, dtype=torch.int32), counts,
                                  output_size=nnz)
    out = torch.zeros(a.capacity, dtype=torch.int32)
    out[:nnz] = rid
    return out


def _block_rows_before(m):
    counts = (m.indptr[1:] - m.indptr[:-1]).long()
    rid = torch.repeat_interleave(torch.arange(m.nbr, dtype=torch.int32), counts,
                                  output_size=int(m.nblocks))
    out = torch.full((m.block_capacity,), m.nbr, dtype=torch.int32)
    kept = m.stored()
    out[:kept] = rid[:kept]
    return out


def _esc_row_ids_before(indptr, nnz):
    counts = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(indptr.shape[0] - 1), counts, output_size=nnz)


def _matrices():
    yield sp.csr_matrix(np.diag([0.0, 1.0, 0.0, 0.0, 2.0, 0.0]))  # empty first and last rows
    yield sp.random(40, 30, density=0.05, format="csr", random_state=1)
    yield sp.csr_matrix((5, 7))
    yield sp.random(300, 260, density=0.02, format="csr", random_state=2)


@pytest.mark.parametrize("case", range(4))
def test_call_sites_give_what_they_gave_before(case):
    mat = list(_matrices())[case]
    for capacity in (None, tsmm.bucket_capacity(mat.nnz) * 2):
        a = tsmm.from_scipy(mat, capacity=capacity, device="cpu")
        got = a.row_ids()
        assert got.dtype == torch.int32
        assert torch.equal(got, _csr_row_ids_before(a))
        nnz = int(a.nnz)
        assert torch.equal(esc._row_ids(a.indptr, nnz), _esc_row_ids_before(a.indptr, nnz))
    for block_size in (2, 4):
        tight = bsr_from_scipy(mat, block_size, device="cpu")
        for m in (tight, bsr_from_scipy(mat, block_size, block_capacity=2 * tight.block_capacity,
                                        device="cpu")):
            got = m.block_rows()
            assert got.dtype == torch.int32
            assert torch.equal(got, _block_rows_before(m))


# Public names of the JAX package with no counterpart of the same name, on
# purpose: the TPU's shift networks (their job is done by K2-K4, K7 and K8),
# the JAX shardings (a RowMesh places its own slots), and the Pallas and
# staged conversion entry points (the port's one entry point per function
# launches the kernel on CUDA and runs its plain version on the CPU).
ABSENT = {
    "ops.shift_network": {"compact_1d", "compact_rows", "concentrate", "distribute",
                          "distribute_1d", "distribute_rows", "monotonic_move_1d",
                          "monotonic_move_rows"},
    "parallel.mesh": {"row_sharding", "replicated_sharding"},
    "ops.pallas.convert_kernels": {"csr_to_dense_pallas", "csr_to_dense_staged",
                                   "dense_to_csr_pallas", "dense_to_csr_staged",
                                   "dense_to_csr_triu_pallas", "dense_to_csr_triu_staged"},
}
RENAMED = {"ops.spgemm_jnp": "ops.spgemm_esc", "ops.pallas": "ops.kernels"}


def _counterpart(name: str) -> str:
    for old, new in RENAMED.items():
        if name == old or name.startswith(old + "."):
            return new + name[len(old):]
    return name


def _jax_modules():
    prefix = jsmm.__name__ + "."
    return sorted(m.name[len(prefix):] for m in pkgutil.walk_packages(jsmm.__path__, prefix))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_a_counterpart(module):
    want = set(getattr(importlib.import_module(f"{jsmm.__name__}.{module}"), "__all__", ()))
    want -= ABSENT.get(module, set())
    if not want:
        return
    port = importlib.import_module(f"{tsmm.__name__}.{_counterpart(module)}")
    missing = want - set(getattr(port, "__all__", ()))
    assert not missing, (module, sorted(missing))
    assert all(hasattr(port, name) for name in want), module


def test_package_level_names_are_the_same():
    assert set(jsmm.__all__) <= set(tsmm.__all__)
