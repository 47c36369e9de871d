"""The port stands alone: it imports neither jax nor the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "sparse_matrix_mult_tpu_torch")
BENCH = os.path.join(ROOT, "benchmarks_torch")


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, sparse_matrix_mult_tpu_torch\n"
        "import sparse_matrix_mult_tpu_torch.ops.kernels.convert_kernels\n"
        "import sparse_matrix_mult_tpu_torch.ops.kernels.triu_matmul\n"
        "import sparse_matrix_mult_tpu_torch.ops.kernels.full_matmul\n"
        "import sparse_matrix_mult_tpu_torch.ops.kernels.bsr_spgemm\n"
        "import sparse_matrix_mult_tpu_torch.ops.triple_product\n"
        "import sparse_matrix_mult_tpu_torch.models.inversion\n"
        "import sparse_matrix_mult_tpu_torch.ops.spgemm_esc\n"
        "import sparse_matrix_mult_tpu_torch.ops.spgemm_binned\n"
        "import sparse_matrix_mult_tpu_torch.utils.testing\n"
        "import sparse_matrix_mult_tpu_torch.parallel.partition\n"
        "import sparse_matrix_mult_tpu_torch.parallel.mesh\n"
        "import sparse_matrix_mult_tpu_torch.parallel.distributed\n"
        "import sparse_matrix_mult_tpu_torch.io\n"
        "import sparse_matrix_mult_tpu_torch.utils.profiling\n"
        "import sparse_matrix_mult_tpu_torch.utils.logging\n"
        "import benchmarks_torch.bench, benchmarks_torch.spread\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'sparse_matrix_mult_tpu' or m.startswith('sparse_matrix_mult_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_modules():
    """The port's modules, its benchmark, the script that drives it on the
    card, the tools that run it there and its demo."""
    for top in (PORT, BENCH):
        for dirpath, _, files in os.walk(top):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "examples", "demo_torch.py")
    tools = os.path.join(ROOT, "tools")
    yield from (os.path.join(tools, f) for f in os.listdir(tools) if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_port_modules()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "sparse_matrix_mult_tpu"), (path, name)


def test_the_scan_covers_the_sparse_output_modules():
    scanned = {os.path.relpath(p, ROOT) for p in _port_modules()}
    for module in ("ops/spgemm_esc.py", "ops/spgemm_binned.py", "utils/testing.py",
                   "utils/native.py", "api.py", "parallel/partition.py", "parallel/mesh.py",
                   "parallel/distributed.py", "io.py", "utils/profiling.py",
                   "utils/logging.py", "utils/__init__.py"):
        assert os.path.join("sparse_matrix_mult_tpu_torch", module) in scanned, module
    assert os.path.join("examples", "demo_torch.py") in scanned


def test_the_scan_covers_the_benchmark():
    scanned = {os.path.relpath(p, ROOT) for p in _port_modules()}
    for module in ("bench.py", "cells.py", "common.py", "stages.py", "trace.py", "work.py",
                   "spread.py"):
        assert os.path.join("benchmarks_torch", module) in scanned, module
