"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source,
all started together, and link into one shared library with a plain C
interface.  The library sits in ``build/smm_torch_kernels/`` next to the
package and is named by a hash of the flags and of every file under
``csrc/`` (the ``*.cuh`` headers the sources share included), so an edited
file builds anew and an unchanged tree loads in milliseconds.

Every C entry point takes device pointers and PyTorch's current stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  Nothing here runs at import: this module is imported on
machines with no ``nvcc`` and no GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ["load", "check", "launch", "stream_ptr", "is_cuda", "LAUNCHES", "reset_launches"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "smm_torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# Kernel launches per wrapper; each CUDA wrapper adds one where it launches.
LAUNCHES = {
    "matmul_triu": 0, "matmul_full": 0, "split_bf16": 0, "csr_to_dense": 0, "dense_to_csr": 0,
    "dense_to_csr_triu": 0, "bsr_matmul_dense": 0, "bsr_pair_runs": 0, "bsr_bsr_matmul_dense": 0,
    "dense_to_csr_fused": 0, "csr_to_dense_fused": 0,
}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "smm_split_bf16": [_P, _P, _I64, _I64, _I64, _I64, _INT, _INT, _P],
    "smm_matmul_triu_bf16": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _INT, _P],
    "smm_matmul_full_bf16": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _INT, _P],
    "smm_csr_to_dense_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "smm_csr_to_dense_f64": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "smm_dense_count_f32": [_P, _I64, _I64, _INT, _I64, _P, _P],
    "smm_dense_count_f64": [_P, _I64, _I64, _INT, _I64, _P, _P],
    "smm_dense_fill_f32": [_P, _I64, _I64, _INT, _I64, _P, _P, _P, _P],
    "smm_dense_fill_f64": [_P, _I64, _I64, _INT, _I64, _P, _P, _P, _P],
    "smm_bsr_matmul_dense_bf16": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _P],
    "smm_bsr_pair_runs": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P, _P, _P],
    "smm_bsr_bsr_matmul_dense_bf16": [_P] * 8 + [_I64] * 6 + [_P],
    "smm_bsr_bsr_matmul_dense_f32": [_P] * 8 + [_I64, _P, _P, _P, _P] + [_I64] * 6 + [_P],
    "smm_dense_to_csr_fused_f32": [_P] + [_I64] * 7 + [_P] * 5,
    "smm_dense_to_csr_fused_f64": [_P] + [_I64] * 7 + [_P] * 5,
    "smm_csr_to_dense_fused_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "smm_csr_to_dense_fused_f64": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _sources(suffixes: tuple[str, ...] = (".cu",)) -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR) if f.endswith(suffixes))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources((".cu", ".cuh")):
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libsmm_torch_kernels_{digest.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; their stderr, in order.  Raises on the
    first failure, after stopping the others."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        errs = []
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
            errs.append(err)
        return errs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build(verbose: bool = False) -> str:
    """Compile the sources unless the library for their hash exists; returns
    its path.  ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    report (registers, shared memory and spills of every kernel)."""
    path = library_path()
    if os.path.exists(path) and not verbose:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = _sources()
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in srcs]
        errs = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, src]
                         for src, obj in zip(srcs, objs)])
        lib = os.path.join(tmp, "lib.so")
        errs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        if verbose:
            print("".join(errs), end="")
        os.replace(lib, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its signatures declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.smm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.smm_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        what = load().smm_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {what}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device: torch.device, *args) -> int:
    """Call the C entry point ``name`` with ``args`` and ``device``'s current
    stream, ``device`` made current for the call: the runtime launches a
    kernel on the current device (and the C side keys its per-device set-up
    on it), whatever device the stream and pointers belong to."""
    with torch.cuda.device(device):
        return getattr(load(), name)(*args, stream_ptr(device))


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device (launch the kernel), False
    when every one is on the CPU (run the plain version); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on one of cpu or cuda, got {sorted(kinds)}")
