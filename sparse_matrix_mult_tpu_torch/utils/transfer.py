"""Device-to-host transfers of results.

Counterpart of :mod:`sparse_matrix_mult_tpu.utils.transfer`.  The JAX
version splits large downloads into concurrent pieces to get the most out
of a slow network link.  Over PCIe the link is fast and the host work
around it is the cost: a pageable ``.cpu()`` runs through the CUDA
runtime's own staging copy into a fresh array, and a cast to f64 then reads
that array back into a second one.  So :func:`fetch_np` downloads a CUDA
tensor through two pinned staging buffers of its own, copying (and
casting) each chunk into the caller's array while the next one crosses.
The panel-download route (:func:`fetch_dense_to_csr`) is kept: past ~50%
density the raw panel is fewer bytes than packed CSR.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext

import numpy as np
import torch

__all__ = ["fetch_np", "fetch_dense_to_csr", "fine_capacity"]

# The least bytes of a result (the host array) that download staged.  Below
# it the pageable copy's lower fixed cost wins (chip_smoke.py's fetch line,
# two runs on an H100 host: kept f32, 1 MiB pageable 0.16-0.18 ms against
# staged 0.22-0.23, 4 MiB 0.43-0.44 against 0.39-0.41; cast to f64, a 2 MiB
# result, pageable and astype 0.39-0.46 against staged 0.20-0.21).
STAGE_MIN_BYTES = 2 << 20
# Bytes of each of a device's two pinned staging buffers (chip_smoke.py's
# fetch line times 16, 32 and 64 MiB: on an H100 host 32 and 64 each came
# first in one of two runs, 16 last in both; 32 pins half the memory).
STAGE_BYTES = 32 << 20


def fine_capacity(n: int, minimum: int = 128) -> int:
    """Round ``n`` up to a fine capacity bucket (<= 1/16 slack): multiples of
    2^(k-5) within each octave."""
    n = max(int(n), minimum)
    step = max(1 << max(n.bit_length() - 5, 0), minimum)
    return -(-n // step) * step


class _StagingRing:
    """Two pinned host buffers and a copy stream of one CUDA device, made at
    its first staged download and kept for the process; ``lock`` serialises
    the downloads that share them."""

    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        self.buffers = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
                        for _ in range(2)]
        self.stream = torch.cuda.Stream(device=device)


_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


def _ring(device: torch.device) -> _StagingRing:
    with _RINGS_LOCK:
        if device.index not in _RINGS:
            _RINGS[device.index] = _StagingRing(device)
        return _RINGS[device.index]


def staged_fetch(x: torch.Tensor, dtype, buffers, stream=None) -> np.ndarray:
    """``x`` as a fresh numpy array of ``dtype`` (``x``'s own by default),
    copied through ``buffers``, two byte tensors of one size.

    Chunk k of ``x`` goes into ``buffers[k % 2]`` on ``stream``, which first
    waits for the current stream of ``x``'s device; once the chunk's event
    has fired it is copied into the result, cast on the way, while chunk
    k + 1 crosses.  The host copy is torch's, spread over its threads, which
    also fault the result's fresh pages in together.  With ``stream=None``
    (CPU tensors and buffers, as the tests drive it) each chunk's download
    is synchronous.  The result never aliases the buffers.
    """
    src = x.detach().contiguous().reshape(-1)
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(src.device))
    staging = [b.view(src.dtype) for b in buffers]
    chunk = staging[0].numel()
    out = np.empty(tuple(x.shape), dtype=staging[0].numpy().dtype if dtype is None else dtype)
    flat = torch.from_numpy(out.reshape(-1))
    n = src.numel()
    steps = -(-n // chunk)
    events = [None, None]

    def start(k: int) -> None:
        lo, hi = k * chunk, min(n, (k + 1) * chunk)
        with nullcontext() if stream is None else torch.cuda.stream(stream):
            staging[k % 2][: hi - lo].copy_(src[lo:hi], non_blocking=stream is not None)
            if stream is not None:
                events[k % 2] = torch.cuda.Event()
                events[k % 2].record(stream)

    if steps:
        start(0)
    for k in range(steps):
        if k + 1 < steps:
            start(k + 1)  # into the other buffer, whose chunk k - 1 is already out
        if events[k % 2] is not None:
            events[k % 2].synchronize()
        lo, hi = k * chunk, min(n, (k + 1) * chunk)
        flat[lo:hi].copy_(staging[k % 2][: hi - lo])
    return out


def fetch_np(x: torch.Tensor, dtype=None) -> np.ndarray:
    """Tensor on any device -> numpy array of ``dtype`` (``x``'s own by
    default), after all work queued on ``x``'s device before the call.

    A CUDA tensor whose result takes ``STAGE_MIN_BYTES`` or more downloads
    through its device's pinned staging ring (:func:`staged_fetch`), the
    cast fused into the host copy; the result is a fresh array the caller
    owns.  A smaller and a CPU tensor take ``.cpu().numpy()`` (on the CPU an
    array that shares the tensor's memory), then the cast.  A failed pinned
    allocation or copy raises: there is no pageable fallback.
    """
    x = x.detach()
    itemsize = x.element_size() if dtype is None else np.dtype(dtype).itemsize
    if x.device.type != "cuda" or x.numel() * itemsize < STAGE_MIN_BYTES:
        out = x.cpu().numpy()
        return out if dtype is None else out.astype(dtype, copy=False)
    ring = _ring(x.device)
    with ring.lock, torch.cuda.device(x.device):
        return staged_fetch(x, dtype, ring.buffers, ring.stream)


def _pack_full_dense(panel: np.ndarray):
    """CSR of a panel with no zero entries: the structure is implied."""
    import scipy.sparse as sp

    m, n = panel.shape
    indptr = np.arange(m + 1, dtype=np.int64) * n
    indices = np.tile(np.arange(n, dtype=np.int32), m)
    values = panel.reshape(-1).astype(np.float64)
    if indptr[-1] <= np.iinfo(np.int32).max:
        indptr = indptr.astype(np.int32)
    return sp.csr_matrix((values, indices, indptr), shape=(m, n))


def fetch_dense_to_csr(c: torch.Tensor, symmetric: bool = False, nnz: int | None = None):
    """Download a dense (m, n) panel and pack it into scipy CSR (f64) on the
    host.  A panel known to be 100% dense (``nnz == m*n``) skips the nonzero
    scan; a symmetric panel's zero lower triangle simply never packs."""
    from .native import dense_pack

    m, n = c.shape
    panel = fetch_np(c)
    if nnz is not None and not symmetric and nnz == m * n:
        return _pack_full_dense(panel)
    return dense_pack(panel)
