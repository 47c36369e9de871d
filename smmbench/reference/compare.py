"""An answer against its reference: the numbers ``correct`` is decided by.

* ``structure_mismatch``: row pointers and column indices of a CSR answer
  that differ from the reference's, plus the difference of their counts.
  Exact: its limit is 0.
* ``value_share``: the largest |answer - reference| over what the
  configuration's oracle allows there, ``atol + rtol |reference|`` (the
  reference package's ``np.allclose``): the answer passes at 1 or below.
  None where the structures differ and no value can be paired.
* ``asymmetry``: entries of a full symmetric answer that differ from their
  mirror.  Exact: its limit is 0.
"""

from __future__ import annotations

import torch


def _share(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float | None:
    """The largest |got - want| / (atol + rtol |want|); None where an answer
    is not a finite number."""
    if not want.numel():
        return 0.0
    want = want.to(torch.float64)
    diff = (got.to(torch.float64) - want).abs()
    share = float((diff / (atol + rtol * want.abs())).max())
    return share if share == share and share != float("inf") else None


def csr_reading(got, blocks, rows: int, rtol: float, atol: float) -> dict:
    """A CSR answer (``indptr``, ``indices`` and ``values`` tensors, padded
    past ``indptr[-1]`` or not) against the reference's row blocks
    (:func:`.products.product_blocks`)."""
    indptr = got.indptr.to(torch.int64)
    if indptr.numel() != rows + 1 or int(indptr[0]) != 0:
        return dict(structure_mismatch=rows + 1, value_share=None)
    stored = int(indptr[-1])
    if stored > min(got.indices.numel(), got.values.numel()):
        return dict(structure_mismatch=rows + 1, value_share=None)
    mismatch, share = 0, 0.0
    for r0, r1, ref in blocks:
        g0 = int(indptr[r0])
        local = indptr[r0:r1 + 1] - g0
        mismatch += int((local != ref.indptr).sum())
        count = int(local[-1])
        if count != ref.indices.numel():
            mismatch += abs(count - ref.indices.numel())
            continue
        mismatch += int((got.indices[g0:g0 + count].to(torch.int64) != ref.indices).sum())
        if not mismatch and share is not None:
            block = _share(got.values[g0:g0 + count], ref.values, rtol, atol)
            share = None if block is None else max(share, block)
    return dict(structure_mismatch=mismatch, value_share=None if mismatch else share)


def dense_reading(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
                  symmetric: bool) -> dict:
    """A dense answer against the dense reference; ``asymmetry`` where the
    answer must be its own mirror."""
    if tuple(got.shape) != tuple(want.shape):
        out = dict(value_share=None)
    else:
        out = dict(value_share=_share(got, want, rtol, atol))
    if symmetric:
        square = got.dim() == 2 and got.shape[0] == got.shape[1]
        out["asymmetry"] = int((got != got.T).sum()) if square else got.numel()
    return out
