"""Operands made on the device from the run's seed.

A configuration's operand is a ``rows x cols`` matrix with ``nnz``
distinct entries placed uniformly: every ``nnz``-subset of the positions
is equally likely (the Erdos-Renyi G(n, M) model, and what
``scipy.sparse.random`` places).  Its structure is drawn once a run; its
values are drawn anew for every call, uniform in (0, 1] and never 0, so no
entry of a product cancels and the product's structure is the structural
product of the operands'.  Every stream has its own generator seeded from
(seed, what, operand, call), so the reference can draw any call's
operands again after the window.

This module is the yardstick's: it imports nothing of the port.
"""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import torch


class Csr(NamedTuple):
    """A CSR matrix of plain tensors: ``indptr`` (rows + 1) and ``indices``
    (nnz) int64, ``values`` (nnz); sorted columns within each row."""

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    shape: tuple


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one stream of a run, from any whole
    ``seed`` (more than 64 bits are fine) and the stream's name parts."""
    digest = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *parts))
    return g


def structure(rows: int, cols: int, nnz: int, g: torch.Generator, device):
    """(indptr, indices), int64, of ``nnz`` distinct positions of a
    ``rows x cols`` matrix, every ``nnz``-subset equally likely: positions
    are drawn with replacement until at least ``nnz`` are distinct, and a
    uniform ``nnz`` of the distinct ones kept."""
    cells = rows * cols
    if not 0 <= nnz <= cells:
        raise ValueError(f"{nnz} entries do not fit in {rows} x {cols}")
    if nnz == cells:
        keys = torch.arange(cells, device=device)
    else:
        # Draws whose expected distinct count is nnz, and a margin of a few
        # standard deviations: one round almost always suffices.
        draws = int(-cells * math.log1p(-nnz / cells) * 1.002 + 8 * math.sqrt(nnz) + 64)
        while True:
            keys = torch.unique(torch.randint(0, cells, (draws,), generator=g, device=device))
            if keys.numel() >= nnz:
                break
            draws = 2 * draws
        keep = torch.randperm(keys.numel(), generator=g, device=device)[:nnz]
        keys = keys[torch.sort(keep).values]
    counts = torch.bincount(keys // cols, minlength=rows)
    indptr = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, keys % cols


def values(nnz: int, g: torch.Generator, dtype, device) -> torch.Tensor:
    """``nnz`` values uniform in (0, 1], drawn in float64 and stored in ``dtype``."""
    return (1.0 - torch.rand(nnz, dtype=torch.float64, generator=g, device=device)).to(dtype)


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype a configuration names (``"float32"``, ``"float64"``)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"not a floating dtype: {name!r}")
    return dtype


def make(config: dict, names, seed: int, device) -> dict:
    """Each named operand's structure from the seed, values not yet drawn:
    {name: (indptr, indices, shape)}."""
    out = {}
    for name in names:
        spec = config["operands"][name]
        g = generator(device, seed, "structure", name)
        indptr, indices = structure(spec["rows"], spec["cols"], spec["nnz"], g, device)
        out[name] = (indptr, indices, (spec["rows"], spec["cols"]))
    return out


def call_values(config: dict, name: str, seed: int, call: int, device) -> torch.Tensor:
    """Operand ``name``'s values in call ``call`` of the run."""
    spec = config["operands"][name]
    g = generator(device, seed, "values", name, call)
    return values(spec["nnz"], g, dtype_of(config["dtype"]), device)


def call_operand(config: dict, made: dict, name: str, seed: int, call: int, device) -> Csr:
    """Operand ``name`` of call ``call`` as a :class:`Csr`, drawn again."""
    indptr, indices, shape = made[name]
    return Csr(indptr, indices, call_values(config, name, seed, call, device), shape)
