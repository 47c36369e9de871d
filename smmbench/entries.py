"""The system under test: the port's entry that a traffic mix names.

A traffic mix (``traffic/<name>.json``) says which device-resident entry
of ``sparse_matrix_mult_tpu_torch`` each call runs (``entry``: ``multiply``
or ``triple_product``), on which of the configuration's operands
(``operands``), with which keywords (``kwargs``), which sizes the caller
works out once from the operands' structure (``sizing``: ``out_capacity``,
the bound on the answer's entries; ``windowed_plan``, the windowed ESC
engine's window and capacities, as a caller that repeats one structure
does), and the keywords of the same request through the scipy entry
``sparse_matrix_multiply`` (``scipy_kwargs``), timed for information only.
The operands live on the card in the port's containers; before each call
their values are drawn anew from the seed (outside the call's time).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import sparse_matrix_mult_tpu_torch as smt
from sparse_matrix_mult_tpu_torch.ops.spgemm_esc import windowed_plan

from . import operands, work
from .operands import Csr
from .reference import products

ENTRIES = ("multiply", "triple_product")
SIZINGS = ("out_capacity", "windowed_plan")


class Subject:
    """One cell's calls of the port: the containers, the sizes worked out
    once, and the call."""

    def __init__(self, traffic: dict, config: dict, made: dict, device):
        self.traffic, self.config, self.device = traffic, config, torch.device(device)
        self.entry = traffic["entry"]
        if self.entry not in ENTRIES:
            raise ValueError(f"unknown entry {self.entry!r}; one of {ENTRIES}")
        self.names = list(traffic["operands"])
        if len(self.names) != 2:
            raise ValueError(f"{self.entry} takes two operands, the traffic names {self.names}")
        self.kwargs = dict(traffic.get("kwargs", {}))
        self.dtype = operands.dtype_of(config["dtype"])
        self.made = made
        self.mats = {}
        for name in self.names:
            indptr, indices, shape = made[name]
            nnz = indices.numel()
            cap = smt.bucket_capacity(nnz)
            idx = torch.zeros(cap, dtype=torch.int32, device=self.device)
            idx[:nnz] = indices
            vals = torch.zeros(cap, dtype=self.dtype, device=self.device)
            self.mats[name] = smt.CSRMatrix(indptr.to(torch.int32), idx, vals, shape)
        self.partials = None
        if self.entry == "multiply":
            self._size_multiply(traffic.get("sizing", []))
        elif traffic.get("sizing"):
            raise ValueError(f"{self.entry} takes no sizing")
        self.output = "csr" if self.entry == "multiply" else "dense"
        self._call = self._program

    def _size_multiply(self, sizing):
        a_name, b_name = self.names
        a_indices = self.made[a_name][1].cpu().numpy()
        b_indptr = self.made[b_name][0].cpu().numpy()
        lens = np.diff(b_indptr)[a_indices]
        expand = int(lens.sum())
        self.partials = expand
        (m, _), (_, n) = self.shapes
        for what in sizing:
            if what not in SIZINGS:
                raise ValueError(f"unknown sizing {what!r}; one of {SIZINGS}")
        if "out_capacity" in sizing:
            bound = work.triu_entries(m, n) if self.kwargs.get("symmetric") else m * n
            self.kwargs["out_capacity"] = smt.bucket_capacity(min(expand, bound))
        if "windowed_plan" in sizing:
            plan = windowed_plan(len(a_indices), lens, expand)
            if plan is None:
                raise ValueError("windowed_plan finds no window for these operands")
            window, tail = plan
            self.kwargs.update(window=window, expand_capacity=smt.bucket_capacity(expand),
                               tail_capacity=smt.bucket_capacity(tail) if tail else 0)

    @property
    def shapes(self) -> list:
        return [self.made[name][2] for name in self.names]

    def refresh(self, seed: int, call: int) -> None:
        """Draw every operand's values for call ``call``."""
        for name in self.names:
            nnz = self.made[name][1].numel()
            self.mats[name].values[:nnz].copy_(
                operands.call_values(self.config, name, seed, call, self.device))

    def _program(self):
        a, b = (self.mats[name] for name in self.names)
        if self.entry == "multiply":
            return smt.multiply(a, b, **self.kwargs)
        return smt.triple_product(a, b, **self.kwargs)

    def call(self):
        return self._call()

    def use_control(self) -> None:
        """Put the reference, computed in bf16 (``products.BF16``), in the
        program's place: the control that ``correct`` must refuse."""
        def control():
            a, b = (self._plain(name) for name in self.names)
            if self.entry == "triple_product":
                return products.triple(a, b, bool(self.kwargs.get("compute_full_matrix")),
                                       products.BF16)
            return products.product(a, b, bool(self.kwargs.get("symmetric")), products.BF16)
        self._call = control

    def _plain(self, name) -> Csr:
        indptr, indices, shape = self.made[name]
        return Csr(indptr, indices, self.mats[name].values[:indices.numel()], shape)

    def entries(self, answer) -> int:
        """Entries of an answer: a CSR answer's stored entries, a dense one's m n."""
        return int(answer.indptr[-1]) if self.output == "csr" else int(answer.numel())

    def work(self, out_entries: int) -> dict:
        return work.entry_work(self.entry, self.kwargs, self.shapes, out_entries)

    def scipy_round_trip(self, calls: int = 3) -> str:
        """The same request through ``sparse_matrix_multiply``, scipy in and
        out, ``calls`` times: its route, seconds per call and entries per second."""
        a, b = (smt.to_scipy(self.mats[name]) for name in self.names)
        kw = dict(self.traffic.get("scipy_kwargs", {}))
        seconds, routes, entries = [], set(), 0
        for _ in range(calls):
            t = time.perf_counter()
            out = smt.sparse_matrix_multiply(a, b, **kw)
            seconds.append(time.perf_counter() - t)
            routes.add(smt.get_last_route())
            entries = int(out.nnz) if hasattr(out, "nnz") else int(np.asarray(out).size)
        med = float(np.median(seconds))
        return (f"scipy round trip: route {sorted(routes)}, seconds per call {seconds}, "
                f"{entries / med:.6e} entries/s at the median")

    def close(self) -> None:
        """Let go of the program's containers."""
        self.mats.clear()
