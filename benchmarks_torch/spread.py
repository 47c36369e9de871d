#!/usr/bin/env python3
"""The spread of the bench's metrics over several runs, and the bounds it gives.

    python benchmarks_torch/spread.py RUN1.json RUN2.json RUN3.json
    python benchmarks_torch/spread.py --copies ABBA A1.json B1.json B2.json A2.json

Each file is one whole run of ``bench.py --json`` (each run in its own
processes).  A metric's value is its window's entries over the window's
seconds.  For each cell and metric it prints each run's value, the spread
within a run (the interquartile range of the rates of the window's
consecutive blocks of calls, over their median) and between runs (the
range of the runs' values over their median), and, for reference, the
interquartile range of the calls' rates one by one.  A metric's bound, by
which a later change may worsen it before it counts as a regression, is
the larger of 3% and twice the largest relative spread seen, within a run
or between runs: per cell, and over all cells (the last line, one JSON
object).

``--copies`` names the copy of the tree each run came from, one letter per
run (two copies of one tree, run in turn A, B, B, A): it adds each cell's
A/A gap, the relative gap between the two copies' medians (over the
smaller), beside the bound ``bounds.json`` fixes for that cell, and no
bound it gives is below twice that gap.  Two copies of identical code must
read within a cell's bound, or it would refuse an honest change.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

FLOOR = 0.03
# The six cells' bounds as the benchmark fixed them when it was this
# harness's (its manifest at commit a196ef7), frozen beside it.
BOUNDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bounds.json")


def _iqr(stats: dict) -> float:
    return (stats["q3"] - stats["q1"]) / stats["median"]


def spreads(runs: list) -> dict:
    """By cell and metric: the medians, the spreads and the bound."""
    out = {}
    for cell in runs[0]["cells"]:
        for side in ("call", "device"):
            readings = [run["cells"][cell][side] for run in runs]
            if not all(r.get("correct") for r in readings):
                raise ValueError(f"{cell} {side}: a run was not correct")
            values = [r["value"] for r in readings]
            within = max(_iqr(r["per_block"]) for r in readings)
            between = (max(values) - min(values)) / float(np.median(values))
            out.setdefault(cell, {})[readings[0]["metric"]] = dict(
                values=values, within_iqr=within, between_runs=between,
                per_call_iqr=max(_iqr(r["per_call"]) for r in readings),
                bound=max(FLOOR, 2 * max(within, between)))
    return out


def aa_gaps(runs: list, copies: str, bounds: dict) -> dict:
    """By cell and metric: each copy's median, their relative gap over the
    smaller, and whether it lies within the cell's bound (``bounds``, by
    cell and metric; None where the cell has none)."""
    if len(copies) != len(runs) or len(set(copies)) != 2:
        raise ValueError(f"--copies {copies!r}: one letter per run, two copies")
    first, second = sorted(set(copies))
    out = {}
    for cell in runs[0]["cells"]:
        for side in ("call", "device"):
            readings = [run["cells"][cell][side] for run in runs]
            metric = readings[0]["metric"]
            med = {c: float(np.median([r["value"] for r, k in zip(readings, copies) if k == c]))
                   for c in (first, second)}
            gap = abs(med[first] - med[second]) / min(med.values())
            bound = bounds.get(cell, {}).get(metric)
            out.setdefault(cell, {})[metric] = dict(
                medians=med, gap=gap, bound=bound, within=None if bound is None else gap <= bound)
    return out


def committed_bounds(path: str = BOUNDS) -> dict:
    """The bounds ``bounds.json`` fixes, by cell and metric."""
    with open(path) as f:
        return {w["name"]: w.get("bounds", {}) for w in json.load(f)["workloads"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("runs", nargs="+", help="bench.py --json files, one per whole run")
    p.add_argument("--copies", help="the copy each run came from, one letter per run (ABBA)")
    args = p.parse_args(argv)
    runs = []
    for path in args.runs:
        with open(path) as f:
            runs.append(json.load(f))
    cells = spreads(runs)
    out = dict(runs=len(runs), cells=cells)
    if args.copies:
        out["aa"] = aa_gaps(runs, args.copies, committed_bounds())
        for cell, metrics in out["aa"].items():
            for metric, g in metrics.items():
                s = cells[cell][metric]
                s["bound"] = max(s["bound"], 2 * g["gap"])
                within = {None: "no bound", True: "within", False: "OUTSIDE"}[g["within"]]
                print(f"{cell} {metric}: A/A medians " + ", ".join(
                    f"{c} {m:.4e}" for c, m in g["medians"].items())
                      + f" | gap {g['gap']:.4f} | committed bound {g['bound']} | {within}")
    bounds = {}
    for cell, metrics in cells.items():
        for metric, s in metrics.items():
            bounds[metric] = max(bounds.get(metric, 0.0), s["bound"])
            print(f"{cell} {metric}: values {', '.join(f'{m:.4e}' for m in s['values'])} | "
                  f"within a run (blocks' IQR/median) up to {s['within_iqr']:.4f} | between "
                  f"runs {s['between_runs']:.4f} | bound {s['bound']:.4f} | calls' "
                  f"IQR/median up to {s['per_call_iqr']:.4f}")
    out["bounds"] = bounds
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
