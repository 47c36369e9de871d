#!/usr/bin/env python3
"""Run one cell of the benchmark on the CUDA cards of this machine.

    python smmbench/run.py --workload readme_10k.sym_csr --seed 7 --seconds 10 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, traced ``breakdown``,
and ``checks``: each number compared with the reference beside its
limit, which also close standard error.  ``--control`` puts the reference,
computed in bf16, in the program's place; ``correct`` must come out false.

With no CUDA card, fewer cards than the cell asks for, a port imported
from anywhere but this checkout, or a forbidden module (JAX, the JAX
package, the harnesses around it) loaded once the window has closed, it
prints no result and exits non-zero.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, "build", "smmbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="the reference in bf16 in the program's place (must read incorrect)")
    args = p.parse_args(argv)

    _cache_dirs()
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    import torch

    from smmbench import harness

    port = os.path.dirname(os.path.abspath(sys.modules["sparse_matrix_mult_tpu_torch"].__file__))
    if os.path.dirname(port) != ROOT:
        print(f"smmbench: the port was imported from {port}, not from this checkout; "
              "nothing was run", file=sys.stderr)
        return 4
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = harness._named(json.load(f)["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"smmbench: {args.workload} needs {chips} CUDA card(s), found {found}; "
              "nothing was run", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         control=args.control, started=STARTED)
    if "forbidden" in result:
        print(f"smmbench: forbidden modules loaded: {', '.join(result['forbidden'])}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
