#!/usr/bin/env python3
"""Run the same kernel calls in two checkouts of the port on one GPU, in turns.

Run from the repository root, with another checkout (an earlier commit, say,
unpacked with ``git archive`` into a directory that .gitignore lists):

    python3 tools/compare_checkouts.py OTHER_ROOT

Each turn is a process that imports sparse_matrix_mult_tpu_torch from one
checkout (its kernels built from that checkout's csrc/) and runs, at the
operands chip_smoke.py gives them: K1 in both branches and both forms at the
10k headline, K3 on the 10k operand and on the inversion's Q, K2 on the 10k
headline's upper triangle, K4 and K7 on the ~36%-dense 12,288^2 product, and
K5 and K6 on the 8192^2 BSR operands.  For each call it reports the SHA-256
of the output (K1's upper triangle; K2/K4/K7's three arrays) and its
CUDA-event times, warm, min of 5, with chip_smoke.py's timer: the whole call
on an idle stream (ms) and the device's time alone (device_ms).  The first
turn also keeps its K6 product; each later turn reports its own K6's largest
distance from it in units of (|A| |B|), for checkouts whose K6 bits differ,
which must stay within 1e-5 (``k6_within_rtol``).  The turns run other,
this, this, other; the last line is a JSON object with every turn's results
and, per call, whether the two checkouts gave the same bits.  Needs a CUDA
device.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def worker(root: str, k6_first: str) -> dict:
    """The calls, in the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    import sparse_matrix_mult_tpu_torch as smt
    from sparse_matrix_mult_tpu_torch.ops.kernels import bsr_spgemm as kb
    from sparse_matrix_mult_tpu_torch.ops.kernels import convert_kernels as ck
    from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm

    if not os.path.abspath(smt.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {smt.__file__}, not the checkout at {root}")
    # This checkout's operand builders and timer (scipy and torch only).
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    def run(label, fn, keep=lambda x: x):
        got = keep(fn())
        out[label] = dict(sha256=_digest(got), ms=cs.event_ms(fn),
                          device_ms=cs.event_ms(fn, queued=True))

    a_sp, b_sp = cs.operands(cs.N, cs.DENSITY, (1, 2))
    a = smt.from_scipy(a_sp, dtype=torch.float32, device="cuda")
    b = smt.from_scipy(b_sp, dtype=torch.float32, device="cuda")
    run("k3_operand_10k", lambda: ck.csr_to_dense(a.indptr, a.indices, a.values, a.shape))
    ad = ck.csr_to_dense(a.indptr, a.indices, a.values, a.shape)
    bd = ck.csr_to_dense(b.indptr, b.indices, b.values, b.shape)
    bt = bd.T.contiguous()
    for split3 in (False, True):
        branch = "split3" if split3 else "highest"
        run(f"k1_{branch}_a_b", lambda: tm.matmul_triu(ad, bd, split3=split3), torch.triu)
        run(f"k1_{branch}_a_bt", lambda: tm.matmul_triu(ad, bt, True, split3), torch.triu)
    del ad, bd, bt
    q = smt.from_scipy(cs.inversion_problem()[1], dtype=torch.float32, device="cuda")
    run("k3_inversion_q", lambda: ck.csr_to_dense(q.indptr, q.indices, q.values, q.shape))
    del q
    a_bsr = smt.bsr_from_scipy(cs.block_sparse(cs.BSR_SEEDS[0]), cs.BSR_BLOCK, torch.float32,
                               device="cuda")
    bu = smt.from_scipy(cs.uniform_bu(), dtype=torch.float32, device="cuda")
    bud = ck.csr_to_dense(bu.indptr, bu.indices, bu.values, bu.shape)
    run("k5_bsr_x_dense_8192", lambda: kb.bsr_matmul_dense(a_bsr, bud))
    del bud

    # K6 at the BSR path's operands: against the first turn's product.
    b_sp = cs.block_sparse(cs.BSR_SEEDS[1])
    b_bsr = smt.bsr_from_scipy(b_sp, cs.BSR_BLOCK, torch.float32, device="cuda")
    plan = kb.bsr_pair_plan(cs.block_sparse(cs.BSR_SEEDS[0]), b_sp, cs.BSR_BLOCK)
    n = plan["n_pairs"]
    tables = [torch.from_numpy(plan[k][:n]).cuda() for k in ("pa", "pb", "ci", "cj", "first")]
    mask = torch.from_numpy(plan["mask"]).cuda()
    run("k6_bsr_x_bsr_8192", lambda: kb.bsr_bsr_matmul_dense(a_bsr, b_bsr, *tables, mask))
    got = kb.bsr_bsr_matmul_dense(a_bsr, b_bsr, *tables, mask).double()
    if os.path.exists(k6_first):
        first = torch.from_numpy(np.load(k6_first)).cuda().double()
        unit = (smt.bsr_to_dense(cs.abs_bsr(a_bsr)).double()
                @ smt.bsr_to_dense(cs.abs_bsr(b_bsr)).double()).clamp(min=1e-30)
        out["k6_bsr_x_bsr_8192"]["vs_first_turn_of_unit"] = float(((got - first).abs()
                                                                    / unit).max())
    else:
        np.save(k6_first, got.float().cpu().numpy())
    del got, a_bsr, b_bsr, tables, mask

    # K2 on the 10k headline's upper triangle, K4 on the 12,288^2 product.
    ad = ck.csr_to_dense(a.indptr, a.indices, a.values, a.shape)
    bd = ck.csr_to_dense(b.indptr, b.indices, b.values, b.shape)
    c = torch.triu(cs.fp32_matmul(ad, bd))
    del ad, bd
    cap = smt.bucket_capacity(int(torch.count_nonzero(c)))
    run("k2_triu_10k", lambda: ck.dense_to_csr(c, cap, triu=True))
    del c
    sa, sb = (smt.from_scipy(x, dtype=torch.float32, device="cuda")
              for x in cs.operands(cs.SIB_N, cs.SIB_DENSITY, (3, 4)))
    c = cs.fp32_matmul(ck.csr_to_dense(sa.indptr, sa.indices, sa.values, sa.shape),
                       ck.csr_to_dense(sb.indptr, sb.indices, sb.values, sb.shape))
    cap = smt.bucket_capacity(int(torch.count_nonzero(c)))
    run("k4_12288", lambda: ck.dense_to_csr(c, cap))
    run("k7_12288", lambda: ck.dense_to_csr_fused(c, cap))
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2], sys.argv[3])))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    turns = []
    scratch = tempfile.TemporaryDirectory()
    k6_first = os.path.join(scratch.name, "k6_first_turn.npy")
    for name, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               k6_first], cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            scratch.cleanup()
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(dict(checkout=name, root=root, results=result))
        print(f"[{name}] " + " | ".join(f"{k} {v['ms']:.3f} ms (device {v['device_ms']:.3f})"
                                        for k, v in result.items()), flush=True)
    scratch.cleanup()
    same = {k: len({t["results"][k]["sha256"] for t in turns}) == 1 for k in turns[0]["results"]}
    # K6's bits may differ between checkouts (another summation order); each
    # turn must stay within 1e-5 of (|A| |B|) of the first turn's product.
    k6_far = max(t["results"]["k6_bsr_x_bsr_8192"].get("vs_first_turn_of_unit", 0.0)
                 for t in turns)
    print(f"K6 at most {k6_far:.2e} of (|A| |B|) from the first turn's product "
          f"({'within' if k6_far <= 1e-5 else 'OUTSIDE'} 1e-5)")
    print(smi)
    print(json.dumps(dict(card=smi, turns=turns, same_bits=same, k6_within_rtol=k6_far <= 1e-5)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
