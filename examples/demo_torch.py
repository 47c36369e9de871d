"""End-to-end demo of the PyTorch/CUDA port, with numpy comparisons.

The port's counterpart of ``examples/demo.py``: the same five routines on the
same small matrices and seeds, the device-resident ``multiply``, the
distributed products over a row mesh of slots (several slots on one card
when there is one card), and one inversion step.  Every line it prints reads
``[ok]`` or ``[FAIL]``; it exits non-zero after a failure.

Run:  python examples/demo_torch.py              (on the CUDA card)
      python examples/demo_torch.py --device cpu
"""

import argparse
import os
import sys

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sparse_matrix_mult_tpu_torch as smt  # noqa: E402
from sparse_matrix_mult_tpu_torch.models.inversion import invert  # noqa: E402
from sparse_matrix_mult_tpu_torch.parallel import distributed as td  # noqa: E402
from sparse_matrix_mult_tpu_torch.parallel.mesh import row_mesh  # noqa: E402

FAILED = []


def check(name, got, expected, rtol=1e-5, atol=1e-8):
    ok = np.allclose(got, expected, rtol=rtol, atol=atol)
    print(f"[{'ok' if ok else 'FAIL'}] {name}")
    if not ok:
        FAILED.append(name)


def main(device: str) -> int:
    rng = np.random.default_rng(7)
    a = sp.random(3, 4, density=0.6, format="csr", random_state=1)
    b = sp.random(4, 4, density=0.6, format="csr", random_state=2)

    # 1. sparse x sparse -> sparse CSR
    r1 = smt.sparse_matrix_multiply(a, b, output_format="sparse", device=device)
    check("sparse x sparse -> sparse", r1.toarray(), (a @ b).toarray())

    # 2. sparse x sparse -> dense
    r2 = smt.sparse_matrix_multiply(a, b, output_format="dense", device=device)
    check("sparse x sparse -> dense", r2, (a @ b).toarray())

    # 3. symmetric sparse (upper triangle only); needs a square product
    sq = sp.random(4, 4, density=0.6, format="csr", random_state=4)
    r3 = smt.sparse_matrix_multiply(sq, b, output_format="sparse", symmetric=True, device=device)
    check("symmetric sparse (triu)", r3.toarray(), np.triu((sq @ b).toarray()))

    # 4. symmetric dense
    r4 = smt.sparse_matrix_multiply(sq, b, output_format="dense", symmetric=True, device=device)
    check("symmetric dense (triu)", r4, np.triu((sq @ b).toarray()))

    # 5. fused triple product H.Q.H^T
    h = sp.random(3, 4, density=0.7, format="csr", random_state=5)
    q = sp.random(4, 4, density=0.7, format="csr", random_state=6)
    ref = (h @ q @ h.T).toarray()
    r5 = smt.sparse_matrix_multiply(h, q, use_triple_product=True, device=device)
    check("triple product (triu)", r5, np.triu(ref))
    r5f = smt.sparse_matrix_multiply(h, q, use_triple_product=True, compute_full_matrix=1,
                                     device=device)
    check("triple product (full)", r5f, np.triu(ref) + np.triu(ref, 1).T)

    # Device-resident API: containers in, a tensor out, nothing leaves the
    # device (JAX's demo composes it under jax.jit; here it is a plain call).
    ad = smt.from_scipy(a, device=device)
    bd = smt.from_scipy(b, device=device)
    dense = smt.multiply(ad, bd, output_format="dense")
    check(f"device-resident multiply on {dense.device}", dense.cpu().numpy(), (a @ b).toarray())

    # Distributed: row-sharded operands over a mesh of slots (every card, or
    # four slots of the one device); densify-per-slot with a B ring.
    count = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    mesh = row_mesh() if count > 1 else row_mesh([device] * 4)
    big_a = sp.random(64, 48, density=0.2, format="csr", random_state=8)
    big_b = sp.random(48, 56, density=0.2, format="csr", random_state=9)
    sh = td.spgemm_csr_distributed(td.shard_csr(big_a, mesh), td.shard_csr(big_b, mesh),
                                   mesh=mesh)
    check(f"distributed CSR product over {mesh.size} slots", sh.to_scipy().toarray(),
          (big_a @ big_b).toarray())

    # Large-sparse engine: the same result, but nothing is densified -- B
    # blocks travel the ring as packed CSR.
    sh2 = td.spgemm_csr_distributed_sparse(big_a, big_b, mesh=mesh)
    check("distributed sparse-local-contraction product", sh2.to_scipy().toarray(),
          (big_a @ big_b).toarray())

    # Sparse distributed triple product: H.Q.H^T with neither operand
    # densified (two sparse rings; dense output panels only).
    hh = sp.random(16, 48, density=0.2, format="csr", random_state=12)
    qq = sp.random(48, 48, density=0.2, format="csr", random_state=13)
    check("distributed sparse triple product",
          np.asarray(td.triple_product_distributed_sparse(hh, qq, 1, mesh=mesh)),
          (hh @ qq @ hh.T).toarray())

    # Linear-inversion model: the reference's motivating workload, against
    # the dense formula in numpy (float32 on the card: rtol 1e-4).
    n_obs, n_state = 6, 20
    hm = sp.random(n_obs, n_state, density=0.4, format="csr", random_state=10)
    am = sp.random(n_state, n_state, density=0.2, format="csr", random_state=11)
    qm = (am @ am.T + sp.eye(n_state)).tocsr()
    y = rng.standard_normal(n_obs)
    x0 = np.zeros(n_state)
    r_diag = np.full(n_obs, 0.5)
    res = invert(smt.from_scipy(hm, device=device), smt.from_scipy(qm, device=device),
                 torch.from_numpy(y).to(device), torch.from_numpy(x0).to(device),
                 torch.from_numpy(r_diag).to(device))
    hd, qd = hm.toarray(), qm.toarray()
    s = hd @ qd @ hd.T + np.diag(r_diag)
    gain = qd @ hd.T @ np.linalg.inv(s)
    x_ref = x0 + gain @ (y - hd @ x0)
    p_ref = np.diag(qd - gain @ hd @ qd)
    x_post = res.x_post.cpu().numpy()
    check(f"inversion step: posterior mean norm {np.linalg.norm(x_post):.3f}", x_post, x_ref,
          rtol=1e-4, atol=1e-6)
    check(f"inversion step: min marginal variance {float(res.p_diag.min()):.3f}",
          res.p_diag.cpu().numpy(), p_ref, rtol=1e-4, atol=1e-6)

    name = torch.cuda.get_device_name(torch.device(device)) if torch.device(device).type == "cuda" \
        else "host CPU"
    print(f"[{'FAIL' if FAILED else 'ok'}] demo complete on device {device} ({name})")
    return 1 if FAILED else 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    sys.exit(main(parser.parse_args().device))
