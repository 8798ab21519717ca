"""Conjugate-Gradient solve — the paper's "real application" — with and
without reordering, through the Problem -> Plan -> Operator pipeline.

The permutation-carrying operator keeps the WHOLE solve in the original
index space: no permuting b before the solve, no un-permuting x after.

    python -m repro_torch.examples.cg_solver [--grid 120] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api import SpmvProblem, plan
from ..core.measure import cg
from ..device import resolve_device
from ..matrices import generators as G


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=120,
                    help="side of the 2-D Laplacian (grid**2 unknowns)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mat = G.shuffle(G.stencil_2d(args.grid, seed=0), seed=1)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(mat.n)
    b_np = mat.spmv(x_true).astype(np.float32)
    b = torch.as_tensor(b_np, device=dev)

    out = {}
    for scheme in ["baseline", "rcm"]:
        t0 = time.time()
        res, op = cg.solve_problem(mat, b, reorder=scheme, engine="csr",
                                   max_iter=300, tol=1e-5, device=dev)
        dt = time.time() - t0
        # res.x is already in the original index space: check A x = b
        x = res.x.double().cpu().numpy()
        err = float(np.abs(mat.spmv(x) - b_np).max())
        print(f"{scheme:9s} iters={int(res.iters):4d} "
              f"residual={float(res.residual):.2e} check={err:.2e} "
              f"wall={dt:.2f}s")
        out[scheme] = {"iters": int(res.iters), "check": err}

    # the Block-ELL engine (K4 on the card, its plain version on the CPU)
    # agrees with CSR on one SpMV of a smaller grid
    small = G.stencil_2d(32, seed=0)
    bs = torch.as_tensor(small.spmv(rng.standard_normal(small.n)),
                         dtype=torch.float32, device=dev)
    pb = SpmvProblem(small, hints={"block_shape": (8, 16)})
    op_bell = plan(pb, reorder="baseline", engine="bell",
                   device=dev).build(device=dev)
    op_csr = plan(SpmvProblem(small), reorder="baseline", engine="csr",
                  device=dev).build(device=dev)
    y_bell = op_bell(bs).double().cpu().numpy()
    y_csr = op_csr(bs).double().cpu().numpy()
    err = float(np.abs(y_bell - y_csr).max() / (np.abs(y_csr).max() + 1e-9))
    print(f"bell engine vs csr: max rel err {err:.2e}")
    out["bell_vs_csr"] = err
    return out


if __name__ == "__main__":
    main()
