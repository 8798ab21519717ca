"""Quickstart: the Problem -> Plan -> Operator pipeline (repro_torch.api).

One staged call replaces the reorder/build/tune wiring: `plan()` picks
the (scheme, engine, shape) jointly, `Plan.build()` returns an operator
that CARRIES its permutation — `op(x)` takes x in the original index
space, so nothing here permutes vectors by hand.

    python -m repro_torch.examples.quickstart [--rows 100000] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..api import SpmvProblem, plan
from ..core.measure import ios
from ..core.sparse import metrics, partition
from ..device import resolve_device
from ..matrices import generators as G

SCHEMES = ["baseline", "rcm", "metis", "louvain", "patoh", "auto"]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a shuffled banded matrix: structure exists but is hidden (Fig. 1)
    mat = G.shuffle(G.banded(args.rows, 8, seed=0), seed=1)
    x_np = np.random.default_rng(0).standard_normal(mat.n)
    x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
    want = mat.spmv(x_np.astype(np.float32))

    print(f"matrix: {mat.m}x{mat.n}, nnz={mat.nnz}, "
          f"bandwidth={metrics.bandwidth(mat)}")

    problem = SpmvProblem(mat)
    out = []
    for scheme in SCHEMES:
        # engine="auto": the OSKI-style tuner picks the format per
        # reordered matrix; scheme "auto" additionally searches the
        # reordering axis (joint selection)
        pl = plan(problem, reorder=scheme, engine="auto", device=dev)
        op = pl.build(device=dev)
        # the operator accepts x in the ORIGINAL index space — verify it
        got = op(x).double().cpu().numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err < 1e-4, (scheme, err)
        # measurement opts out of the permutation wrapper (reordered space)
        ms = float(np.median(ios.run_ios(op.unwrap(), x, iters=8)))
        rmat = pl.reordered_matrix()
        panels = partition.static_partition(rmat, 8)
        print(f"{scheme:10s} plan={pl.label():22s} ios={ms:7.2f}ms "
              f"gflops={ios.gflops(rmat.nnz, np.array([ms]))[0]:5.2f} "
              f"bandwidth={metrics.bandwidth(rmat):7d} "
              f"LI(8)={metrics.load_imbalance(rmat, panels):.3f} "
              f"cut(8)={metrics.cut_volume(rmat, panels):8d} err={err:.1e}")
        out.append({"scheme": scheme, "plan": pl.label(), "ios_ms": ms,
                    "err": err})
    return out


if __name__ == "__main__":
    main()
