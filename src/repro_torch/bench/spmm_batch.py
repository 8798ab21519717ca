"""SpMM batch-width sweep: does reordering's benefit grow or shrink with k?

For k ∈ {1, 2, 4, 8, 16, 32} RHS vectors, time `op.matmul(X[n, k])` under
the IOS protocol for each (matrix, scheme, engine) cell and report the
amortized time-per-vector. Two questions:

  * amortization — per-vector time should fall with k (the matrix stream
    and launch overhead are paid once per SpMM), fastest for the SELL
    engine whose k-tiled kernel (K2) reuses each chunk across the vector
    tile;
  * reordering × batching — reordering's speedup comes from x-gather
    locality, whose share of total traffic shrinks as matrix bytes
    amortize, so the rcm-vs-baseline ratio is expected to move with k
    (CSV column `speedup_vs_baseline`).

A spec with explicit engine and k axes (timing-only policy); the result
store makes repeat sweeps free and extending the k axis incremental.

    python -m repro_torch.bench.spmm_batch [--quick | --smoke] [--device cpu]

Writes spmm_batch.csv under common.results_dir().
"""
from __future__ import annotations

import argparse

import numpy as np

from ..experiments import ExperimentSpec, MeasurePolicy
from . import common

K_SWEEP = (1, 2, 4, 8, 16, 32)
ENGINES = ("sell", "csr", "auto")
SCHEMES = ("baseline", "rcm")

FULL_MATRICES = ("powerlaw_m16384_a21", "banded_shuf_m16384_bw8",
                 "stencil2d_shuf_128", "smallworld_m16384_k6")
QUICK_MATRICES = ("powerlaw_m16384_a21", "banded_shuf_m16384_bw8")
SMOKE_MATRICES = ("smoke_powerlaw", "smoke_banded")
CSV = "spmm_batch.csv"
HEADER = ["matrix", "scheme", "engine", "resolved_engine", "plan_label", "k",
          "spmm_ms", "per_vector_ms", "gflops", "speedup_vs_baseline"]


def spec(quick: bool = True, smoke: bool = False,
         iters: int | None = None) -> ExperimentSpec:
    matrices = SMOKE_MATRICES if smoke else (
        QUICK_MATRICES if quick else FULL_MATRICES)
    # smoke must still span k values ABOVE the SELL k-tile floor (8), so
    # the decreasing-per-vector gate reflects real amortization, not just
    # tile padding
    ks = (1, 2, 8, 32) if smoke else K_SWEEP
    return ExperimentSpec(
        name="spmm_batch", matrices=matrices, schemes=SCHEMES,
        engines=ENGINES, ks=ks,
        policy=MeasurePolicy(
            iters=iters if iters is not None else (3 if smoke else 6),
            warmup=2, with_yax=False, with_parallel=False,
            with_metrics=False))


def run(quick: bool = True, smoke: bool = False,
        iters: int | None = None, device=None) -> dict:
    sp = spec(quick=quick, smoke=smoke, iters=iters)
    rep = common.campaign_report(sp, device=device)
    matrices, ks = sp.matrices, sp.ks

    rows = []
    cells = {}
    for mname in matrices:
        for scheme in SCHEMES:
            for engine in ENGINES:
                for k in ks:
                    rec = rep.cell(mname, scheme, engine=engine, k=k)
                    cells[(mname, scheme, engine, k)] = rec
                    gflops = rec.get("spmm_gflops", rec["seq_ios_gflops"]
                                     if k == 1 else None)
                    rows.append([mname, scheme, engine, rec["engine"],
                                 rec["plan_label"], k,
                                 f"{rec['spmm_ms']:.4f}",
                                 f"{rec['per_vector_ms']:.4f}",
                                 f"{gflops:.3f}", ""])
    # speedup_vs_baseline: same (matrix, engine, k), scheme vs baseline
    for i, row in enumerate(rows):
        mname, scheme, engine, k = row[0], row[1], row[2], row[5]
        base = cells.get((mname, "baseline", engine, k))
        if base and scheme != "baseline":
            ratio = base["spmm_ms"] / cells[(mname, scheme, engine, k)]["spmm_ms"]
            rows[i][-1] = f"{ratio:.3f}"

    path = common.result_path(CSV)
    common.write_csv(path, HEADER, rows)

    # derived summary: amortization ratio per engine (k=1 per-vec time over
    # widest-k per-vec time, >1 means batching pays), plus the sell check
    kmax = ks[-1]
    derived = {"csv": path, "k_sweep": list(ks), "matrices": list(matrices)}
    for engine in ENGINES:
        ratios = []
        for mname in matrices:
            for scheme in SCHEMES:
                c1 = cells.get((mname, scheme, engine, 1))
                ck = cells.get((mname, scheme, engine, kmax))
                if c1 and ck:
                    ratios.append(c1["per_vector_ms"] / ck["per_vector_ms"])
        if ratios:
            derived[f"{engine}_amortization_x"] = round(
                float(np.median(ratios)), 2)
    sell1 = [cells[(m, s, "sell", 1)]["per_vector_ms"]
             for m in matrices for s in SCHEMES]
    sellk = [cells[(m, s, "sell", kmax)]["per_vector_ms"]
             for m in matrices for s in SCHEMES]
    derived["sell_per_vec_decreases"] = bool(
        np.median(sellk) < np.median(sell1))
    return derived


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny pass on the smoke matrices")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    derived = run(quick=args.quick, smoke=args.smoke, device=args.device)
    print(derived)
    if not derived.get("sell_per_vec_decreases", False):
        raise SystemExit("amortized per-vector time did not decrease with k "
                         "for the SELL engine")


if __name__ == "__main__":
    main()
