"""Paper Figs. 9 & 10: nnz load imbalance of the static schedule under each
reordering, absolute (Fig. 9, 64 panels) and relative to baseline (Fig. 10).
These are exact analytic quantities (no timing): a "parallel" campaign
over the topology-aware facade, each cell planning a 64-device 1d_rows
topology with the static partitioner and recording the partition-quality
metrics (LI, cut volume, halo width) beside the modelled collective
bytes, all in the shared result store (time_spmv=False cells never build
an operator)."""
from __future__ import annotations

import numpy as np

from ..experiments import ExperimentSpec, MeasurePolicy
from ..experiments.cells import parallel_variant
from . import common

P64 = 64
VARIANT = parallel_variant("1d_rows", "static")
CSV = "fig09_load_imbalance.csv"
HEADER = ["matrix", "scheme", "li_static_64"]
CSV_RELATIVE = "fig10_relative_li.csv"
HEADER_RELATIVE = ["matrix", "scheme", "li_over_baseline"]


def spec(quick: bool = False, matrices=None) -> ExperimentSpec:
    from ..matrices import suite

    # locality tier + a representative bench-tier slice (full 33-matrix
    # sweep is reorder-bound; LI is analytic so the subset is unbiased)
    if matrices is None:
        matrices = (suite.bench_names()[:8] if quick
                    else suite.bench_names()[:12] + suite.locality_names())
    return ExperimentSpec(
        name="fig9_li", matrices=tuple(matrices),
        schemes=tuple(common.SCHEMES), engines=("csr",), ps=(P64,),
        variants=(VARIANT,), kind="parallel",
        policy=MeasurePolicy(time_spmv=False, with_yax=False,
                             with_parallel=False, with_metrics=False))


def run(quick: bool = False, matrices=None, device=None):
    sp = spec(quick, matrices)
    rep = common.campaign_report(sp, device=device)
    mats, schemes = sp.matrices, common.SCHEMES
    li = rep.grid("li", mats, schemes)                 # [scheme, matrix]
    rows = [[name, s, round(float(li[i, j]), 4)]
            for j, name in enumerate(mats) for i, s in enumerate(schemes)]
    common.write_csv(common.result_path(CSV), HEADER, rows)

    base = li[schemes.index("baseline")]
    out = {}
    rel_rows = []
    for s in schemes:
        if s == "baseline":
            continue
        rel = li[schemes.index(s)] / base     # <1 = improved balance
        out[f"{s}_improved_frac"] = round(float((rel < 0.999).mean()), 3)
        out[f"{s}_geomean_rel_li"] = round(
            float(np.exp(np.mean(np.log(rel)))), 3)
        for name, r in zip(mats, rel):
            rel_rows.append([name, s, round(float(r), 4)])
    common.write_csv(common.result_path(CSV_RELATIVE), HEADER_RELATIVE,
                     rel_rows)
    return out
