"""Paper Fig. 11: nnz-balanced vs static scheduling speedups (reverse CDF)
per scheme. Claim: balance-improving schemes (METIS/PaToH/Louvain) lose
their edge under an nnz-balanced schedule; RCM's curves coincide.
A "parallel" campaign over the topology-aware facade: the two schedules
are the static / nnz_balanced PARTITIONERS of an 8-device 1d_rows
topology, each cell timing the plan's own panels with the calibrated
modelled-parallel protocol (same store as figs 4/9/10)."""
from __future__ import annotations

import numpy as np

from ..core.measure import profiles
from ..experiments import ExperimentSpec, MeasurePolicy
from ..experiments.cells import parallel_variant
from . import common

P = 8
SCHEDULES = ("static", "nnz_balanced")
CSV = "fig11_nnz_balanced.csv"
HEADER = ["scheme", "schedule", "speedup", "rev_cdf"]


def spec(iters: int = 12, matrices=None) -> ExperimentSpec:
    return ExperimentSpec(
        name="fig11_nnz_balanced", matrices=common.locality_names(matrices),
        schemes=tuple(common.SCHEMES), engines=("csr",), ps=(P,),
        variants=tuple(parallel_variant("1d_rows", s) for s in SCHEDULES),
        kind="parallel",
        policy=MeasurePolicy(iters=iters, with_yax=False,
                             with_parallel=False, with_metrics=False))


def run(quick: bool = False, matrices=None, device=None):
    sp = spec(iters=8 if quick else 12, matrices=matrices)
    mats = sp.matrices
    rep = common.campaign_report(sp, device=device)
    schemes = [s for s in common.SCHEMES if s != "baseline"]
    sp_by_sched = {
        sched: rep.speedup("gflops", mats, schemes,
                           variant=parallel_variant("1d_rows", sched))
        for sched in SCHEDULES}
    rows, out = [], {}
    for i, s in enumerate(schemes):
        for kind in SCHEDULES:
            v, c = profiles.reverse_cdf(sp_by_sched[kind][i])
            for vi, ci in zip(v, c):
                rows.append([s, kind, round(float(vi), 4),
                             round(float(ci), 4)])
        gap = float(np.median(sp_by_sched["static"][i])
                    - np.median(sp_by_sched["nnz_balanced"][i]))
        out[f"{s}_static_minus_balanced_median"] = round(gap, 4)
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return out
