"""Paper Fig. 4 (adapted): scheduling-policy sweep.

OpenMP dynamic/guided have no analogue in one SPMD launch, so the
reproduced claim is the STATIC family's ordering: default static (one
maximal contiguous chunk) >= static,chunk for chunk in {16, 64} —
temporal locality grows with chunk size. Parallel times come from the
calibrated panel model (modelled parallel, labelled).

The policies are PARTITIONERS of an 8-device 1d_rows topology ("parallel"
cell kind): static, chunked_cyclic_c16/c64 (whose grouping permutation
makes each thread's strided row set a contiguous panel — including its
striding locality loss), and nnz_balanced.
"""
from __future__ import annotations

import numpy as np

from ..core.measure import profiles
from ..experiments import ExperimentSpec, MeasurePolicy
from ..experiments.cells import parallel_variant
from . import common

P = 8
# CSV policy label -> partitioner (the legacy fig-4 naming is the schema)
POLICY_PARTITIONERS = {
    "static_default": "static",
    "static_c16": "chunked_cyclic_c16",
    "static_c64": "chunked_cyclic_c64",
    "nnz_balanced": "nnz_balanced",
}
POLICIES = tuple(POLICY_PARTITIONERS)
CSV = "fig04_scheduling.csv"
HEADER = ["matrix", "policy", "modelled_par_ms", "gflops"]


def spec(quick: bool = False, matrices=None) -> ExperimentSpec:
    mats = common.locality_names(matrices)
    if quick and matrices is None:
        mats = mats[:4]
    return ExperimentSpec(
        name="fig4_scheduling", matrices=tuple(mats), schemes=("baseline",),
        engines=("csr",), ps=(P,), kind="parallel",
        variants=tuple(parallel_variant("1d_rows", p)
                       for p in POLICY_PARTITIONERS.values()),
        policy=MeasurePolicy(iters=4 if quick else 6, with_yax=False,
                             with_parallel=False, with_metrics=False))


def run(quick: bool = False, matrices=None, device=None):
    sp = spec(quick, matrices)
    rep = common.campaign_report(sp, device=device)
    rows = []
    summary = {p: [] for p in POLICIES}
    for name in sp.matrices:
        for pol in POLICIES:
            var = parallel_variant("1d_rows", POLICY_PARTITIONERS[pol])
            rec = rep.cell(name, "baseline", variant=var)
            rows.append([name, pol, round(rec["modelled_par_ms"], 3),
                         round(rec["gflops"], 4)])
            summary[pol].append(rec["gflops"])
    common.write_csv(common.result_path(CSV), HEADER, rows)
    geo = {p: profiles.geomean(np.maximum(v, 1e-9))
           for p, v in summary.items()}
    return {"geomean_gflops": geo,
            "default_static_wins": geo["static_default"] >= geo["static_c16"]}
