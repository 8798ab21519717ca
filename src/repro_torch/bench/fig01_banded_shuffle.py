"""Paper Fig. 1: banded (1M x 1M, half-bw 15) vs randomly shuffled twin.

The paper reports 108 vs 32 GFLOP/s on a 64-core machine; here the same
structural contrast is measured on one card — the claim under
reproduction is the RATIO.

A timing-only spec (no YAX/CG/parallel/metrics: the 1M-row pair makes the
full protocol needlessly expensive) on the fixed csr engine.
"""
from __future__ import annotations

from ..experiments import ExperimentSpec, MeasurePolicy
from . import common

MATRICES = ("fig1_banded", "fig1_shuffled")
CSV = "fig01_banded_shuffle.csv"
HEADER = ["matrix", "m", "nnz", "ios_ms", "gflops"]


def spec(quick: bool = False) -> ExperimentSpec:
    return ExperimentSpec(
        name="fig1_pair", matrices=MATRICES, schemes=("baseline",),
        engines=("csr",),
        policy=MeasurePolicy(iters=6 if quick else 12, with_yax=False,
                             with_parallel=False, with_metrics=False))


def run(quick: bool = False, get_matrix=None, device=None):
    """get_matrix: the Runner's matrix source (default: the suite), so a
    caller holding the pair in memory does not generate it again."""
    rep = common.campaign_report(spec(quick), get_matrix=get_matrix,
                                 device=device)
    rows = []
    for name in MATRICES:
        rec = rep.cell(name, "baseline")
        rows.append([name, rec["m"], rec["nnz"],
                     round(rec["seq_ios_ms"], 3),
                     round(rec["seq_ios_gflops"], 4)])
    ratio = rows[0][4] / rows[1][4]
    rows.append(["ratio_banded_over_shuffled", "", "", "", round(ratio, 3)])
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return {"banded_gflops": rows[0][4], "shuffled_gflops": rows[1][4],
            "ratio": ratio}
