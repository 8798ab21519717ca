"""Analysis utilities for the paper's plots.

* performance_profile — Dolan & Moré profiles (paper Fig. 5)
* speedup_buckets     — stacked-bar bucket counts (Fig. 6)
* pairwise_win_rates  — win-rate matrix (Fig. 7)
* consistency_ratio   — Consistent% = 1 - |IS|/|CCS| (Fig. 8, Eq. 1)
* cdf                 — plain CDF points (Figs. 3, 4)

Everything takes a `perf` array indexed [scheme, matrix] (higher = better,
e.g. GFLOPs) or a `speedup` array [scheme, matrix] relative to baseline.
The port's own copy of the JAX package's numpy code.
"""
from __future__ import annotations

import numpy as np

BUCKETS = [0.0, 1.0, 1.1, 1.25, 1.5, 2.0, np.inf]
BUCKET_LABELS = ["<1", "1-1.1", "1.1-1.25", "1.25-1.5", "1.5-2", ">=2"]


def performance_profile(perf: np.ndarray, taus: np.ndarray) -> np.ndarray:
    """perf [S, M] -> profile [S, len(taus)]: fraction of matrices where
    scheme s is within tau of the best scheme for that matrix."""
    best = perf.max(axis=0, keepdims=True)          # [1, M]
    ratio = best / np.maximum(perf, 1e-30)          # >= 1, 1 = best
    return np.stack([(ratio <= t).mean(axis=1) for t in taus], axis=1)


def speedup_buckets(speedup: np.ndarray) -> np.ndarray:
    """speedup [S, M] -> counts [S, len(BUCKET_LABELS)]."""
    out = np.zeros((speedup.shape[0], len(BUCKET_LABELS)), dtype=np.int64)
    for s in range(speedup.shape[0]):
        out[s] = np.histogram(speedup[s], bins=BUCKETS)[0]
    return out


def pairwise_win_rates(perf: np.ndarray) -> np.ndarray:
    """perf [S, M] -> win[S, S]: fraction of matrices where row beats col."""
    s = perf.shape[0]
    win = np.zeros((s, s))
    for i in range(s):
        for j in range(s):
            if i != j:
                win[i, j] = float((perf[i] > perf[j]).mean())
    return win


def consistency_ratio(speedups_by_machine: np.ndarray, tau: float) -> tuple[float, int]:
    """speedups_by_machine [machines, M] for ONE scheme.

    CCS = matrices with speedup > tau on >= 1 machine;
    IS  = CCS members with slowdown (< 1) on >= 1 machine.
    Returns (Consistent%, |CCS|). (paper Eq. 1)"""
    ccs = (speedups_by_machine > tau).any(axis=0)
    is_ = ccs & (speedups_by_machine < 1.0).any(axis=0)
    n_ccs = int(ccs.sum())
    if n_ccs == 0:
        return 1.0, 0
    return 1.0 - is_.sum() / n_ccs, n_ccs


def cdf(values: np.ndarray):
    """Returns (sorted values, cumulative fraction)."""
    v = np.sort(np.asarray(values))
    return v, np.arange(1, v.size + 1) / v.size


def reverse_cdf(values: np.ndarray):
    v = np.sort(np.asarray(values))
    return v, 1.0 - np.arange(v.size) / v.size


def geomean(values: np.ndarray) -> float:
    v = np.asarray(values, dtype=np.float64)
    return float(np.exp(np.mean(np.log(np.maximum(v, 1e-30)))))


# --------------------------------------------------------------------------
# Plan-time vs run-time split (autotuned-engine accounting)
# --------------------------------------------------------------------------
def plan_run_split(records: dict, spmv_field: str = "seq_ios_ms",
                   iters_to_amortize: int = 100) -> dict:
    """Separate plan-time (reorder excluded; tune + format build) from
    SpMV run-time across campaign records.

    The paper's methodology point: preprocessing must be reported apart
    from SpMV time. Per cell the result carries plan_ms / run_ms /
    plan_over_run plus `amortized_ms` — run time with the one-off plan
    cost spread over `iters_to_amortize` SpMV calls (a CG-length solve).
    Cells served from the operator cache count plan time 0 (that is the
    cache's purpose).
    """
    out = {}
    for key, rec in records.items():
        if spmv_field not in rec:
            continue
        plan_ms = (0.0 if rec.get("op_cache_hit")
                   else rec.get("tune_ms", 0.0) + rec.get("format_build_ms", 0.0))
        run_ms = rec[spmv_field]
        out[key] = {
            "plan_ms": plan_ms,
            "run_ms": run_ms,
            "tuner_choice": rec.get("tuner_choice", rec.get("engine", "csr")),
            "op_cache_hit": bool(rec.get("op_cache_hit", False)),
            "plan_over_run": plan_ms / max(run_ms, 1e-9),
            "amortized_ms": run_ms + plan_ms / max(iters_to_amortize, 1),
        }
    return out
