"""Summarize the paper-claim verdicts from the measured campaigns.

Run after `python -m repro_torch.bench.run` — a pure view over the
locality campaign's cells in the result store. It measures nothing: a
missing cell raises instead of starting the campaign.

    python -m repro_torch.bench.summarize_repro [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..device import device_kind, resolve_device
from . import common


def run(quick: bool = False, matrices=None, device=None):
    out = {}
    mats = common.locality_names(matrices)
    # summarize is a VIEW: fail fast if the campaign was never measured
    # instead of silently launching hours of measurement with no output
    dev = resolve_device(device)
    spec = common.locality_spec(matrices=mats)
    store = common.result_store()
    cells = spec.cells(device=device_kind(dev))
    missing = [c for c in cells if store.get(c.key()) is None]
    if missing:
        raise RuntimeError(
            f"locality campaign incomplete: {len(missing)} of "
            f"{len(cells)} cells missing from {store.root} — run "
            f"`python -m repro_torch.bench.run` first (e.g. "
            f"{missing[0].label()})")
    rep = common.campaign_report(spec, verbose=False, device=dev)
    S = common.SCHEMES
    perf = rep.grid("seq_ios_gflops", mats, S)
    yax = rep.grid("seq_yax_gflops", mats, S)
    cg = rep.grid("cg_gflops", mats, S)
    par = rep.grid("par_static_gflops", mats, S)
    base = perf[S.index("baseline")]

    # claim 5: sequential slowdown fraction per scheme
    for s in S:
        if s == "baseline":
            continue
        sp = perf[S.index(s)] / base
        out[f"seq_slowdown_frac_{s}"] = round(float((sp < 1.0).mean()), 3)
        out[f"seq_median_speedup_{s}"] = round(float(np.median(sp)), 3)

    # claim 4: pairwise rcm vs others (sequential)
    r = S.index("rcm")
    for s in S:
        if s in ("rcm",):
            continue
        w = float((perf[r] > perf[S.index(s)]).mean())
        out[f"seq_rcm_beats_{s}"] = round(w, 3)

    # claim 2: methodology ratios
    out["yax_over_cg_median"] = round(float(np.median(yax / cg)), 3)
    out["ios_over_cg_median"] = round(float(np.median(perf / cg)), 3)

    # claim 9 / table 1
    for nm, g in [("IOS", perf), ("CG", cg), ("YAX", yax)]:
        w = int((g[r] > g[S.index("metis")]).sum())
        l = int((g[r] < g[S.index("metis")]).sum())
        out[f"t1_{nm}"] = f"rcm {w}w/{l}l"

    # parallel (modelled): rcm vs metis magnitude story
    pbase = par[S.index("baseline")]
    for s in ("rcm", "metis"):
        sp = par[S.index(s)] / pbase
        out[f"par_wins_{s}"] = round(float((sp > 1.0).mean()), 3)
        out[f"par_maxspeedup_{s}"] = round(float(sp.max()), 3)

    # plan-time vs run-time amortization (paper §3 accounting): medians
    # over the campaign's cells at the spec's amortize_iters
    split = rep.plan_run_split()
    if split:
        vals = list(split.values())
        out["median_plan_over_run"] = round(float(np.median(
            [v["plan_over_run"] for v in vals])), 3)
        out["median_amortized_ms"] = round(float(np.median(
            [v["amortized_ms"] for v in vals])), 3)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrices", default="",
                    help="comma-separated matrix names (default: the "
                         "locality tier)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    mats = [m for m in args.matrices.split(",") if m] or None
    print(json.dumps(run(matrices=mats, device=args.device), indent=1))


if __name__ == "__main__":
    main()
