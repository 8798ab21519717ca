"""Perf-regression gate over the port's bench summaries.

`compare(baseline, current)` diffs two bench summaries (the dicts
`Report.bench_summary()` emits) with noise-aware relative thresholds and
returns a verdict dict (the JAX package's rules, applied to the port's
summaries); `main()` is the CLI (`python -m repro_torch.experiments.regress
--baseline A.json --current B.json`). Exit codes:

    0 — comparable, no regression
    1 — comparable, at least one regression beyond tolerance
    2 — NOT comparable (scale stamps differ, missing/corrupt file) —
        cross-scale comparison is refused, never silently passed,
        because smoke-scale numbers (scale.representative == false) do
        not transfer to paper-scale matrices and vice versa.

What is gated (each against `rel_tol`, default 0.35 — smoke-scale runs
are noisy; a caller pins the threshold it wants):

* per-scheme geomean GFLOPs      — lower bound (throughput must not drop)
* per-scheme speedup_vs_baseline — lower bound
* plan_run.median_run_ms         — upper bound (run time must not grow)

Phase medians (reorder/tune/build/load) are reported informationally but
do NOT gate: plan-time is one-off, dominated by cold caches, and the
paper's methodology (§3) keeps it out of SpMV time.

``--portable`` gates only the machine-normalized speedup ratios — the
mode for comparing against a baseline taken on another machine, where
absolute GFLOPs do not transfer.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

DEFAULT_REL_TOL = 0.35

# scale-stamp fields that must match for two summaries to be comparable
_SCALE_KEYS = ("matrices", "max_m", "iters", "warmup", "use_kernel",
               "representative")


def _fmt(v) -> str:
    return f"{v:.4f}" if isinstance(v, float) else str(v)


def scale_mismatches(baseline: dict, current: dict) -> list:
    """Human-readable list of scale-stamp differences ([] = comparable).
    A summary with no scale stamp (pre-gate schema) is incomparable."""
    bs, cs = baseline.get("scale"), current.get("scale")
    if not isinstance(bs, dict) or not isinstance(cs, dict):
        missing = "baseline" if not isinstance(bs, dict) else "current"
        return [f"{missing} summary has no scale stamp "
                f"(re-run the bench to stamp it)"]
    out = []
    for k in _SCALE_KEYS:
        if bs.get(k) != cs.get(k):
            out.append(f"scale.{k}: baseline={bs.get(k)!r} "
                       f"current={cs.get(k)!r}")
    if baseline.get("field") != current.get("field"):
        out.append(f"field: baseline={baseline.get('field')!r} "
                   f"current={current.get('field')!r}")
    return out


def compare(baseline: dict, current: dict,
            rel_tol: float = DEFAULT_REL_TOL,
            portable: bool = False) -> dict:
    """Diff two bench summaries. Returns
    {comparable, scale_mismatch, checks, regressions, improvements,
    notes} — see module docstring for the gate set and exit semantics.

    portable=True gates only machine-normalized quantities (the
    speedup_vs_baseline ratios) and demotes the absolute ones (geomean
    GFLOPs, median_run_ms) to notes — the mode for comparing against a
    baseline taken on a DIFFERENT machine, where absolute throughput
    does not transfer. Same-machine gating (the default) checks
    everything."""
    mism = scale_mismatches(baseline, current)
    if mism:
        return {"comparable": False, "scale_mismatch": mism,
                "checks": 0, "regressions": [], "improvements": [],
                "notes": []}
    regressions, improvements, notes = [], [], []
    checks = 0

    def gate(name, base, cur, lower_bound, machine_bound=False):
        """lower_bound=True: cur must stay >= base*(1-tol); else cur must
        stay <= base*(1+tol). machine_bound metrics are demoted to notes
        under portable=True."""
        nonlocal checks
        if base is None or cur is None:
            return
        if portable and machine_bound:
            notes.append(f"{name}: baseline={_fmt(base)} "
                         f"current={_fmt(cur)} (machine-bound, not gated "
                         f"in --portable mode)")
            return
        checks += 1
        if lower_bound:
            limit = base * (1.0 - rel_tol)
            bad = cur < limit
            better = cur > base
        else:
            limit = base * (1.0 + rel_tol)
            bad = cur > limit
            better = cur < base
        line = (f"{name}: baseline={_fmt(base)} current={_fmt(cur)} "
                f"limit={_fmt(limit)} (rel_tol={rel_tol:g})")
        if bad:
            regressions.append(line)
        elif better:
            improvements.append(line)

    bg, cg = baseline.get("geomean", {}), current.get("geomean", {})
    for scheme in sorted(set(bg) & set(cg)):
        gate(f"geomean[{scheme}]", bg[scheme], cg[scheme],
             lower_bound=True, machine_bound=True)
    for scheme in sorted(set(bg) ^ set(cg)):
        notes.append(f"geomean[{scheme}] present in only one summary "
                     f"— not gated")
    bs = baseline.get("speedup_vs_baseline", {})
    cs = current.get("speedup_vs_baseline", {})
    for scheme in sorted(set(bs) & set(cs)):
        gate(f"speedup_vs_baseline[{scheme}]", bs[scheme], cs[scheme],
             lower_bound=True)
    bp = baseline.get("plan_run", {}) or {}
    cp = current.get("plan_run", {}) or {}
    gate("plan_run.median_run_ms", bp.get("median_run_ms"),
         cp.get("median_run_ms"), lower_bound=False, machine_bound=True)
    bph, cph = baseline.get("phases", {}) or {}, current.get("phases", {}) or {}
    for k in sorted(set(bph) & set(cph)):
        notes.append(f"phases.{k}: baseline={_fmt(bph[k])} "
                     f"current={_fmt(cph[k])} (informational, not gated)")
    return {"comparable": True, "scale_mismatch": [], "checks": checks,
            "regressions": regressions, "improvements": improvements,
            "notes": notes}


def load_summary(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Gate a bench summary of the port against a baseline "
                    "summary (exit 0 pass / 1 regression / 2 incomparable)")
    ap.add_argument("--baseline", required=True,
                    help="committed baseline summary JSON")
    ap.add_argument("--current", required=True,
                    help="freshly produced summary JSON")
    ap.add_argument("--rel-tol", type=float, default=DEFAULT_REL_TOL,
                    help=f"relative noise tolerance "
                         f"(default {DEFAULT_REL_TOL})")
    ap.add_argument("--portable", action="store_true",
                    help="gate only machine-normalized ratios (speedups); "
                         "use when the baseline was committed from a "
                         "different machine")
    args = ap.parse_args(argv)
    base = load_summary(args.baseline)
    cur = load_summary(args.current)
    if base is None or cur is None:
        which = args.baseline if base is None else args.current
        print(f"REGRESS INCOMPARABLE: cannot read summary {which!r}")
        return 2
    res = compare(base, cur, rel_tol=args.rel_tol, portable=args.portable)
    for line in res["notes"]:
        print(f"  note: {line}")
    for line in res["improvements"]:
        print(f"  improvement: {line}")
    if not res["comparable"]:
        print("REGRESS INCOMPARABLE: scale stamps differ — refusing the "
              "cross-scale comparison:")
        for line in res["scale_mismatch"]:
            print(f"  {line}")
        return 2
    if res["regressions"]:
        print(f"REGRESS FAIL: {len(res['regressions'])} regression(s) "
              f"beyond tolerance:")
        for line in res["regressions"]:
            print(f"  {line}")
        return 1
    print(f"REGRESS OK: {res['checks']} checks within rel_tol="
          f"{args.rel_tol:g} ({len(res['improvements'])} improved)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
