"""Corpus-scale campaign — the `representative: true` scale stamp.

    python -m repro_torch.bench.corpus_scale [--quick] [--device cpu]
    python -m repro_torch.bench.corpus_scale --smoke [--device cpu]

Two phases over real-corpus matrices (`corpus://` names resolved through
repro_torch.corpus — a local .mtx where one is present, else the
manifest-shaped synthetic stand-in; either way >= 100k rows, so the
summary's scale stamp is `representative: true`):

  1. seed    — probe=True: the empirical tuner measures its top
               candidates and each cell records the structural feature
               vector + the decision that won (the advisor's training
               pairs land in the result store as a side effect).
  2. learned — probe="learned": the TuneAdvisor nearest-neighbor
               shortlist replaces the model ranking, so the tuner times
               strictly fewer candidates per cell.

The learned phase writes BENCH_corpus_scale_torch.json and
corpus_scale.csv under common.results_dir(); `run` raises when the
summary's stamp is not representative.

--smoke is the network-free gate on the bundled fixtures: double ingest
(the second pass must be a 100% .csrz cache hit — zero parses), an
exhaustive-probe seed campaign, then the learned campaign, asserting the
advisor counters move, every learned cell probes STRICTLY fewer
candidates than its exhaustive twin, and the learned pick's exhaustively
probed time is within 5% of the exhaustive best (GFLOPs-equivalent).
Both measure on the card unless they are given device="cpu".
"""
from __future__ import annotations

import argparse
import json

from .. import obs
from ..experiments import ExperimentSpec, MeasurePolicy
from . import common

# both >= 100k rows (Report.REPRESENTATIVE_MIN_M) even as offline stand-ins
SCALE_MATRICES = ("corpus://delaunay_n17", "corpus://cage12")
SCALE_SCHEMES = ("baseline", "rcm")

# the 1k-row campaign fixtures: large enough that the empirical probe
# separates engines by structure, not dispatch noise (the 64-96 row parse
# fixtures time pure overhead, which makes a 5% quality gate meaningless)
SMOKE_MATRICES = ("corpus://fix_banded_1k", "corpus://fix_plaw_1k")
SMOKE_SCHEMES = ("baseline", "rcm")

SUMMARY_NAME = "BENCH_corpus_scale_torch.json"
CSV = "corpus_scale.csv"
HEADER = ["matrix", "scheme", "seed_probes", "learned_probes", "candidates",
          "advisor_confidence", "gflops"]
# the learned pick's time over the exhaustive best, at most
PICK_QUALITY = 1.05
ADVISOR_COUNTERS = ("advisor.hits", "advisor.misses", "advisor.fallbacks")


def _policy(probe, iters: int) -> MeasurePolicy:
    return MeasurePolicy(iters=iters, warmup=1, probe=probe,
                         with_yax=False, with_parallel=False,
                         with_metrics=False)


def seed_spec(quick: bool = False) -> ExperimentSpec:
    return ExperimentSpec(
        name="corpus_scale_seed", matrices=SCALE_MATRICES,
        schemes=SCALE_SCHEMES, engines=("auto",),
        policy=_policy(True, 4 if quick else 8))


def learned_spec(quick: bool = False) -> ExperimentSpec:
    return ExperimentSpec(
        name="corpus_scale", matrices=SCALE_MATRICES,
        schemes=SCALE_SCHEMES, engines=("auto",),
        policy=_policy("learned", 4 if quick else 8))


def _advisor_reset() -> None:
    # the advisor memoizes its mined knowledge base per store root; the
    # learned phase must see the cells the seed phase just wrote
    from ..corpus.advisor import advisor_reset

    advisor_reset()


def _probe_counts(rep) -> dict:
    return {(r["matrix"], r["scheme"]):
            (r.get("probed_candidates", 0), r.get("tuner_candidates", 0))
            for r in rep.records}


def _counters_moved(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in ADVISOR_COUNTERS}


def check_representative(summary: dict) -> None:
    """corpus_scale is the paper-scale campaign: raise unless its
    summary's scale stamp is representative."""
    if not summary["scale"]["representative"]:
        raise RuntimeError(
            f"corpus_scale is the paper-scale campaign but its stamp is "
            f"not representative (max_m={summary['scale']['max_m']})")


def run(quick: bool = False, device=None):
    """Full corpus-scale pass (offline). Returns the derived dict for the
    bench.run MODULES loop."""
    store = common.result_store()
    rep_seed = common.Runner(seed_spec(quick), store=store, verbose=False,
                             device=device).run()
    _advisor_reset()
    before = obs.snapshot()["counters"]
    rep = common.Runner(learned_spec(quick), store=store, verbose=False,
                        device=device).run()
    after = obs.snapshot()["counters"]

    summary = rep.write_bench_summary(common.result_path(SUMMARY_NAME))
    check_representative(summary)
    seed_probes = _probe_counts(rep_seed)
    learned_probes = _probe_counts(rep)
    rows = [[m, s, seed_probes[(m, s)][0], learned_probes[(m, s)][0],
             learned_probes[(m, s)][1],
             round(rep.cell(m, s).get("advisor_confidence", 0.0), 4),
             round(rep.cell(m, s).get("seq_ios_gflops", -1.0), 4)]
            for m in SCALE_MATRICES for s in SCALE_SCHEMES]
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return {
        "geomean": summary["geomean"],
        "speedup": summary.get("speedup_vs_baseline", {}),
        "representative": summary["scale"]["representative"],
        "max_m": summary["scale"]["max_m"],
        "advisor": {k.split(".", 1)[1]: v
                    for k, v in _counters_moved(before, after).items()},
    }


# --------------------------------------------------------------------------
# the smoke gate (network-free, fixtures only)
# --------------------------------------------------------------------------
def _ingest_fixtures() -> int:
    """Double-ingest the bundled fixtures; the second pass must resolve
    every matrix from its .csrz artifact (zero parses). Returns the
    failure count."""
    from ..corpus import manifest

    names = sorted(n for n, e in manifest.load_manifest().items()
                   if e.fixture)
    failures = 0
    for label in ("cold", "cached"):
        before = obs.snapshot()["counters"].get("corpus.parses", 0)
        for n in names:
            res = manifest.ensure(n)
            print(f"# ingest[{label}] corpus://{n}: "
                  f"{'hit' if res.cache_hit else 'parsed'} "
                  f"nnz={res.mat.nnz}", flush=True)
        parses = obs.snapshot()["counters"].get("corpus.parses", 0) - before
        if label == "cached" and parses:
            print(f"CACHE-HIT FAILED: re-ingest parsed {parses} matrices "
                  f"(want 0 — every fixture should load from .csrz)",
                  flush=True)
            failures += 1
    return failures


def exhaustive_probe_table(matrix: str, scheme: str, pol: dict,
                           device=None) -> dict:
    """The exhaustive campaign's candidate->measured-ms table for one
    cell, replayed through the plan store (no re-measurement)."""
    from ..core.spmv.plan import SpmvProblem, plan
    from ..matrices import suite

    hints = {"seed": pol["seed"]}
    if pol["use_kernel"] != "auto":
        hints["use_kernel"] = pol["use_kernel"]
    pl = plan(SpmvProblem(suite.get(matrix), k=1, dtype="float32",
                          hints=hints),
              reorder=scheme, engine="auto", probe="exhaustive",
              device=device)
    return dict(pl.tune.probe_ms or {})


def pick_ratio(table: dict, label: str) -> float:
    """The learned pick's time in the exhaustive table over the table's
    best; inf when the pick is not in the table."""
    best = min(table.values()) if table else 0.0
    return table[label] / best if label in table and best > 0 \
        else float("inf")


def smoke(device=None) -> int:
    """Fixture-scale acceptance gate. Returns the failure count."""
    failures = _ingest_fixtures()

    exhaustive = ExperimentSpec(
        name="corpus_smoke_seed", matrices=SMOKE_MATRICES,
        schemes=SMOKE_SCHEMES, engines=("auto",),
        policy=_policy("exhaustive", 3))
    learned = ExperimentSpec(
        name="corpus_smoke_learned", matrices=SMOKE_MATRICES,
        schemes=SMOKE_SCHEMES, engines=("auto",),
        policy=_policy("learned", 3))

    store = common.result_store()
    rep_ex = common.Runner(exhaustive, store=store, verbose=False,
                           on_error="record", device=device).run()
    failures += len(rep_ex.failures)
    for f in rep_ex.failures:
        print(f"EXHAUSTIVE FAIL {f['label']}: {f['error']}", flush=True)
    if failures:
        return failures

    _advisor_reset()
    before = obs.snapshot()["counters"]
    rep_ln = common.Runner(learned, store=store, verbose=False,
                           on_error="record", device=device).run()
    after = obs.snapshot()["counters"]
    failures += len(rep_ln.failures)
    for f in rep_ln.failures:
        print(f"LEARNED FAIL {f['label']}: {f['error']}", flush=True)
    if failures:
        return failures

    ex_probes = _probe_counts(rep_ex)
    pol = learned.policy.resolve("*")
    print("matrix,scheme,exhaustive_probes,learned_probes,confidence,"
          "pick_vs_best", flush=True)
    for m in SMOKE_MATRICES:
        for s in SMOKE_SCHEMES:
            rec = rep_ln.cell(m, s)
            n_ex = ex_probes[(m, s)][0]
            n_ln = rec.get("probed_candidates", 0)
            # the learned shortlist must time STRICTLY fewer candidates
            if not (0 < n_ln < n_ex):
                print(f"PROBE-COUNT FAILED [{m} {s}]: learned={n_ln} "
                      f"exhaustive={n_ex} (want 0 < learned < exhaustive)",
                      flush=True)
                failures += 1
            # the pick must be within 5% of the exhaustive best, judged
            # on the exhaustive run's own probe table (same measurement,
            # GFLOPs ~ 1/ms so a 1.05x ms bound is the 5%-GFLOPs bound)
            table = exhaustive_probe_table(m, s, pol, device)
            label = rec.get("plan_label", "?")
            ratio = pick_ratio(table, label)
            if ratio > PICK_QUALITY:
                print(f"PICK-QUALITY FAILED [{m} {s}]: learned pick "
                      f"{label} measured {ratio:.3f}x the exhaustive "
                      f"best (want <= {PICK_QUALITY})", flush=True)
                failures += 1
            print(f"{m},{s},{n_ex},{n_ln},"
                  f"{rec.get('advisor_confidence', 0.0):.3f},"
                  f"{ratio:.3f}", flush=True)

    moved = _counters_moved(before, after)
    print(f"# advisor counters: {moved}", flush=True)
    if moved["advisor.hits"] + moved["advisor.misses"] == 0:
        print("ADVISOR IDLE: no learned cell consulted the knowledge "
              "base (hits+misses == 0)", flush=True)
        failures += 1
    if not any(r.get("advisor_confidence", 0.0) > 0
               for r in rep_ln.records):
        print("ADVISOR UNCONFIDENT: every learned cell fell back to the "
              "model ranking", flush=True)
        failures += 1
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="network-free fixture gate")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    if args.smoke:
        raise SystemExit(1 if smoke(args.device) else 0)
    derived = run(quick=args.quick, device=args.device)
    print(json.dumps(derived, indent=1))


if __name__ == "__main__":
    main()
