"""The port's benchmark orchestrator — one module per paper table/figure.

    python -m repro_torch.bench.run [--quick] [--only fig03_ios_yax,...]
        [--matrices a,b] [--device cpu]
    python -m repro_torch.bench.run --smoke [--matrices a,b] [--device cpu]
    python -m repro_torch.bench.run --smoke-parallel [--devices 8]

Every run measures on the card unless it is given `--device cpu`.
`--matrices` restricts the smoke grids, and the figures that read a
matrix tier (their `matrices=`).

--smoke runs a tiny measurement CAMPAIGN (smoke-tier matrices x
{baseline, rcm} with the autotuned engine) through the experiment
harness: reorder -> tune (probe on) -> build -> plan store -> IOS timing
with a per-cell original-index-space oracle gate (verify on). It then
re-runs the identical spec and asserts 100% result-store hits (the
resumability invariant), writes the campaign CSV and the port's summary
(BENCH_spmv_torch.json) under common.results_dir(). --smoke-parallel
does the same over the "parallel" cell kind (topology-aware plans over
--devices devices, simulated on one card). Exit status is nonzero on any
failure.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import time
import traceback

from . import common
from ..experiments.report import SUMMARY_NAME

MODULES = [
    "fig01_banded_shuffle",
    "fig03_ios_yax",
    "fig04_scheduling",
    "fig05_profiles",
    "fig06_speedup_stacks",
    "fig07_pairwise",
    "fig08_consistency",
    "fig09_10_load_imbalance",
    "fig11_nnz_balanced",
    "table1_rcm_vs_metis",
    "bell_formats",
    "spmm_batch",
]
# the JAX package's drivers that have no counterpart here yet
NOT_PORTED = ("moe_dispatch", "roofline", "corpus_scale", "workloads")

SMOKE_CSV = "smoke_campaign.csv"
SMOKE_HEADER = ["matrix", "scheme", "engine", "plan_label", "seq_ios_ms",
                "seq_ios_gflops", "verify_rel_err"]
SMOKE_PARALLEL_CSV = "smoke_parallel_campaign.csv"
SMOKE_PARALLEL_HEADER = ["matrix", "scheme", "layout", "partitioner",
                         "engine", "comm_schedule", "comm_bytes_per_spmv",
                         "li", "modelled_par_ms", "verify_rel_err"]


def smoke_spec(matrices=None):
    from ..experiments import ExperimentSpec, MeasurePolicy
    from ..matrices import suite

    return ExperimentSpec(
        name="smoke", matrices=tuple(matrices or suite.smoke_names()),
        schemes=("baseline", "rcm"), engines=("auto",),
        # verify gates every cell on the numpy oracle in the ORIGINAL
        # index space (this also exercises the operator's carried
        # permutation); probe exercises the empirical tuner path
        policy=MeasurePolicy(iters=3, warmup=1, with_yax=False,
                             with_parallel=False, with_metrics=False,
                             verify=True, probe=True))


def _resume(spec, store, device, failures: int) -> tuple:
    """The resumability invariant: an identical second invocation is
    served ENTIRELY from the result store. Returns (report, failures)."""
    rep2 = common.Runner(spec, store=store, verbose=False,
                         device=device).run()
    ncells = len(rep2.records)
    if rep2.measured != 0 or rep2.reused != ncells:
        print(f"RESUME FAILED: second run measured={rep2.measured} "
              f"reused={rep2.reused} (want 0/{ncells})", flush=True)
        return rep2, failures + 1
    print(f"# resume: {rep2.reused}/{ncells} cells served from the store "
          f"(0 re-measured)", flush=True)
    return rep2, failures


def _report_failures(rep) -> int:
    for f in rep.failures:
        print(f"{f['label']},0,\"ERROR: {f['error']}\"", flush=True)
        print(f["traceback"], flush=True)
    return len(rep.failures)


def smoke(matrices=None, device=None) -> int:
    """Tiny end-to-end campaign + resumability check.
    Returns failure count."""
    spec = smoke_spec(matrices)
    store = common.result_store()
    rep = common.Runner(spec, store=store, verbose=False, on_error="record",
                        device=device).run()
    print("name,us_per_call,derived")
    for rec in rep.records:
        derived = {"engine": rec.get("engine", "?"),
                   "ms": round(rec.get("seq_ios_ms", float("nan")), 3),
                   "store": "hit" if rec["store_reused"] else "miss+measure",
                   "verify_rel_err": round(rec.get("verify_rel_err", -1.0),
                                           8)}
        print(f"{rec['matrix']}_{rec['scheme']},"
              f"{rec['runner_wall_s'] * 1e6:.0f},"
              f"\"{json.dumps(derived)}\"", flush=True)
    failures = _report_failures(rep)
    if not failures:
        rep, failures = _resume(spec, store, device, failures)

    rows = [[r["matrix"], r["scheme"], r.get("engine", "?"),
             r.get("plan_label", "?"), round(r.get("seq_ios_ms", -1), 4),
             round(r.get("seq_ios_gflops", -1), 4),
             round(r.get("verify_rel_err", -1), 8)] for r in rep.records]
    common.write_csv(common.result_path(SMOKE_CSV), SMOKE_HEADER, rows)
    summary = rep.write_bench_summary()
    print(f"# {SUMMARY_NAME}: geomean={summary['geomean']} "
          f"speedup={summary.get('speedup_vs_baseline', {})}", flush=True)
    return failures


def smoke_parallel_spec(matrices=None, devices: int = 8):
    from ..experiments import ExperimentSpec, MeasurePolicy
    from ..experiments.cells import parallel_variant

    if devices < 2:
        raise SystemExit(f"--smoke-parallel needs --devices >= 2, "
                         f"got {devices}")
    return ExperimentSpec(
        name="smoke_parallel",
        matrices=tuple(matrices or ("smoke_banded", "smoke_powerlaw")),
        schemes=("baseline", "rcm"), engines=("auto",), ps=(devices,),
        kind="parallel",
        variants=(parallel_variant("1d_rows", "nnz_balanced"),
                  parallel_variant("2d_panels", "nnz_balanced")),
        # verify gates every cell on the ShardedOperator's original-
        # index-space oracle
        policy=MeasurePolicy(iters=3, warmup=1, verify=True,
                             with_yax=False, with_parallel=False,
                             with_metrics=False))


def smoke_parallel(matrices=None, devices: int = 8, device=None) -> int:
    """Distributed-smoke campaign + resumability check.
    Returns failure count."""
    spec = smoke_parallel_spec(matrices, devices)
    store = common.result_store()
    rep = common.Runner(spec, store=store, verbose=False, on_error="record",
                        device=device).run()
    print("name,us_per_call,derived")
    for rec in rep.records:
        derived = {"layout": rec["layout"], "engine": rec.get("engine", "?"),
                   "sched": rec.get("comm_schedule", "?"),
                   "comm_B": rec.get("comm_bytes_per_spmv"),
                   "par_ms": round(rec.get("modelled_par_ms",
                                           float("nan")), 3),
                   "sim": rec.get("simulated"),
                   "store": "hit" if rec["store_reused"] else "miss+measure",
                   "verify_rel_err": round(rec.get("verify_rel_err", -1.0),
                                           8)}
        print(f"{rec['matrix']}_{rec['scheme']}_{rec['layout']}"
              f"_{rec['partitioner']},"
              f"{rec['runner_wall_s'] * 1e6:.0f},"
              f"\"{json.dumps(derived)}\"", flush=True)
    failures = _report_failures(rep)
    if not failures:
        rep, failures = _resume(spec, store, device, failures)

    rows = [[r["matrix"], r["scheme"], r["layout"], r["partitioner"],
             r.get("engine", "?"), r.get("comm_schedule", "?"),
             r.get("comm_bytes_per_spmv", -1),
             round(r.get("li", -1.0), 4),
             round(r.get("modelled_par_ms", -1.0), 4),
             round(r.get("verify_rel_err", -1.0), 8)]
            for r in rep.records]
    common.write_csv(common.result_path(SMOKE_PARALLEL_CSV),
                     SMOKE_PARALLEL_HEADER, rows)
    return failures


def run_module(name: str, quick: bool = False, matrices=None, device=None):
    """One driver's run(): `matrices` goes to the drivers that read a
    matrix tier."""
    mod = importlib.import_module(f"{__package__}.{name}")
    kw = {"quick": quick, "device": device}
    if matrices and "matrices" in inspect.signature(mod.run).parameters:
        kw["matrices"] = matrices
    return mod.run(**kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--smoke-parallel", action="store_true",
                    help="distributed-smoke campaign over the 'parallel' "
                         "cell kind (topology-aware plans)")
    ap.add_argument("--devices", type=int, default=8,
                    help="device count for --smoke-parallel")
    ap.add_argument("--matrices", default="",
                    help="comma-separated matrix names (restricts --smoke, "
                         "--smoke-parallel and the tier-reading figures)")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    mats = [m for m in args.matrices.split(",") if m] or None
    only = set(args.only.split(",")) if args.only else None
    if only:
        unknown = only - set(MODULES)
        if unknown:
            ap.error(f"--only: {sorted(unknown)} "
                     + ("not ported yet" if unknown <= set(NOT_PORTED)
                        else f"unknown; choose from {MODULES}"))

    if args.smoke_parallel:
        raise SystemExit(1 if smoke_parallel(mats, args.devices, args.device)
                         else 0)
    if args.smoke:
        raise SystemExit(1 if smoke(mats, args.device) else 0)

    print("name,us_per_call,derived")
    failures = 0
    for name in MODULES:
        if only and name not in only:
            continue
        t0 = time.time()
        try:
            derived = run_module(name, args.quick, mats, args.device)
            us = (time.time() - t0) * 1e6
            print(f"{name},{us:.0f},\"{json.dumps(derived, default=str)}\"",
                  flush=True)
        except Exception as e:
            failures += 1
            us = (time.time() - t0) * 1e6
            print(f"{name},{us:.0f},\"ERROR: {type(e).__name__}: {e}\"",
                  flush=True)
            traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
