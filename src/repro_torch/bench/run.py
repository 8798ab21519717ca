"""The port's benchmark orchestrator — one module per paper table/figure.

    python -m repro_torch.bench.run [--quick] [--only fig03_ios_yax,...]
        [--matrices a,b] [--device cpu] [--trace PATH]
    python -m repro_torch.bench.run --smoke [--matrices a,b] [--device cpu]
    python -m repro_torch.bench.run --smoke-parallel [--devices 8]
    python -m repro_torch.bench.run --smoke-serve [--device cpu]
    python -m repro_torch.bench.run --smoke-route [--devices 8]
    python -m repro_torch.bench.run --smoke-workloads [--device cpu]
    python -m repro_torch.bench.run --only roofline   # dry-run records

Every run measures on the card unless it is given `--device cpu`.
`--matrices` restricts the smoke grids, and the figures that read a
matrix tier (their `matrices=`). `--trace PATH` records the run's spans
(repro_torch.obs): .jsonl -> the raw events, else Chrome-trace JSON.

--smoke runs a tiny measurement CAMPAIGN (smoke-tier matrices x
{baseline, rcm} with the autotuned engine) through the experiment
harness: reorder -> tune (probe on) -> build -> plan store -> IOS timing
with a per-cell original-index-space oracle gate (verify on). It then
re-runs the identical spec and asserts 100% result-store hits (the
resumability invariant), writes the campaign CSV and the port's summary
(BENCH_spmv_torch.json) under common.results_dir(). --smoke-parallel
does the same over the "parallel" cell kind (topology-aware plans over
--devices devices, simulated on one card).

--smoke-serve is the overload soak over the "serve" cell kind (reject,
shed-oldest and bursty degrade-to-k1 past a 0.02 MB budget), each record
held to serve_invariants and the campaign to overload, LRU churn and
value swaps without replans; it writes smoke_serve_campaign.csv and
serve_slo.json. --smoke-route is the router soak over the "route" kind
(2 meshes of max(2, min(4, devices // 2)) devices), each record held to
route_invariants, then the sibling p99 check and apply_delta against a
full replan; it writes smoke_route_campaign.csv and route_smoke.json.
--smoke-workloads is workloads.smoke (the MoE, attention and GNN streams
under the amortization invariants). Each smoke ends with the resume, and
the exit status is nonzero on any failure.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import time
import traceback

import numpy as np

from . import common, workloads
from .. import obs
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
    "moe_dispatch",
    "spmm_batch",
    "corpus_scale",
    "workloads",
]
# drivers that run only when --only names them: the roofline reads the
# dry-run's records (launch.dryrun), which no figure run writes
ON_REQUEST = ("roofline",)

SMOKE_CSV = "smoke_campaign.csv"
SMOKE_HEADER = ["matrix", "scheme", "engine", "plan_label", "seq_ios_ms",
                "seq_ios_gflops", "verify_rel_err"]
SMOKE_PARALLEL_CSV = "smoke_parallel_campaign.csv"
SMOKE_PARALLEL_HEADER = ["matrix", "scheme", "layout", "partitioner",
                         "engine", "comm_schedule", "comm_bytes_per_spmv",
                         "li", "modelled_par_ms", "verify_rel_err"]
SMOKE_SERVE_CSV = "smoke_serve_campaign.csv"
SMOKE_SERVE_HEADER = ["matrix", "variant", "ok", "shed", "rejected",
                      "errors", "unresolved", "p50_ms", "p99_ms",
                      "coalesce_ratio", "evictions", "op_reloads",
                      "value_swaps", "resident_bytes_max"]
SERVE_SLO_NAME = "serve_slo.json"
SMOKE_ROUTE_CSV = "smoke_route_campaign.csv"
SMOKE_ROUTE_HEADER = ["matrix", "variant", "placement", "ok", "unresolved",
                      "structure_updates", "replans_landed", "value_swaps",
                      "per_device_ok", "assignments"]
ROUTE_SUMMARY_NAME = "route_smoke.json"


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


def _write_summary(name: str, failures: int, ncells: int, records) -> None:
    """The soak's summary JSON (the reference's CI artifact) under
    common.results_dir()."""
    path = common.result_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"failures": failures, "cells": ncells,
                   "records": records}, f, indent=1, default=str)
    print(f"# {name} -> {path}", flush=True)


# -- --smoke-serve: the overload soak ---------------------------------------
def smoke_serve_spec(matrices=None):
    from ..experiments import ExperimentSpec, MeasurePolicy
    from ..experiments.cells import serve_variant

    # three overload scenarios, all rate >> capacity with Zipf-skewed
    # keys and an operator footprint past the memory budget: one per
    # shedding policy, the degrade one with a value-update mix on bursty
    # arrivals
    variants = (
        serve_variant(rate_rps=4000, requests=160, n_keys=5, zipf_s=1.1,
                      budget_mb=0.02, max_queue=8, window_ms=1.0,
                      overload="reject"),
        serve_variant(rate_rps=4000, requests=160, n_keys=5, zipf_s=1.1,
                      budget_mb=0.02, max_queue=8, window_ms=1.0,
                      overload="shed-oldest"),
        serve_variant(arrival="bursty", rate_rps=2000, requests=120,
                      n_keys=3, update_frac=0.25, budget_mb=0.02,
                      max_queue=16, window_ms=1.0,
                      overload="degrade-to-k1"),
    )
    return ExperimentSpec(
        name="smoke_serve", matrices=tuple(matrices or ("smoke_banded",)),
        schemes=("baseline",), engines=("auto",), ks=(8,), kind="serve",
        variants=variants,
        policy=MeasurePolicy(iters=1, warmup=0, with_yax=False,
                             with_parallel=False, with_metrics=False))


def serve_invariants(rec) -> list:
    """What a "serve" record breaks of the hardened service's invariants
    (the reference's per-cell soak checks); empty when it holds them
    all."""
    bad = []
    if rec["unresolved"]:
        bad.append(f"unresolved={rec['unresolved']} futures")
    if not rec["budget_ok"]:
        bad.append(f"resident_bytes_max={rec['resident_bytes_max']} "
                   f"exceeded budget={rec['memory_budget_bytes']}")
    if not rec["counters_balanced"]:
        bad.append("stats counters do not balance")
    if rec["errors"]:
        bad.append(f"{rec['errors']} non-typed request errors")
    if (rec["rejected"] or rec["shed"]) and not rec["retry_after_positive"]:
        bad.append("overload error without positive retry_after_ms")
    return bad


def serve_campaign_faults(records) -> list:
    """The campaign-level soak checks: the scenarios must overload
    (shed or reject), churn the LRU (evict and reload from the plan
    store) and swap values without replanning."""
    tot = {k: sum(r[k] for r in records)
           for k in ("shed", "rejected", "evictions", "op_reloads",
                     "value_swaps", "updates", "replans")}
    bad = []
    if tot["shed"] + tot["rejected"] == 0:
        bad.append("SOAK UNDERLOADED: no request was shed or rejected — "
                   "the scenarios no longer exceed capacity")
    if tot["evictions"] == 0 or tot["op_reloads"] == 0:
        bad.append(f"SOAK LRU NOT EXERCISED: evictions={tot['evictions']} "
                   f"plan-store reloads={tot['op_reloads']}")
    if tot["updates"] and (tot["value_swaps"] == 0 or tot["replans"]):
        bad.append(f"SOAK VALUE-SWAP FAILED: updates={tot['updates']} "
                   f"swaps={tot['value_swaps']} replans={tot['replans']} "
                   f"(updates must swap values without replanning)")
    return bad


def smoke_serve(matrices=None, device=None) -> int:
    """Traffic-sim soak campaign: the three overload scenarios of
    smoke_serve_spec through the "serve" cell kind, each record held to
    serve_invariants and the campaign to serve_campaign_faults; then the
    resume. Writes smoke_serve_campaign.csv and serve_slo.json. Returns
    the failure count."""
    spec = smoke_serve_spec(matrices)
    store = common.result_store()
    rep = common.Runner(spec, store=store, verbose=False, on_error="record",
                        device=device).run()
    print("name,us_per_call,derived")
    failures = _report_failures(rep)
    for rec in rep.records:
        derived = {"variant": rec["variant"],
                   "ok": rec["ok"], "shed": rec["shed"],
                   "rejected": rec["rejected"], "errors": rec["errors"],
                   "unresolved": rec["unresolved"],
                   "p99_ms": round(rec["p99_ms"], 2),
                   "coalesce": round(rec["coalesce_ratio"], 2),
                   "evictions": rec["evictions"],
                   "reloads": rec["op_reloads"],
                   "swaps": rec["value_swaps"],
                   "launches": rec["launches"],
                   "store": "hit" if rec["store_reused"] else "miss+measure"}
        print(f"{rec['matrix']}_{rec['variant']},"
              f"{rec['runner_wall_s'] * 1e6:.0f},"
              f"\"{json.dumps(derived)}\"", flush=True)
        bad = serve_invariants(rec)
        if bad:
            failures += 1
            print(f"SOAK INVARIANT FAILED [{rec['variant']}]: "
                  f"{'; '.join(bad)}", flush=True)
    if rep.records and not failures:
        for line in serve_campaign_faults(rep.records):
            failures += 1
            print(line, flush=True)
    if not failures:
        _, failures = _resume(spec, store, device, failures)

    rows = [[r["matrix"], r["variant"], r["ok"], r["shed"], r["rejected"],
             r["errors"], r["unresolved"],
             round(r["p50_ms"], 3), round(r["p99_ms"], 3),
             round(r["coalesce_ratio"], 3), r["evictions"],
             r["op_reloads"], r["value_swaps"], r["resident_bytes_max"]]
            for r in rep.records]
    common.write_csv(common.result_path(SMOKE_SERVE_CSV), SMOKE_SERVE_HEADER,
                     rows)
    _write_summary(SERVE_SLO_NAME, failures, len(spec.cells()), rep.records)
    return failures


# -- --smoke-route: the router soak -----------------------------------------
def route_mesh_devices(devices: int) -> int:
    """Devices a mesh of the route soak: two meshes share `devices`,
    between 2 and 4 each."""
    return max(2, min(4, devices // 2))


def smoke_route_spec(matrices=None, devices: int = 8):
    """Two fleet scenarios of 2 meshes of route_mesh_devices(devices):
    a budgeted bin_pack fleet with a value-swap and structure-delta mix
    (the mid-soak shard replan shape), and a comm_aware fleet."""
    from ..experiments import ExperimentSpec, MeasurePolicy
    from ..experiments.cells import route_variant

    d = route_mesh_devices(devices)
    variants = (
        route_variant(rate_rps=600, requests=120, n_keys=4,
                      update_frac=0.1, structure_frac=0.08,
                      devices=d, meshes=2, policy="bin_pack",
                      budget_mb=4.0, window_ms=1.0),
        route_variant(rate_rps=600, requests=80, n_keys=3,
                      structure_frac=0.05, devices=d, meshes=2,
                      policy="comm_aware", window_ms=1.0),
    )
    return ExperimentSpec(
        name="smoke_route", matrices=tuple(matrices or ("smoke_banded",)),
        schemes=("baseline",), engines=("auto",), ks=(4,), kind="route",
        variants=variants,
        policy=MeasurePolicy(iters=1, warmup=0, with_yax=False,
                             with_parallel=False, with_metrics=False))


def route_invariants(rec) -> list:
    """What a "route" record breaks of the router's invariants (the
    reference's per-cell route soak checks); empty when it holds them
    all."""
    bad = []
    if rec["unresolved"] or rec["replan_unresolved"]:
        bad.append(f"unresolved futures: requests={rec['unresolved']} "
                   f"replans={rec['replan_unresolved']}")
    if rec["errors"] or rec["replan_errors"]:
        bad.append(f"errors: requests={rec['errors']} "
                   f"replans={rec['replan_errors']}")
    if not rec["per_device_ok"] or not rec["budget_ok"]:
        bad.append(f"per-device budget violated (per_device_ok="
                   f"{rec['per_device_ok']} budget_ok={rec['budget_ok']})")
    if not rec["counters_balanced"]:
        bad.append("stats counters do not balance")
    if rec["structure_updates"] \
            and rec["replans_landed"] != rec["structure_updates"]:
        bad.append(f"{rec['structure_updates']} structure updates but "
                   f"{rec['replans_landed']} replans landed")
    if rec["placement"] != "bin_pack" \
            and len(set(rec["assignments"].values())) < 2:
        # bin_pack is best-fit and legitimately packs one mesh; the
        # load-spreading policies must actually spread
        bad.append(f"placement degenerate: all keys on one mesh "
                   f"({rec['assignments']})")
    return bad


def p99(samples) -> float:
    """The sibling check's percentile (index int(0.99 n))."""
    s = sorted(samples)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def sibling_p99_flat(p_base: float, p_during: float) -> bool:
    """The non-stalling criterion: a sibling gated on a replan fails
    catastrophically, so p99 during the replan <= 5 x baseline + 50 ms
    separates broken from noisy."""
    return p_during <= 5.0 * p_base + 50.0


def route_delta_vs_replan() -> int:
    """Plan.apply_delta must be measurably cheaper than a full replan of
    the edited matrix, pinned by the delta.applies counter. Returns the
    failure count."""
    from ..core.spmv.delta import StructureDelta
    from ..core.spmv.plan import SpmvProblem, plan
    from ..matrices import generators as G

    mat = G.banded(4096, 24, seed=0)
    pl = plan(SpmvProblem(mat), reorder="rcm", cache=False)
    rows = np.repeat(np.arange(mat.shape[0], dtype=np.int64),
                     np.diff(mat.rowptr.astype(np.int64)))
    pick = np.arange(0, mat.nnz, max(mat.nnz // 64, 1))[:64]
    delta = StructureDelta(del_rows=rows[pick],
                           del_cols=mat.cols.astype(np.int64)[pick])
    applies0 = obs.counter("delta.applies").value
    t0 = time.perf_counter()
    pl2 = pl.apply_delta(delta)
    delta_ms = (time.perf_counter() - t0) * 1e3
    applies1 = obs.counter("delta.applies").value
    new_mat = delta.apply_to(mat)
    t0 = time.perf_counter()
    pl3 = plan(SpmvProblem(new_mat), reorder="rcm", cache=False)
    replan_ms = (time.perf_counter() - t0) * 1e3
    fails = 0
    if applies1 != applies0 + 1:
        fails += 1
        print(f"DELTA COUNTER FAILED: delta.applies moved "
              f"{applies1 - applies0}, want 1", flush=True)
    if pl2.key == pl.key or tuple(pl2.mat_shape) != tuple(new_mat.shape) \
            or pl2.mat_nnz != new_mat.nnz:
        fails += 1
        print("DELTA PLAN FAILED: apply_delta did not re-key the plan "
              "onto the edited structure", flush=True)
    if delta_ms >= replan_ms:
        fails += 1
        print(f"DELTA NOT CHEAPER: apply_delta {delta_ms:.2f} ms >= "
              f"full replan {replan_ms:.2f} ms", flush=True)
    print(f"# delta-vs-replan: apply_delta {delta_ms:.2f} ms vs "
          f"plan() {replan_ms:.2f} ms ({replan_ms / max(delta_ms, 1e-9):.1f}x"
          f"); replanned scheme={pl3.scheme}", flush=True)
    return fails


def route_sibling_p99(devices: int = 8, device=None) -> int:
    """Soak one mesh with two keys; trigger a background shard replan on
    one and hold the SIBLING key's p99 to sibling_p99_flat (the
    non-stalling replan pillar). Returns the failure count."""
    from ..core.spmv.topology import Topology
    from ..matrices import generators as G
    from ..router import MeshSpec, RoutedSpmvService
    from ..serving.traffic import _deletion_delta

    mesh = MeshSpec("m0", Topology(devices=route_mesh_devices(devices)))
    sib_mat = G.banded(1024, 16, seed=1)
    hot_mat = G.banded(2048, 32, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(sib_mat.shape[1])

    def lat_run(svc, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            svc.submit("sib", x).result(timeout=60)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    fails = 0
    with RoutedSpmvService([mesh], max_batch=4, window_ms=0.5,
                           device=device) as rt:
        rt.register("sib", sib_mat, mesh="m0")
        rt.register("hot", hot_mat, mesh="m0")
        rt.operator("sib")
        rt.operator("hot")
        base = lat_run(rt, 40)
        fut = rt.update_structure(
            "hot", delta=_deletion_delta(hot_mat, rng, frac=0.01))
        during = lat_run(rt, 40)          # sibling serves while replanning
        fut.result(timeout=120)
        st = rt.stats()
        if st["replans"] != 1 or st["replan_errors"]:
            fails += 1
            print(f"SIBLING REPLAN FAILED: replans={st['replans']} "
                  f"errors={st['replan_errors']} (want exactly 1 clean "
                  f"background replan)", flush=True)
        p_base, p_during = p99(base), p99(during)
        if not sibling_p99_flat(p_base, p_during):
            fails += 1
            print(f"SIBLING P99 NOT FLAT: {p_during:.2f} ms during replan "
                  f"vs {p_base:.2f} ms baseline", flush=True)
        print(f"# sibling p99: {p_base:.2f} ms baseline -> "
              f"{p_during:.2f} ms during background replan", flush=True)
    return fails


def smoke_route(matrices=None, devices: int = 8, device=None) -> int:
    """Multi-shard router soak: the route cells of smoke_route_spec
    through the Runner, each record held to route_invariants; then the
    sibling p99 check, apply_delta against a full replan and the resume.
    Writes smoke_route_campaign.csv and route_smoke.json. Returns the
    failure count."""
    spec = smoke_route_spec(matrices, devices)
    store = common.result_store()
    runner = common.Runner(spec, store=store, verbose=False,
                           on_error="record", device=device)
    rep = runner.run()
    print("name,us_per_call,derived")
    failures = _report_failures(rep)
    for rec in rep.records:
        derived = {"variant": rec["variant"], "ok": rec["ok"],
                   "unresolved": rec["unresolved"],
                   "replans_landed": rec["replans_landed"],
                   "replan_unresolved": rec["replan_unresolved"],
                   "per_device_ok": rec["per_device_ok"],
                   "placement": rec["placement"],
                   "assignments": rec["assignments"],
                   "launches": rec["launches"],
                   "store": "hit" if rec["store_reused"] else "miss+measure"}
        print(f"{rec['matrix']}_{rec['variant']},"
              f"{rec['runner_wall_s'] * 1e6:.0f},"
              f"\"{json.dumps(derived)}\"", flush=True)
        bad = route_invariants(rec)
        if bad:
            failures += 1
            print(f"ROUTE INVARIANT FAILED [{rec['variant']}]: "
                  f"{'; '.join(bad)}", flush=True)
    if not failures:
        failures += route_sibling_p99(devices, runner.device)
        failures += route_delta_vs_replan()
    if not failures:
        _, failures = _resume(spec, store, device, failures)

    rows = [[r["matrix"], r["variant"], r["placement"], r["ok"],
             r["unresolved"], r["structure_updates"], r["replans_landed"],
             r["value_swaps"], int(r["per_device_ok"]),
             json.dumps(r["assignments"])]
            for r in rep.records]
    common.write_csv(common.result_path(SMOKE_ROUTE_CSV), SMOKE_ROUTE_HEADER,
                     rows)
    _write_summary(ROUTE_SUMMARY_NAME, failures, len(spec.cells()),
                   rep.records)
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
    ap.add_argument("--smoke-serve", action="store_true",
                    help="traffic-sim soak campaign over the 'serve' cell "
                         "kind (hardened-service invariants)")
    ap.add_argument("--smoke-route", action="store_true",
                    help="multi-shard router soak over the 'route' cell "
                         "kind (placement, per-device budgets, delta "
                         "shard replans)")
    ap.add_argument("--smoke-workloads", action="store_true",
                    help="dynamic-sparsity campaign over the 'workload' "
                         "cell kind (moe/attn/gnn streams + amortization "
                         "invariants)")
    ap.add_argument("--devices", type=int, default=8,
                    help="device count for --smoke-parallel/--smoke-route")
    ap.add_argument("--matrices", default="",
                    help="comma-separated matrix names (restricts the "
                         "smokes and the tier-reading figures)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="record phase-attributed spans for the whole run: "
                         ".jsonl -> raw event log, anything else -> "
                         "Chrome-trace JSON (load in ui.perfetto.dev)")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    mats = [m for m in args.matrices.split(",") if m] or None
    only = set(args.only.split(",")) if args.only else None
    if only:
        unknown = only - set(MODULES) - set(ON_REQUEST)
        if unknown:
            ap.error(f"--only: {sorted(unknown)} unknown; choose from "
                     f"{MODULES + list(ON_REQUEST)}")

    smokes = {
        "smoke_parallel": lambda: smoke_parallel(mats, args.devices,
                                                 args.device),
        "smoke_serve": lambda: smoke_serve(mats, args.device),
        "smoke_route": lambda: smoke_route(mats, args.devices, args.device),
        "smoke_workloads": lambda: workloads.smoke(mats, device=args.device),
        "smoke": lambda: smoke(mats, args.device),
    }
    for flag, fn in smokes.items():
        if getattr(args, flag):
            with obs.trace_to(args.trace):
                failures = fn()
            raise SystemExit(1 if failures else 0)

    print("name,us_per_call,derived")
    failures = 0
    with obs.trace_to(args.trace):
        for name in (*MODULES, *ON_REQUEST):
            if (name not in only) if only else (name in ON_REQUEST):
                continue
            t0 = time.time()
            try:
                derived = run_module(name, args.quick, mats, args.device)
                us = (time.time() - t0) * 1e6
                print(f"{name},{us:.0f},"
                      f"\"{json.dumps(derived, default=str)}\"", flush=True)
            except Exception as e:
                failures += 1
                us = (time.time() - t0) * 1e6
                print(f"{name},{us:.0f},\"ERROR: {type(e).__name__}: {e}\"",
                      flush=True)
                traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
