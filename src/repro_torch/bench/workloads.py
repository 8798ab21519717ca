"""Workload-shaped dynamic sparsity campaigns (`"workload"` cells).

    python -m repro_torch.bench.run --only workloads [--quick] [--device cpu]
    python -m repro_torch.bench.run --smoke-workloads [--device cpu]

The paper's amortization question asked on model-layer streams: MoE
token routing, block-sparse attention masks, GNN aggregation — each a
per-step sparse structure run through the pipeline under the
WorkloadSession reuse policy (repro_torch.workloads). Two specs because
the scheme axis is constrained by shape: moe dispatch/combine matrices
are rectangular (the dispatch IS the reordering), so they sweep
scenarios under scheme=baseline; attn/gnn matrices are square and sweep
baseline × rcm like everything else.

`run(quick)` is the campaign entry (bench.run MODULES); `smoke(...)` is
the gate behind `bench.run --smoke-workloads` (the amortization
invariants and the resume); `moe_dispatch_spec(...)` feeds the
moe_dispatch view. Every entry measures on the card unless it is given
device="cpu"; the CSVs go under common.results_dir().
"""
from __future__ import annotations

import json

from ..experiments import ExperimentSpec, MeasurePolicy, Runner
from .common import result_path, result_store, write_csv

SMOKE_MOE = "workload://moe-e8-k2-t256-d16-n4"
SMOKE_ATTN = "workload://attn-s128-b32-w2-g1-d8-n3"
SMOKE_GNN = "workload://gnn-m256-deg4-f8-n4"

CSV = "workloads.csv"
SMOKE_CSV = "smoke_workloads_campaign.csv"
CSV_HEADER = ["workload", "kind", "scenario", "scheme", "steps", "li_mean",
              "drop_frac", "reuse_rate", "plan_cost_share", "plans",
              "replans", "rebuilds", "reuses", "sparse_ms", "ref_ms",
              "speedup_vs_ref", "max_rel_err"]


def _policy(iters: int = 3) -> MeasurePolicy:
    return MeasurePolicy(iters=iters, warmup=0, verify=True,
                         with_yax=False, with_parallel=False,
                         with_metrics=False)


def moe_spec(matrices, name: str = "workloads_moe",
             scenarios=("static", "drift", "shift1"),
             iters: int = 3) -> ExperimentSpec:
    """MoE routing streams: scenarios under scheme=baseline (the sorted
    dispatch is itself the reordering; the rectangular dispatch/combine
    matrices admit no symmetric row/col permutation)."""
    return ExperimentSpec(
        name=name, matrices=tuple(matrices), schemes=("baseline",),
        engines=("auto",), kind="workload", variants=tuple(scenarios),
        policy=_policy(iters))


def structured_spec(matrices, name: str = "workloads_structured",
                    scenarios=("static", "drift", "shift1"),
                    schemes=("baseline", "rcm"),
                    iters: int = 3) -> ExperimentSpec:
    """Square workload streams (attn masks, gnn adjacency): the full
    schemes × scenarios grid — does reordering survive dynamic
    structure once replan cost is on the bill?"""
    return ExperimentSpec(
        name=name, matrices=tuple(matrices), schemes=tuple(schemes),
        engines=("auto",), kind="workload", variants=tuple(scenarios),
        policy=_policy(iters))


def moe_dispatch_spec(tokens: int, steps: int = 2,
                      iters: int = 5) -> ExperimentSpec:
    """The moe_dispatch view's spec: the (E, k) grid at d=128 as drift
    streams (fresh routing per step — the per-call regime)."""
    mats = tuple(f"workload://moe-e{e}-k{k}-t{tokens}-d128-n{steps}"
                 for e, k in ((16, 2), (64, 8)))
    return moe_spec(mats, name="moe_dispatch", scenarios=("drift",),
                    iters=iters)


def _row(rec) -> list:
    return [rec["matrix"], rec["kind"], rec["variant"] or "drift",
            rec["scheme"], rec["steps"], rec.get("li_mean"),
            rec.get("drop_frac", ""), rec["reuse_rate"],
            rec["plan_cost_share"], rec["plans"], rec["replans"],
            rec["rebuilds"], rec["reuses"], rec.get("sparse_ms"),
            rec.get("ref_ms", ""), rec.get("speedup_vs_ref", ""),
            rec.get("max_rel_err", "")]


def run(quick: bool = False, device=None):
    t = 512 if quick else 2048
    specs = [
        moe_spec((f"workload://moe-e8-k2-t{t}-d32-n6",
                  f"workload://moe-e16-k2-t{t}-d128-n4")),
        structured_spec((f"workload://attn-s{256 if quick else 512}"
                         f"-b32-w2-g1-d16-n6",
                         f"workload://gnn-m{512 if quick else 2048}"
                         f"-deg4-f16-n6")),
    ]
    store = result_store()
    records, out = [], {}
    for spec in specs:
        rep = Runner(spec, store=store, verbose=False, device=device).run()
        records.extend(rep.records)
    for rec in records:
        scen = rec["variant"] or "drift"
        key = f"{rec['kind']}_{scen}_{rec['scheme']}"
        out[f"{key}_reuse_rate"] = rec["reuse_rate"]
        out[f"{key}_plan_cost_share"] = rec["plan_cost_share"]
        if "speedup_vs_ref" in rec:
            out[f"{key}_speedup"] = rec["speedup_vs_ref"]
    out["verify_ok_all"] = all(r.get("verify_ok", True) for r in records)
    out["static_replans_total"] = sum(
        r["replans"] for r in records if (r["variant"] or "") == "static")
    write_csv(result_path(CSV), CSV_HEADER, [_row(r) for r in records])
    return out


def workload_invariants(rec) -> list:
    """What a "workload" record breaks of the amortization invariants;
    empty when it holds them all. Every cell is oracle-gated (one-hot
    scatter for moe, dense matmul for attn/gnn); value-only (static)
    streams never replan and show reuse; one mid-stream structure change
    replans a gnn stream exactly once."""
    scen = rec["variant"] or "drift"
    bad = []
    if not rec.get("verify_ok", False):
        bad.append(f"verify failed (max_rel_err="
                   f"{rec.get('max_rel_err')})")
    if rec["kind"] == "moe":
        if not rec.get("dispatch_bitwise_equal", False):
            bad.append("dispatch buffer NOT bitwise-equal to the "
                       "onehot oracle")
        if not rec.get("dispatch_agree", False):
            bad.append("sorted-vs-onehot combine disagree (>=1e-3)")
    if scen == "static" and rec["replans"] != 0:
        bad.append(f"value-only stream replanned "
                   f"{rec['replans']} times (want 0)")
    if scen == "static" and rec["reuse_rate"] <= 0:
        bad.append("value-only stream shows zero reuse")
    if rec["kind"] == "gnn" and scen == "shift1" and rec["replans"] != 1:
        bad.append(f"one structure change replanned "
                   f"{rec['replans']} times (want exactly 1)")
    return bad


def smoke(matrices=None, device=None) -> int:
    """MoE + block-attention + GNN streams through the ResultStore, each
    record held to workload_invariants, then the identical re-run served
    100% from the store. Returns the failure count."""
    mats = tuple(matrices or (SMOKE_MOE, SMOKE_ATTN, SMOKE_GNN))
    moe_mats = tuple(m for m in mats if m.startswith("workload://moe"))
    sq_mats = tuple(m for m in mats if m not in moe_mats)
    specs = []
    if moe_mats:
        specs.append(moe_spec(moe_mats, name="smoke_workloads_moe"))
    if sq_mats:
        specs.append(structured_spec(sq_mats, name="smoke_workloads_sq",
                                     schemes=("baseline", "rcm")))
    store = result_store()
    failures, records, n_cells = 0, [], 0
    print("name,us_per_call,derived")
    for spec in specs:
        rep = Runner(spec, store=store, verbose=False, on_error="record",
                     device=device).run()
        failures += len(rep.failures)
        for f in rep.failures:
            print(f"{f['label']},0,\"ERROR: {f['error']}\"", flush=True)
            print(f["traceback"], flush=True)
        records.extend(rep.records)
        n_cells += len(spec.cells())
    for rec in records:
        scen = rec["variant"] or "drift"
        derived = {"scenario": scen, "scheme": rec["scheme"],
                   "reuse_rate": rec["reuse_rate"],
                   "plan_share": rec["plan_cost_share"],
                   "replans": rec["replans"], "li": rec.get("li_mean"),
                   "speedup": rec.get("speedup_vs_ref"),
                   "launches": rec.get("launches"),
                   "store": "hit" if rec["store_reused"] else "miss+measure"}
        print(f"{rec['matrix']}_{scen}_{rec['scheme']},"
              f"{rec['runner_wall_s'] * 1e6:.0f},"
              f"\"{json.dumps(derived)}\"", flush=True)
        bad = workload_invariants(rec)
        if bad:
            failures += 1
            print(f"WORKLOAD INVARIANT FAILED "
                  f"[{rec['matrix']} {scen} {rec['scheme']}]: "
                  f"{'; '.join(bad)}", flush=True)

    if not failures:
        reused = measured = 0
        for spec in specs:
            rep2 = Runner(spec, store=store, verbose=False,
                          device=device).run()
            reused += rep2.reused
            measured += rep2.measured
        if measured != 0 or reused != n_cells:
            print(f"RESUME FAILED: second run measured={measured} "
                  f"reused={reused} (want 0/{n_cells})", flush=True)
            failures += 1
        else:
            print(f"# resume: {reused}/{n_cells} cells served from the "
                  f"store (0 re-measured)", flush=True)

    write_csv(result_path(SMOKE_CSV), CSV_HEADER, [_row(r) for r in records])
    return failures
