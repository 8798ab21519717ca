"""Cell measurement kinds — what the Runner executes on a store miss.

A kind is a function `(cell, mat, device) -> record` registered in
CELL_KINDS. Built-ins, as in the JAX package:

  * "spmv"     — the paper's full per-cell protocol through the
                 Problem→Plan→Operator facade: plan (reorder + tune) once,
                 then any subset of {IOS, YAX, instrumented CG,
                 modelled-parallel static/nnz-balanced, analytic structural
                 metrics} per the cell's resolved policy. k > 1 times the
                 SpMM path (`op.matmul`) and reports amortized per-vector
                 time. Plan-time fields (reorder_ms/tune_ms/build_ms) are
                 recorded apart from run-time fields — the paper's §3
                 accounting rule. With verify on, the cell checks its
                 operator and the operator of its structure twin (the same
                 pattern with values U(-1, 1)) against the float64 oracle.
                 `launches` counts the kernel launches of the timed IOS,
                 YAX and CG calls alone (repro_torch.kernels.LAUNCHES), so
                 a record shows which kernel its times went through.
  * "schedule" — the scheduling-policy sweep (paper Fig. 4 adapted):
                 variant names pick the policy — "static_default",
                 "static_c<chunk>" (strided chunked-cyclic panels, each
                 timed on its own gathered submatrix), "nnz_balanced".
  * "parallel" — topology-aware cells (figs 4, 9–11 as campaigns): the
                 variant is "<layout>:<partitioner>" (e.g.
                 "1d_rows:nnz_balanced", "1d_rows:chunked_cyclic_c16",
                 "2d_panels:metis_cut"); the cell plans through
                 plan(topology=Topology(devices=p, layout=...)) and
                 records the partition-quality metrics (LI, cut volume,
                 halo width), the modelled collective bytes and schedule,
                 the calibrated modelled-parallel time on the plan's own
                 panels (their engine: bell launches K4) and, with verify
                 on, the ShardedOperator's original-index-space check on
                 the matrix and its structure twin, and whether it ran
                 simulated (one card for a p-device plan).
  * "workload" — one workload:// stream (the variant is the scenario)
                 through a WorkloadSession: plan/reuse/rebuild counts,
                 plan cost share, sparse vs reference time.
  * "serve"    — one open-loop traffic run (serve_variant encodes it)
                 against an SpmvService: SLO percentiles, outcome counts
                 and the hardening invariants.
  * "route"    — one traffic run against a RoutedSpmvService FLEET
                 (repro_torch.router): the variant encodes load + fleet
                 shape (`route_variant(...)` — meshes, devices per mesh,
                 placement policy, per-device budget, structure-delta
                 mix) and the record adds the router verdicts:
                 per_device_ok, replans landed vs delta applies, and the
                 key→mesh assignment. On one card a mesh's devices are
                 simulated (router/service.py).
The workload, serve and route records carry `launches`, the kernel
launches of their own run.

Third-party kinds register with @register_cell_kind.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..device import torch_dtype

CELL_KINDS: Dict[str, Callable] = {}


def register_cell_kind(name: str, override: bool = False) -> Callable:
    def deco(fn: Callable) -> Callable:
        if name in CELL_KINDS and not override:
            raise ValueError(f"cell kind {name!r} already registered")
        CELL_KINDS[name] = fn
        return fn

    return deco


def get_cell_kind(name: str) -> Callable:
    try:
        return CELL_KINDS[name]
    except KeyError:
        raise KeyError(f"unknown cell kind {name!r}; known: "
                       f"{sorted(CELL_KINDS)}") from None


def _median_ios(op, x0, k, n, dtype, pol, device) -> float:
    """Median IOS milliseconds over `repeats` independent runs."""
    from ..core.measure import ios

    samples = []
    for r in range(int(pol["repeats"])):
        if k <= 1:
            t = ios.run_ios(op, x0, iters=pol["iters"], warmup=pol["warmup"])
        else:
            t = ios.run_ios_batched(op, n, k, iters=pol["iters"],
                                    warmup=pol["warmup"], dtype=dtype,
                                    seed=pol["seed"] + r, device=device)
        samples.append(np.asarray(t))
    return float(np.median(np.concatenate(samples)))


@register_cell_kind("spmv")
def measure_spmv_cell(cell, mat, device) -> dict:
    """All measurements for one (matrix, scheme, machine point, k) cell."""
    from .. import kernels
    from ..core.measure import cg, ios, parallel_model
    from ..core.sparse import metrics, partition
    from ..core.spmv.plan import SpmvProblem, plan
    from ..launch import spmv_bench

    pol = cell.policy_dict()
    dtype = torch_dtype(cell.dtype)
    hints = {"seed": pol["seed"]}
    if pol["use_kernel"] != "auto":
        hints["use_kernel"] = pol["use_kernel"]
    # one plan() + build() through the pipeline facade: a repeat campaign
    # reloads the plan and the operator's arrays from the plan store
    pl = plan(SpmvProblem(mat, k=cell.k, dtype=cell.dtype, hints=hints),
              reorder=cell.scheme, engine=cell.engine, probe=pol["probe"],
              device=device)
    rmat = pl.reordered_matrix()
    rec = {
        "m": int(mat.m), "n": int(mat.n), "nnz": int(rmat.nnz),
        # plan-time accounting (paper methodology: preprocessing is
        # reported apart from SpMV run time, never folded in)
        "resolved_scheme": pl.scheme,
        "tuner_choice": pl.tune.engine,
        "plan_label": pl.tune.label(),
        "reorder_ms": pl.reorder_ms,
        "tune_ms": pl.tune_ms,
        "plan_ms": pl.plan_ms,
        "plan_store_hit": bool(pl.cache_hit),
    }
    if pl.tune.features:
        rec["features"] = {k: float(v) for k, v in pl.tune.features.items()}
    rec["tuner_decision"] = {
        "engine": pl.tune.engine,
        "block_shape": list(pl.tune.block_shape),
        "sell_sigma": (None if pl.tune.sell_sigma is None
                       else int(pl.tune.sell_sigma)),
    }
    rec["advisor_confidence"] = float(pl.advisor_confidence)
    rec["probed_candidates"] = len(pl.tune.probe_ms or {})
    rec["tuner_candidates"] = len(pl.tune.costs)
    if cell.engine == "auto":
        rec["tuner_label"] = pl.tune.label()
        rec["tuner_cost_bytes"] = pl.tune.cost_bytes

    need_op = pol["time_spmv"] or pol["with_yax"] or pol["with_cg"] \
        or pol["verify"]
    panel_engine = cell.engine
    if need_op:
        op_full = pl.build(device=device)
        build_info = op_full.build_info
        op = op_full.unwrap()     # measurements run in the reordered space
        rec.update({
            "engine": build_info["engine"],
            "format_build_ms": build_info["build_ms"],
            "op_cache_hit": build_info["cache_hit"],
            "op_load_ms": build_info["load_ms"],
        })
        # panels use the CONCRETE engine the tuner chose for the whole
        # matrix (never "auto": re-tuning per panel would time the tuner)
        panel_engine = build_info["engine"] if cell.engine == "auto" \
            else cell.engine
        if pol["verify"]:
            tol = pol.get("verify_tol", 1e-4)
            rec["verify_rel_err"] = spmv_bench.verify(
                op_full, mat, cell.k, dtype, device, tol, pol["seed"])
            # the generators' dominant diagonal hides wrong off-diagonal
            # terms; the structure twin, under the same plan, does not
            twin = spmv_bench.structure_twin(mat, pol["seed"])
            twin_op = pl.build(device=device, values=twin.vals)
            rec["verify_twin_rel_err"] = spmv_bench.verify(
                twin_op, twin, cell.k, dtype, device, tol, pol["seed"])
            del twin_op
        rng = np.random.default_rng(pol["seed"])
        x0 = torch.as_tensor(rng.standard_normal(rmat.n)).to(device, dtype)
        before = dict(kernels.LAUNCHES)
        if pol["time_spmv"]:
            ms = _median_ios(op, x0, cell.k, rmat.n, dtype, pol, device)
            if cell.k <= 1:
                rec["seq_ios_ms"] = ms
                rec["seq_ios_gflops"] = float(
                    ios.gflops(rmat.nnz, np.array([ms]))[0])
                # aliases so k is a uniform axis in SpMM-shaped reports
                rec["spmm_ms"] = ms
                rec["per_vector_ms"] = ms
            else:
                rec["spmm_ms"] = ms
                rec["per_vector_ms"] = ms / cell.k
                rec["spmm_gflops"] = float(
                    ios.gflops(rmat.nnz * cell.k, np.array([ms]))[0])
        if pol["with_yax"] and cell.k <= 1:
            yax = float(np.median(ios.run_yax(
                op, x0, iters=pol["iters"], warmup=pol["warmup"])))
            rec["seq_yax_ms"] = yax
            rec["seq_yax_gflops"] = float(
                ios.gflops(rmat.nnz, np.array([yax]))[0])
        if pol["with_cg"] and cell.k <= 1:
            cg_ms = float(np.median(cg.cg_measured(
                op, x0, iters=pol["iters"], warmup=pol["warmup"])))
            rec["cg_ms"] = cg_ms
            rec["cg_gflops"] = float(
                ios.gflops(rmat.nnz, np.array([cg_ms]))[0])
        rec["launches"] = kernels.launches_since(before)
        del op, op_full

    if pol["with_parallel"]:
        for sched in ("static", "nnz_balanced"):
            ms = parallel_model.modelled_parallel_ms(
                rmat, cell.p, panel_engine, schedule=sched,
                iters=max(6, pol["iters"] // 2), device=device)
            rec[f"par_{sched}_ms"] = ms
            rec[f"par_{sched}_gflops"] = float(
                ios.gflops(rmat.nnz, np.array([ms]))[0])
    if pol["with_metrics"]:
        # structural metrics (analytic, exact) at this cell's p
        panels_s = partition.static_partition(rmat, cell.p)
        panels_b = partition.nnz_balanced_partition(rmat, cell.p)
        rec["li_static"] = metrics.load_imbalance(rmat, panels_s)
        rec["li_nnz_balanced"] = metrics.load_imbalance(rmat, panels_b)
        rec["bandwidth"] = metrics.bandwidth(rmat)
        rec["avg_row_bandwidth"] = metrics.avg_row_bandwidth(rmat)
        rec["cut_volume"] = metrics.cut_volume(rmat, panels_s)
        rec["block_fill_8x128"] = metrics.block_fill_ratio(rmat, 8, 128)
    return rec


# --------------------------------------------------------------------------
# topology-aware cells (figs 4, 9-11 as campaigns over sharded plans)
# --------------------------------------------------------------------------
def parallel_variant(layout: str, partitioner: str) -> str:
    """The variants-axis encoding of one (layout, partitioner) point."""
    return f"{layout}:{partitioner}"


def _parse_parallel_variant(variant: str):
    from ..core.spmv.topology import LAYOUTS

    layout, _, part = (variant or "").partition(":")
    if not part:
        if layout in LAYOUTS:            # bare layout -> default partition
            part = "nnz_balanced"
        else:                            # bare partitioner -> default layout
            layout, part = "1d_rows", layout or "nnz_balanced"
    return layout, part


@register_cell_kind("parallel")
def measure_parallel_cell(cell, mat, device) -> dict:
    """One (matrix, scheme, machine point, layout x partitioner) cell of a
    distributed campaign, through the topology-aware facade."""
    from .. import kernels
    from ..core.measure import ios, parallel_model
    from ..core.spmv.plan import SpmvProblem, plan
    from ..core.spmv.topology import Topology
    from ..launch import spmv_bench

    pol = cell.policy_dict()
    if cell.p < 2:
        raise ValueError(
            f"'parallel' cells need p >= 2 devices, got p={cell.p} "
            f"(a 1-device topology is the single-device pipeline — "
            f"use the 'spmv' kind)")
    layout, part = _parse_parallel_variant(cell.variant)
    topo = Topology(devices=cell.p, layout=layout)
    dtype = torch_dtype(cell.dtype)
    hints = {"seed": pol["seed"]}
    pl = plan(SpmvProblem(mat, k=cell.k, dtype=cell.dtype, hints=hints),
              reorder=cell.scheme, engine=cell.engine, topology=topo,
              partition=part, device=device)
    rmat = pl.reordered_matrix()
    comm = pl.comm
    rec = {
        "m": int(mat.m), "n": int(mat.n), "nnz": int(rmat.nnz),
        "devices": int(cell.p), "layout": layout,
        "partitioner": pl.partitioner,
        "resolved_scheme": pl.scheme,
        "engine": pl.tune.engine,
        "plan_label": pl.label(),
        "reorder_ms": pl.reorder_ms,
        "tune_ms": pl.tune_ms,
        "plan_ms": pl.plan_ms,
        "plan_store_hit": bool(pl.cache_hit),
        # partition quality (the paper's parallel-execution story):
        "li": comm.get("li"),
        "cut_volume": comm.get("cut_volume"),
        "halo_width": comm.get("halo_width"),
        "comm_schedule": comm.get("schedule"),
        "comm_bytes_per_spmv": comm.get("bytes_per_spmv"),
        "gather_bytes": comm.get("gather_bytes"),
        "halo_bytes": comm.get("halo_bytes"),
        "h_pad": comm.get("h_pad"),
    }
    if pol["verify"]:
        op = pl.build(device=device)
        rec.update({
            "op_cache_hit": op.build_info.get("cache_hit", False),
            "op_load_ms": op.build_info.get("load_ms", 0.0),
            "format_build_ms": op.build_info.get("build_ms", 0.0),
            "simulated": bool(op.simulated),
        })
        tol = pol.get("verify_tol", 1e-4)
        rec["verify_rel_err"] = spmv_bench.verify(
            op, mat, cell.k, dtype, device, tol, pol["seed"])
        del op
        # the generators' dominant diagonal hides wrong off-diagonal
        # terms; the structure twin, under the same plan, does not
        twin = spmv_bench.structure_twin(mat, pol["seed"])
        twin_op = pl.build(device=device, values=twin.vals)
        rec["verify_twin_rel_err"] = spmv_bench.verify(
            twin_op, twin, cell.k, dtype, device, tol, pol["seed"])
        del twin_op
    if pol["time_spmv"]:
        # calibrated per-panel model on the plan's own panels and engine
        # (the "schedule" kind's protocol, so figs 4/11 stay comparable)
        before = dict(kernels.LAUNCHES)
        ms = parallel_model.modelled_parallel_ms(
            rmat, topo.row_devices, pl.tune.engine,
            panels=pl.panel_starts, iters=pol["iters"],
            rng_seed=pol["seed"], device=device)
        rec["modelled_par_ms"] = ms
        rec["gflops"] = float(ios.gflops(rmat.nnz, np.array([ms]))[0])
        rec["launches"] = kernels.launches_since(before)
    return rec


# --------------------------------------------------------------------------
# scheduling-policy cells (paper Fig. 4 adapted)
# --------------------------------------------------------------------------
def _rows_submatrix(mat, rows: np.ndarray):
    """The rows `rows` of `mat`, in that order, as a (len(rows), n) matrix
    (vectorized; the same arrays as the JAX package's row loop)."""
    from ..core.sparse.csr import CSRMatrix

    rows = np.asarray(rows, np.int64)
    rp = mat.rowptr.astype(np.int64)
    counts = rp[rows + 1] - rp[rows]
    rowptr = np.zeros(rows.size + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(counts)
    # element e of the gathered row i sits at rp[rows[i]] + e
    idx = (np.arange(rowptr[-1], dtype=np.int64)
           + np.repeat(rp[rows] - rowptr[:-1], counts))
    return CSRMatrix(rowptr=rowptr.astype(np.int32), cols=mat.cols[idx],
                     vals=mat.vals[idx], shape=(rows.size, mat.n))


def _chunked_static_ms(mat, p: int, chunk: int, iters: int, seed: int,
                       device) -> float:
    """Modelled parallel time under static,chunk scheduling: each thread's
    rows are a strided set, timed on its own gathered submatrix (the
    locality loss of striding included). IOS semantics: the panel's output
    refreshes x at ITS OWN row positions (x stays full-size)."""
    from ..core.measure import parallel_model
    from ..core.measure.ios import _sync, time_call
    from ..core.sparse import partition
    from ..core.spmv.ops import make_engine

    panels = partition.chunked_cyclic_panels(mat.m, p, chunk)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(mat.n)).to(device, torch.float32)
    worst = 0.0
    for rows in panels:
        op = make_engine(_rows_submatrix(mat, rows), "csr", device=device)
        rows_dev = torch.as_tensor(rows, dtype=torch.int64, device=device)
        xi = x.clone()
        times = []
        for i in range(iters + 2):
            ms, y = time_call(op, xi)
            if i >= 2:
                times.append(ms)
            xi[rows_dev] = y[: rows.size]
        _sync(xi)
        worst = max(worst, float(np.median(times)))
    return worst + parallel_model.ALPHA_SYNC_MS


@register_cell_kind("schedule")
def measure_schedule_cell(cell, mat, device) -> dict:
    """One (matrix, scheme, scheduling-policy) point; the policy is the
    variant. The scheme axis is honored like everywhere else (the matrix
    is permuted before panels are cut). Beside the paper's policies a
    variant may name a registered row partitioner (metis_cut): its
    permutation is applied and its panels are timed."""
    from ..core.measure import ios, parallel_model
    from ..core.reorder import api as reorder_api
    from ..core.sparse import partition

    pol = cell.policy_dict()
    if cell.scheme != "baseline":
        mat = mat.permute(reorder_api.reorder(mat, cell.scheme,
                                              pol["seed"]))
    var = cell.variant
    if var == "static_default":
        ms = parallel_model.modelled_parallel_ms(
            mat, cell.p, cell.engine, schedule="static", iters=pol["iters"],
            device=device)
    elif var == "nnz_balanced":
        ms = parallel_model.modelled_parallel_ms(
            mat, cell.p, cell.engine, schedule="nnz_balanced",
            iters=pol["iters"], device=device)
    elif var.startswith("static_c"):
        ms = _chunked_static_ms(mat, cell.p, int(var[len("static_c"):]),
                                pol["iters"], pol["seed"], device)
    elif var in partition.PARTITIONER_REGISTRY:
        perm, starts = partition.resolve_partitioner(var)[1](
            mat, cell.p, pol["seed"])
        if perm is not None:
            mat = mat.permute(perm)
        ms = parallel_model.modelled_parallel_ms(
            mat, cell.p, cell.engine, iters=pol["iters"], panels=starts,
            device=device)
    else:
        raise ValueError(f"unknown scheduling variant {var!r}")
    return {
        "m": int(mat.m), "n": int(mat.n), "nnz": int(mat.nnz),
        "modelled_par_ms": ms,
        "gflops": float(ios.gflops(mat.nnz, np.array([ms]))[0]),
    }


# --------------------------------------------------------------------------
# workload cells (dynamic sparsity streams)
# --------------------------------------------------------------------------
@register_cell_kind("workload")
def measure_workload_cell(cell, mat, device) -> dict:
    """One workload stream: cell.matrix is a `workload://` name, the
    variant is the scenario. The resolved suite matrix (step-0
    representative) is ignored — the stream regenerates every step from
    the cell's seed, so the cell stays content-addressed on
    (name, scenario, scheme, engine, policy)."""
    from .. import kernels
    from ..workloads import DynamicSparseProblem, WorkloadSession, run_stream

    pol = cell.policy_dict()
    scenario = cell.variant or "drift"
    problem = DynamicSparseProblem(cell.matrix, scenario=scenario,
                                   seed=pol["seed"], dtype=cell.dtype)
    if problem.wdef.kind == "moe" and cell.scheme != "baseline":
        raise ValueError(
            f"moe workloads have rectangular dispatch/combine matrices; "
            f"symmetric reordering scheme {cell.scheme!r} does not apply "
            f"(the dispatch IS the reordering) — use scheme='baseline'")
    session = WorkloadSession(problem, reorder=cell.scheme,
                              engine=cell.engine, probe=pol["probe"],
                              device=device)
    before = dict(kernels.LAUNCHES)
    rec = run_stream(problem, session, iters=max(int(pol["iters"]), 2),
                     compare_dense=pol["time_spmv"], verify=pol["verify"])
    rec["launches"] = kernels.launches_since(before)
    if problem.wdef.kind == "moe":
        # the seed benchmark's vocabulary: sparse chain == sorted
        # dispatch, reference == onehot baseline
        rec["sorted_ms"] = rec["sparse_ms"]
        if "ref_ms" in rec:
            rec["onehot_ms"] = rec["ref_ms"]
            rec["sorted_vs_onehot_speedup"] = rec["speedup_vs_ref"]
        if "verify_ok" in rec:
            rec["dispatch_agree"] = rec["verify_ok"]
    return rec


# --------------------------------------------------------------------------
# serving cells (open-loop traffic sim -> SLO summary)
# --------------------------------------------------------------------------
_SERVE_DEFAULTS = {
    "arrival": "poisson", "rate_rps": 300.0, "requests": 200,
    "n_keys": 1, "zipf_s": 1.1, "update_frac": 0.0,
    "budget_mb": 0.0,            # 0 = unbudgeted
    "max_queue": 64, "window_ms": 2.0, "overload": "reject",
}


def serve_variant(arrival: str = "poisson", rate_rps: float = 300.0,
                  requests: int = 200, n_keys: int = 1,
                  zipf_s: float = 1.1, update_frac: float = 0.0,
                  budget_mb: float = 0.0, max_queue: int = 64,
                  window_ms: float = 2.0,
                  overload: str = "reject") -> str:
    """The variants-axis encoding of one traffic scenario: the arrival
    kind followed by single-letter-prefixed tokens (r=rate_rps,
    n=requests, K=n_keys, z=zipf_s, u=update_frac, m=budget_mb [0=none],
    q=max_queue, w=window_ms, o=overload policy). Defaults are elided so
    equal scenarios always encode to the SAME string (cell identity)."""
    toks = [arrival]
    for tag, name, val in (("r", "rate_rps", rate_rps),
                           ("n", "requests", requests),
                           ("K", "n_keys", n_keys),
                           ("z", "zipf_s", zipf_s),
                           ("u", "update_frac", update_frac),
                           ("m", "budget_mb", budget_mb),
                           ("q", "max_queue", max_queue),
                           ("w", "window_ms", window_ms),
                           ("o", "overload", overload)):
        if val != _SERVE_DEFAULTS[name]:
            toks.append(f"{tag}{val:g}" if isinstance(val, float)
                        else f"{tag}{val}")
    return ",".join(toks)


def _parse_serve_variant(variant: str) -> dict:
    from ..serving.traffic import ARRIVALS

    cfg = dict(_SERVE_DEFAULTS)
    toks = [t for t in (variant or "").split(",") if t]
    if toks and toks[0] in ARRIVALS:
        cfg["arrival"] = toks.pop(0)
    casts = {"r": ("rate_rps", float), "n": ("requests", int),
             "K": ("n_keys", int), "z": ("zipf_s", float),
             "u": ("update_frac", float), "m": ("budget_mb", float),
             "q": ("max_queue", int), "w": ("window_ms", float),
             "o": ("overload", str)}
    for t in toks:
        if t[0] not in casts:
            raise ValueError(f"unknown serve-variant token {t!r} in "
                             f"{variant!r} (known: {sorted(casts)})")
        name, cast = casts[t[0]]
        cfg[name] = cast(t[1:])
    return cfg


@register_cell_kind("serve")
def measure_serve_cell(cell, mat, device) -> dict:
    """One open-loop traffic run: cell.k is the service's max_batch, the
    variant the scenario. The matrix is registered under n_keys distinct
    service keys (Zipf-skewed traffic over them), so the memory budget
    sees n_keys resident operators while the content-addressed plan
    store holds ONE entry — evictions reload zero-re-tune, which is the
    LRU pillar this cell measures."""
    from .. import kernels
    from ..serving import traffic
    from ..serving.spmv_service import SpmvService

    pol = cell.policy_dict()
    cfg = _parse_serve_variant(cell.variant)
    pattern = traffic.TrafficPattern(
        arrival=cfg["arrival"], rate_rps=cfg["rate_rps"],
        requests=cfg["requests"], n_keys=cfg["n_keys"],
        zipf_s=cfg["zipf_s"], update_frac=cfg["update_frac"],
        seed=pol["seed"])
    budget = (None if cfg["budget_mb"] <= 0
              else int(cfg["budget_mb"] * (1 << 20)))
    svc = SpmvService(
        engine=cell.engine, max_batch=max(int(cell.k), 1),
        window_ms=cfg["window_ms"], use_kernel=pol["use_kernel"],
        dtype=torch_dtype(cell.dtype), max_queue=cfg["max_queue"],
        reorder=cell.scheme, memory_budget_bytes=budget,
        overload=cfg["overload"], device=device)
    before = dict(kernels.LAUNCHES)
    try:
        for i in range(cfg["n_keys"]):
            svc.register(f"{cell.matrix}#{i}", mat)
        summary = traffic.run_open_loop(
            svc, {f"{cell.matrix}#{i}": mat for i in range(cfg["n_keys"])},
            pattern)
        svc.flush()
        stats = svc.stats()       # quiescent: counters fully balanced
    finally:
        svc.close()
    slo = stats["slo"]
    return {
        "m": int(mat.m), "n": int(mat.n), "nnz": int(mat.nnz),
        "offered": summary["offered"], "submitted": summary["submitted"],
        "ok": summary["ok"], "shed": summary["shed"],
        "rejected": summary["rejected"], "errors": summary["errors"],
        "unresolved": summary["unresolved"],
        "updates": summary["updates"],
        "update_conflicts": summary["update_conflicts"],
        "update_errors": summary["update_errors"],
        "retry_after_positive": bool(summary["retry_after_positive"]),
        "offered_rps": float(summary["offered_rps"]),
        "achieved_rps": float(summary["achieved_rps"]),
        "wall_s": float(summary["wall_s"]),
        "submit_s": float(summary["submit_s"]),
        "drain_s": float(summary["drain_s"]),
        "p50_ms": float(slo["p50_ms"]), "p95_ms": float(slo["p95_ms"]),
        "p99_ms": float(slo["p99_ms"]),
        "throughput_rps": float(slo["throughput_rps"]),
        "shed_rate": float(slo["shed_rate"]),
        "reject_rate": float(slo["reject_rate"]),
        "eviction_rate": float(slo["eviction_rate"]),
        "coalesce_ratio": float(stats["coalesce_ratio"]),
        "avg_batch": float(stats["avg_batch"]),
        "batch_size_max": int(stats["batch_size_max"]),
        "op_builds": int(stats["op_builds"]),
        "op_reloads": int(stats["op_reloads"]),
        "evictions": int(stats["evictions"]),
        "value_swaps": int(stats["value_swaps"]),
        "replans": int(stats["replans"]),
        "wakeups": int(stats["wakeups"]),
        "resident_bytes_max": int(stats["resident_bytes_max"]),
        "memory_budget_bytes": int(budget or 0),
        "budget_ok": bool(summary["budget_ok"]),
        # the no-silent-drops invariant, checked at quiescence: every
        # admitted request is accounted a result, a shed, or an error
        "counters_balanced": bool(
            stats["requests"] == stats["results"] + stats["sheds"]
            + stats["errors"] and stats["pending"] == 0),
        "launches": kernels.launches_since(before),
    }


# --------------------------------------------------------------------------
# routed serving cells (multi-shard fleet traffic)
# --------------------------------------------------------------------------
_ROUTE_DEFAULTS = {
    "arrival": "poisson", "rate_rps": 300.0, "requests": 200,
    "n_keys": 2, "zipf_s": 1.1, "update_frac": 0.0,
    "structure_frac": 0.0,
    "devices": 2,                # devices per mesh
    "meshes": 2,                 # fleet size
    "layout": "1d_rows",
    "policy": "bin_pack",        # placement policy
    "budget_mb": 0.0,            # per-DEVICE budget (0 = unbudgeted)
    "window_ms": 2.0,
}


def route_variant(arrival: str = "poisson", rate_rps: float = 300.0,
                  requests: int = 200, n_keys: int = 2,
                  zipf_s: float = 1.1, update_frac: float = 0.0,
                  structure_frac: float = 0.0, devices: int = 2,
                  meshes: int = 2, layout: str = "1d_rows",
                  policy: str = "bin_pack", budget_mb: float = 0.0,
                  window_ms: float = 2.0) -> str:
    """Variants-axis encoding of one routed-fleet scenario (the serve
    kind's convention: arrival first, then single-letter tokens with
    defaults elided — r=rate_rps, n=requests, K=n_keys, z=zipf_s,
    u=update_frac, s=structure_frac, d=devices per mesh, M=meshes,
    L=layout, P=placement policy, m=per-device budget_mb, w=window_ms)."""
    toks = [arrival]
    for tag, name, val in (("r", "rate_rps", rate_rps),
                           ("n", "requests", requests),
                           ("K", "n_keys", n_keys),
                           ("z", "zipf_s", zipf_s),
                           ("u", "update_frac", update_frac),
                           ("s", "structure_frac", structure_frac),
                           ("d", "devices", devices),
                           ("M", "meshes", meshes),
                           ("L", "layout", layout),
                           ("P", "policy", policy),
                           ("m", "budget_mb", budget_mb),
                           ("w", "window_ms", window_ms)):
        if val != _ROUTE_DEFAULTS[name]:
            toks.append(f"{tag}{val:g}" if isinstance(val, float)
                        else f"{tag}{val}")
    return ",".join(toks)


def _parse_route_variant(variant: str) -> dict:
    from ..serving.traffic import ARRIVALS

    cfg = dict(_ROUTE_DEFAULTS)
    toks = [t for t in (variant or "").split(",") if t]
    if toks and toks[0] in ARRIVALS:
        cfg["arrival"] = toks.pop(0)
    casts = {"r": ("rate_rps", float), "n": ("requests", int),
             "K": ("n_keys", int), "z": ("zipf_s", float),
             "u": ("update_frac", float), "s": ("structure_frac", float),
             "d": ("devices", int), "M": ("meshes", int),
             "L": ("layout", str), "P": ("policy", str),
             "m": ("budget_mb", float), "w": ("window_ms", float)}
    for t in toks:
        if t[0] not in casts:
            raise ValueError(f"unknown route-variant token {t!r} in "
                             f"{variant!r} (known: {sorted(casts)})")
        name, cast = casts[t[0]]
        cfg[name] = cast(t[1:])
    return cfg


@register_cell_kind("route")
def measure_route_cell(cell, mat, device) -> dict:
    """One open-loop traffic run against a RoutedSpmvService fleet: the
    variant encodes load shape + fleet shape (`route_variant(...)`),
    cell.k is each mesh service's max_batch. The matrix registers under
    n_keys distinct keys routed across the meshes by the placement
    policy; traffic mixes submits with value swaps and small deletion
    StructureDeltas (the delta-apply shard-replan path). The record adds
    the router's verdicts — per_device_ok, replans landed, the
    key→mesh assignment — to the serve-kind SLO summary, and the kernel
    launches of its own run."""
    from .. import kernels
    from ..core.spmv.topology import Topology
    from ..router import MeshSpec, RoutedSpmvService
    from ..serving import traffic

    pol = cell.policy_dict()
    cfg = _parse_route_variant(cell.variant)
    pattern = traffic.TrafficPattern(
        arrival=cfg["arrival"], rate_rps=cfg["rate_rps"],
        requests=cfg["requests"], n_keys=cfg["n_keys"],
        zipf_s=cfg["zipf_s"], update_frac=cfg["update_frac"],
        structure_frac=cfg["structure_frac"], seed=pol["seed"])
    budget = (None if cfg["budget_mb"] <= 0
              else int(cfg["budget_mb"] * (1 << 20)))
    meshes = [MeshSpec(f"mesh{i}",
                       Topology(devices=cfg["devices"],
                                layout=cfg["layout"]),
                       budget_per_device=budget)
              for i in range(cfg["meshes"])]
    svc = RoutedSpmvService(
        meshes, policy=cfg["policy"], engine=cell.engine,
        max_batch=max(int(cell.k), 1), window_ms=cfg["window_ms"],
        use_kernel=pol["use_kernel"], dtype=torch_dtype(cell.dtype),
        reorder=cell.scheme, device=device)
    before = dict(kernels.LAUNCHES)
    try:
        mats = {f"{cell.matrix}#{i}": mat for i in range(cfg["n_keys"])}
        for k, m in mats.items():
            svc.register(k, m)
        summary = traffic.run_open_loop(svc, mats, pattern)
        svc.flush()
        stats = svc.stats()       # quiescent: counters fully balanced
    finally:
        svc.close()
    return {
        "m": int(mat.m), "n": int(mat.n), "nnz": int(mat.nnz),
        "offered": summary["offered"], "submitted": summary["submitted"],
        "ok": summary["ok"], "shed": summary["shed"],
        "rejected": summary["rejected"], "errors": summary["errors"],
        "unresolved": summary["unresolved"],
        "updates": summary["updates"],
        "update_conflicts": summary["update_conflicts"],
        "structure_updates": summary["structure_updates"],
        "structure_conflicts": summary["structure_conflicts"],
        "replans_landed": summary["replans_landed"],
        "replan_errors": summary["replan_errors"],
        "replan_unresolved": summary["replan_unresolved"],
        "offered_rps": float(summary["offered_rps"]),
        "achieved_rps": float(summary["achieved_rps"]),
        "wall_s": float(summary["wall_s"]),
        "devices": int(cfg["devices"]), "meshes": int(cfg["meshes"]),
        "layout": cfg["layout"], "placement": cfg["policy"],
        "budget_per_device": int(budget or 0),
        "per_device_ok": bool(stats["per_device_ok"]),
        "budget_ok": bool(summary["budget_ok"]),
        "replans": int(stats["replans"]),
        "value_swaps": int(stats["value_swaps"]),
        "evictions": int(stats["evictions"]),
        "assignments": dict(stats["routing"]["assignments"]),
        "counters_balanced": bool(
            stats["requests"] == stats["results"] + stats["sheds"]
            + stats["errors"] and stats["pending"] == 0),
        "launches": kernels.launches_since(before),
    }
