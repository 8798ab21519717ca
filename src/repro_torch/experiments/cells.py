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

The JAX package's "parallel", "workload", "serve" and "route" kinds are
not ported yet; asking for one raises NotImplementedError naming what it
waits for. Third-party kinds register with @register_cell_kind.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..device import torch_dtype

CELL_KINDS: Dict[str, Callable] = {}

# the JAX package's other kinds, and what each waits for (ROADMAP queue A)
NOT_PORTED = {
    "parallel": "sharded plans (core/spmv/topology.py, distributed.py; "
                "queue A item 7)",
    "workload": "the workloads package (queue A item 6)",
    "serve": "the serving layer (queue A item 5)",
    "route": "the router (queue A item 5)",
}


def register_cell_kind(name: str, override: bool = False) -> Callable:
    def deco(fn: Callable) -> Callable:
        if name in CELL_KINDS and not override:
            raise ValueError(f"cell kind {name!r} already registered")
        CELL_KINDS[name] = fn
        return fn

    return deco


def get_cell_kind(name: str) -> Callable:
    if name in NOT_PORTED and name not in CELL_KINDS:
        raise NotImplementedError(f"cell kind {name!r} is not ported yet: "
                                  f"it needs {NOT_PORTED[name]}")
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
        rec["launches"] = {name: n - before[name]
                           for name, n in kernels.LAUNCHES.items()}
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
    is permuted before panels are cut)."""
    from ..core.measure import ios, parallel_model
    from ..core.reorder import api as reorder_api

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
    else:
        raise ValueError(f"unknown scheduling variant {var!r}")
    return {
        "m": int(mat.m), "n": int(mat.n), "nnz": int(mat.nnz),
        "modelled_par_ms": ms,
        "gflops": float(ios.gflops(mat.nnz, np.array([ms]))[0]),
    }
