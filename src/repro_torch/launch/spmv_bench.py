"""One paper cell on the card: plan → build → verify → IOS/YAX → CG.

    python -m repro_torch.launch.spmv_bench --matrix fig1_shuffled \\
        --scheme rcm --engine auto [--spmm K] [--iters N] [--device cuda]
    python -m repro_torch.launch.spmv_bench --serve-sim \
        --serve-reorder rcm [--device cpu]
    python -m repro_torch.launch.spmv_bench --serve-traffic \
        --matrix smoke_powerlaw --rate 500 --keys 4 [--budget-mb M]
    python -m repro_torch.launch.spmv_bench --matrix fig1_shuffled \
        --scheme rcm --devices 8 --layout 1d_rows --partition auto
    python -m repro_torch.launch.spmv_bench --serve-traffic \
        --devices 4 --meshes 2 --placement nnz_balance [--device cpu]
    python -m repro_torch.launch.spmv_bench [--multi-pod]    # host only

The port's counterpart of the JAX package's `run_single`: one matrix, one
reordering scheme ("auto" searches), one engine ("auto" tunes), as a
one-cell ExperimentSpec through the Runner into the figure drivers'
result store (under experiments/store.py results_dir()). It prints the resolved scheme
and engine, the host plan and build times, the IOS median and GFLOP/s
(2 flops per nonzero per right-hand side), and the launches of each
hand-written kernel during the cell's timed calls. Verification is
against the numpy float64 oracle `CSRMatrix.spmv` in the original index
space, for the cell's operator and for its structure twin (the same
structure with values U(-1, 1)). A repeat invocation is a result-store
hit (`store_hit=True`) that measures nothing; `--fresh` deletes the
cell's record first, so it measures again. The record is written to
spmv_single_<matrix>_<scheme>[_k<k>].json beside the drivers' CSVs.
`--probe` and `--learned` pass probe=True and probe="learned" to plan().
`run_cell` is the same chain on a matrix in memory, with no store of
records.

`--serve-sim` sends a burst of requests over the smoke matrices through
the micro-batching SpmvService (serving/spmv_service.py) and checks every
response against the numpy oracle; `--serve-traffic` drives one open-loop
traffic scenario (serving/traffic.py) against it and checks the service's
invariants. Both print one line and one JSON record, as a single cell
does. `--serve-traffic --devices N` (N > 1) serves the keys sharded
through the multi-shard router (router/service.py): a fleet of
`--meshes` meshes of N devices, keys placed by `--placement`, the budget
bounding every device; on one card each mesh's devices are simulated.

`--trace PATH` records the run's spans (.jsonl: the raw events, else
Chrome-trace JSON). The router soak is `repro_torch.bench.run
--smoke-route`.

`--matrix M --devices N [--layout L] [--partition P]` is one sharded cell
(`run_parallel`): a one-cell "parallel" ExperimentSpec through the
Runner and its result store, so a repeat invocation is a store hit. The
cell plans a Topology of N devices (partition x scheme x engine),
verifies the ShardedOperator in the original index space and reports the
modelled collective bytes of the chosen schedule beside the
modelled-parallel time. On one card a p-device plan runs simulated.
`--fresh` deletes the cell's stored record first, so it measures again.

With no `--matrix` (and no `--serve-*`) it is the distributed-SpMV
dry-run (`run_multi_pod`): the paper's own workload on the production
mesh, (16, 16) or with `--multi-pod` (2, 16, 16), on one rank of a fake
process group. A synthetic matrix of M_ROWS rows in BM x BN Block-ELL
bricks runs ITERS CG-like SpMVs (the plain `ref.spmv_bell` on meta
blocks, as the reference runs its `ref.spmv_bell`) in three layouts, and
`hlo_cost.analyze` counts each one's flops and collective bytes:
`lower_1d` (row panels; x all-gathered over the mesh every iteration),
`lower_2d` (rows over "data", columns over "model"; partial y all-reduced
over "model", the next x segment all-gathered over "data") and
`lower_halo` (row panels of a banded matrix after RCM; two ring permutes
of `halo` values through `dist.batch_isend_irecv`). It prints one line a
layout and the wire ratios, and writes spmv_distributed.json under the
drivers' results directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.measure import cg, ios
from ..core.sparse.csr import CSRMatrix
from ..core.spmv import ref
from ..core.spmv.plan import SpmvProblem, plan
from ..device import device_kind, resolve_device, torch_dtype
from ..distributed import sharding as SH
from ..kernels import LAUNCHES, launches_since


# synthetic production matrix: 4.19M rows, ~16 nnz/row, 8x128 bricks
M_ROWS = 1 << 22
BM, BN = 8, 128
K_1D = 32          # padded blocks per block-row (1-D panels)
ITERS = 8          # CG-like repeated SpMV (xs swap)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def lower_1d(mesh, m_rows: int = M_ROWS, iters: int = ITERS):
    """The 1-D layout on this rank, as a thunk: its row panel's blocks
    [nbr, K_1D, BM, BN], and the x panel all-gathered over the whole mesh
    (the process group) every iteration, the 1-D layout's cost in CG."""
    n_dev = SH.mesh_size(mesh)
    panel_n = m_rows // n_dev
    blocks = _meta(panel_n // BM, K_1D, BM, BN)
    cols = _meta(panel_n // BM, K_1D, dtype=torch.int32)

    def run():
        x = _meta(panel_n)
        for _ in range(iters):
            xs = _meta(panel_n * n_dev)
            dist.all_gather_into_tensor(xs, x)
            y = ref.spmv_bell(blocks, cols, xs.reshape(-1, BN, 1))
            x = y.reshape(-1)[:panel_n]
        return x
    return run


def lower_2d(mesh, m_rows: int = M_ROWS, iters: int = ITERS):
    """The 2-D layout on this rank, as a thunk: rows over "data", columns
    over "model" (blocks [nbr, max(K_1D / model, 2), BM, BN]); each
    iteration all-reduces the partial y over "model" and all-gathers the
    next x segment over "data"."""
    sizes = SH.axis_sizes(mesh)
    d, m = sizes["data"], sizes["model"]
    seg_n = m_rows // m
    k2 = max(K_1D // m, 2)
    blocks = _meta(m_rows // d // BM, k2, BM, BN)
    cols = _meta(m_rows // d // BM, k2, dtype=torch.int32)
    part = seg_n // d if seg_n // d else seg_n

    def run():
        x = _meta(seg_n)
        for _ in range(iters):
            y = ref.spmv_bell(blocks, cols, x.reshape(-1, BN, 1))
            y = SH.all_reduce(y.reshape(-1), ("model",), mesh)
            x_next = _meta(part * d)
            dist.all_gather_into_tensor(x_next, y[:part].contiguous(),
                                        group=mesh.get_group("data"))
            x = x_next[:seg_n]
        return x
    return run


def lower_halo(mesh, halo: int = 128, m_rows: int = M_ROWS,
               iters: int = ITERS):
    """The RCM-enabled halo exchange on this rank, as a thunk: a banded
    matrix (bandwidth <= halo after reordering; 2 blocks a block row) in
    row panels, and two ring permutes of `halo` values each way instead of
    the all-gather (`dist.batch_isend_irecv` over the process group)."""
    n_dev = SH.mesh_size(mesh)
    rank = dist.get_rank()
    panel_n = m_rows // n_dev
    blocks = _meta(panel_n // BM, 2, BM, BN)
    cols = _meta(panel_n // BM, 2, dtype=torch.int32)
    nxt, prv = (rank + 1) % n_dev, (rank - 1) % n_dev

    def run():
        x = _meta(panel_n)
        for _ in range(iters):
            lh, rh = _meta(halo), _meta(halo)
            ops = [dist.P2POp(dist.isend, x[-halo:].contiguous(), nxt),
                   dist.P2POp(dist.irecv, lh, prv),
                   dist.P2POp(dist.isend, x[:halo].contiguous(), prv),
                   dist.P2POp(dist.irecv, rh, nxt)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            xw = torch.cat([lh, x, rh])
            y = ref.spmv_bell(blocks, cols, xw.reshape(-1, BN, 1))
            x = y.reshape(-1)[:panel_n]
        return x
    return run


def run_multi_pod(multi_pod: bool = False, m_rows: int = M_ROWS,
                  iters: int = ITERS, out_dir=None) -> dict:
    """The three layouts' flops and collectives per rank on the
    production mesh, in a fake process group of its size; prints one line
    a layout and the wire ratios and writes spmv_distributed.json under
    `out_dir` (None: the drivers' results directory)."""
    from ..experiments.store import results_dir
    from . import hlo_cost
    from .mesh import fake_group, make_production_mesh

    out = {}
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        for name, lower in [("1d", lower_1d), ("2d", lower_2d),
                            ("halo", lower_halo)]:
            walk = hlo_cost.analyze(lower(mesh, m_rows=m_rows, iters=iters))
            out[name] = {"flops": walk["flops"],
                         "collectives": walk["collectives"]}
            print(f"[spmv-{name}] flops/dev={walk['flops']:.3e} "
                  f"coll wire/dev={walk['collectives'].get('wire', 0):.3e} "
                  f"B (per {iters} SpMVs)", flush=True)
    wire = {k: out[k]["collectives"].get("wire", 0) for k in out}
    r = wire["1d"] / max(wire["2d"], 1)
    rh = wire["1d"] / max(wire["halo"], 1)
    out["wire_ratio_1d_over_2d"] = r
    out["wire_ratio_1d_over_halo"] = rh
    print(f"[spmv] 1d/2d wire ratio: {r:.1f}x; 1d/halo: {rh:.0f}x")
    out_dir = out_dir or results_dir()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spmv_distributed.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def structure_twin(mat: CSRMatrix, seed: int = 0) -> CSRMatrix:
    """`mat` with values U(-1, 1) drawn from `seed` in place of its own.

    The generators add m·I to every matrix, so at 1,048,576 rows the
    diagonal term of each row is about 1e5 times the sum of its other
    terms. An error divided by such a result's largest entry hides a
    kernel that drops or misplaces every off-diagonal term. On the twin
    (the same structure with these values) each stored term counts."""
    vals = np.random.default_rng(seed).uniform(-1.0, 1.0, mat.nnz)
    return dataclasses.replace(mat, vals=vals)


def verify(op, mat: CSRMatrix, k: int = 1, dtype=None, device=None,
           tol: float = 1e-4, seed: int = 0) -> float:
    """Max error of `op` (in `mat`'s index space) against the float64
    numpy oracle, relative to the oracle's largest entry. Raises above
    `tol`. Check `mat`'s structure twin as well where one term of each
    row dominates it (see `structure_twin`)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(mat.n if k <= 1 else (mat.n, k))
    xt = torch.as_tensor(x).to(dev, torch_dtype(dtype))
    if k <= 1:
        got, want = op(xt), mat.spmv(x)
    else:
        got = op.matmul(xt)
        want = np.stack([mat.spmv(x[:, j]) for j in range(k)], axis=1)
    got = got.double().cpu().numpy()
    err = float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-9)
    if not err <= tol:
        raise AssertionError(f"verify failed: rel_err={err:.3e} > {tol:.1e} "
                             f"({mat.m}x{mat.n} matrix, k={k})")
    return err


def measure(op, nnz: int, n: int, k: int = 1, dtype=None, device=None,
            iters: int = 20, warmup: int = 3, cg_iters: int = 10,
            seed: int = 0) -> dict:
    """IOS (and for k == 1 YAX and instrumented CG) medians of a bare
    operator, in its own index space."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    ms = float(np.median(ios.run_ios_batched(op, n, k, iters=iters,
                                             warmup=warmup, dtype=dt,
                                             seed=seed, device=dev)))
    rec = {"ios_ms": ms,
           "ios_gflops": float(ios.gflops(nnz * k, np.array([ms]))[0])}
    if k <= 1:
        rng = np.random.default_rng(seed)
        x0 = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
        yax = float(np.median(ios.run_yax(op, x0, iters=iters,
                                          warmup=warmup)))
        cgm = float(np.median(cg.cg_measured(op, x0, iters=cg_iters)))
        rec.update(yax_ms=yax, cg_ms=cgm,
                   yax_gflops=float(ios.gflops(nnz, np.array([yax]))[0]),
                   cg_gflops=float(ios.gflops(nnz, np.array([cgm]))[0]))
    return rec


def run_cell(mat: CSRMatrix, scheme: str = "baseline", engine: str = "auto",
             k: int = 1, iters: int = 20, cg_iters: int = 10, dtype=None,
             device=None, seed: int = 0, tol: float = 1e-4) -> dict:
    """plan → build → verify → measure for one (matrix, scheme, engine, k)
    cell of a matrix in memory, with no store of records; returns the
    record, the operator and the plan's reordered matrix.

    Verification checks the cell's operator and, built under the same
    plan, the operator of its structure twin (`structure_twin`), which no
    dominant diagonal can hide a wrong term in."""
    if k < 1:
        raise ValueError(f"batch width must be >= 1, got {k}")
    dev = resolve_device(device)
    before = dict(LAUNCHES)
    pl = plan(SpmvProblem(mat, k=k, dtype=dtype, hints={"seed": seed}),
              reorder=scheme, engine=engine, device=dev)
    op = pl.build(device=dev)
    rmat = pl.reordered_matrix()
    rec = {
        "device": device_kind(dev), "m": int(mat.m), "n": int(mat.n),
        "nnz": int(mat.nnz), "k": int(k), "scheme": scheme,
        "resolved_scheme": pl.scheme, "engine": pl.tune.engine,
        "plan_label": pl.label(), "reorder_ms": pl.reorder_ms,
        "tune_ms": pl.tune_ms, "plan_ms": pl.plan_ms,
        "plan_store_hit": bool(pl.cache_hit),
        "build_ms": op.build_info["build_ms"],
        "verify_rel_err": verify(op, mat, k, dtype, dev, tol, seed),
    }
    twin = structure_twin(mat, seed)
    twin_op = pl.build(device=dev, values=twin.vals)
    rec["verify_twin_rel_err"] = verify(twin_op, twin, k, dtype, dev, tol,
                                        seed)
    del twin_op
    rec.update(measure(op.unwrap(), rmat.nnz, rmat.n, k, dtype, dev,
                       iters=iters, cg_iters=cg_iters, seed=seed))
    rec["launches"] = launches_since(before)
    return rec, op, rmat


def _fname(name: str) -> str:
    """Filesystem-safe matrix tag: corpus://group/name -> corpus_group_name
    (corpus names carry URL-ish separators that would split the path)."""
    import re

    return re.sub(r"[:/]+", "_", name).strip("_")


def run_single(matrix: str, scheme: str = "baseline", engine: str = "auto",
               k: int = 1, iters: int = 12, device=None, probe=False,
               use_store: bool = True, write_results: bool = True) -> dict:
    """Single-device tuned SpMV/SpMM benchmark for one (matrix, scheme)
    cell, printed as one line and one JSON record.

    One one-cell "spmv" ExperimentSpec through the Runner, measured into
    the figure drivers' result store (the store under results_dir()):
    the first invocation pays reorder + tune + format conversion (the
    plan store persists those) and the measurement itself, verified on
    the matrix and its structure twin; a repeat invocation is served
    entirely from the result store (`store_hit=True`, no new
    measurement). use_store=False (`--fresh`) deletes the cell's record
    first, so it measures again. Plan time and run time are reported
    apart (paper §3 methodology).

    scheme may be "auto" (the planner selects scheme and engine jointly;
    the choice is `resolved_scheme`); k > 1 (--spmm) times the k-RHS
    SpMM `op.matmul(X[n, k])` and reports the per-vector time; probe is
    plan()'s (False, True, "learned", "exhaustive"). The record has the
    JAX package's keys plus `verify_twin_rel_err` and `launches`, and is
    written to spmv_single_<matrix>_<scheme>[_k<k>].json under the
    drivers' results directory when write_results is set."""
    from ..experiments import ExperimentSpec, MeasurePolicy, Runner
    from ..experiments.store import ResultStore, result_path, results_dir

    if k < 1:
        raise ValueError(f"--spmm batch width must be >= 1, got {k}")
    spec = ExperimentSpec(
        name="spmv_single", matrices=(matrix,), schemes=(scheme,),
        engines=(engine,), ks=(k,),
        policy=MeasurePolicy(iters=iters, probe=probe, verify=True,
                             with_yax=False, with_parallel=False,
                             with_metrics=False))
    store = ResultStore(results_dir=results_dir())
    runner = Runner(spec, store=store, verbose=False, device=device)
    if not use_store:                       # --fresh: force a re-measure
        store.delete(spec.cells(device=device_kind(runner.device))[0].key())
    cr = runner.run().records[0]
    rec = {
        "matrix": matrix,
        "scheme": scheme,
        "resolved_scheme": cr["resolved_scheme"],
        "engine": cr["engine"],
        "plan_label": cr["plan_label"],
        "cache_hit": cr["op_cache_hit"],
        "store_hit": cr["store_reused"],
        "cell_key": cr["cell_key"],
        "k": k,
        "reorder_ms": cr["reorder_ms"],
        "tune_ms": cr["tune_ms"],
        "build_ms": cr["format_build_ms"],
        "load_ms": cr["op_load_ms"],
        "spmv_ios_ms": cr["spmm_ms"],
        "per_vector_ms": cr["per_vector_ms"],
        "spmv_ios_gflops": cr.get("spmm_gflops", cr.get("seq_ios_gflops")),
        "verify_twin_rel_err": cr["verify_twin_rel_err"],
        "launches": cr["launches"],
    }
    tag = "spmm" if k > 1 else "spmv"
    print(f"[{tag}-single] {matrix}/{scheme}->{rec['resolved_scheme']} "
          f"engine={rec['engine']} label={rec['plan_label']} k={k} "
          f"store_hit={rec['store_hit']} cache_hit={rec['cache_hit']} "
          f"plan_ms={rec['tune_ms'] + rec['build_ms'] + rec['load_ms']:.1f} "
          f"{tag}_ms={rec['spmv_ios_ms']:.4f} "
          f"per_vec_ms={rec['per_vector_ms']:.4f} "
          f"gflops={rec['spmv_ios_gflops']:.2f} probe={probe} "
          f"verify={cr['verify_rel_err']:.2e} "
          f"verify_twin={rec['verify_twin_rel_err']:.2e} "
          f"launches={rec['launches']} device={cr['device']}", flush=True)
    if write_results:
        suffix = f"_k{k}" if k > 1 else ""      # SpMM never clobbers SpMV
        path = result_path(
            f"spmv_single_{_fname(matrix)}_{scheme}{suffix}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


def run_serve_sim(matrices=("smoke_banded", "smoke_powerlaw", "smoke_rmat"),
                  requests: int = 48, max_batch: int = 8,
                  window_ms: float = 20.0, engine: str = "auto",
                  reorder: str = "baseline", seed: int = 0,
                  device=None) -> dict:
    """Serving simulation: a burst of mixed (matrix, x) requests through the
    micro-batching SpmvService. Verifies every response against the numpy
    oracle and reports coalescing stats and the kernel launches.

    reorder != "baseline" exercises the permutation-carrying operators:
    the service reorders internally for locality while requests and
    responses stay in the ORIGINAL index space (the oracle check still
    compares against the unreordered matrix)."""
    from ..matrices import suite
    from ..serving.spmv_service import SpmvService

    mats = {name: suite.get(name) for name in matrices}
    rng = np.random.default_rng(seed)
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    with SpmvService(engine=engine, reorder=reorder, max_batch=max_batch,
                     window_ms=window_ms, device=device) as svc:
        for name, mat in mats.items():
            svc.register(name, mat)
        pending = []
        for _ in range(requests):
            name = list(matrices)[rng.integers(len(matrices))]
            x = rng.standard_normal(mats[name].n)
            pending.append((name, x, svc.submit(name, x)))
        svc.flush()
        stats = svc.stats()
        max_rel_err = 0.0
        for name, x, fut in pending:
            want = mats[name].spmv(x)
            got = np.asarray(fut.result(timeout=10))
            scale = float(np.abs(want).max()) + 1e-9
            max_rel_err = max(max_rel_err,
                              float(np.abs(got - want).max()) / scale)
    wall_ms = (time.perf_counter() - t0) * 1e3
    rec = {
        "device": device_kind(svc.device),
        "matrices": list(matrices),
        "reorder": reorder,
        "requests": requests,
        "max_batch": max_batch,
        "window_ms": window_ms,
        "wall_ms": wall_ms,
        "batches": stats["batches"],
        "avg_batch": stats["avg_batch"],
        "batch_size_max": stats["batch_size_max"],
        "coalesce_ratio": stats["coalesce_ratio"],
        "avg_wait_ms": stats["avg_wait_ms"],
        "p50_ms": stats["slo"]["p50_ms"],
        "p95_ms": stats["slo"]["p95_ms"],
        "p99_ms": stats["slo"]["p99_ms"],
        "throughput_rps": stats["slo"]["throughput_rps"],
        "wakeups": stats["wakeups"],
        "max_rel_err": max_rel_err,
        "launches": launches_since(before),
        "ok": max_rel_err < 1e-4,
    }
    print(f"[serve-sim] {requests} requests over {len(matrices)} matrices -> "
          f"{rec['batches']} SpMM dispatches (avg batch "
          f"{rec['avg_batch']:.1f}, max {rec['batch_size_max']}), "
          f"max_rel_err={max_rel_err:.2e} launches={rec['launches']}",
          flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def run_serve_traffic(matrix: str = "smoke_powerlaw",
                      arrival: str = "poisson", rate_rps: float = 500.0,
                      requests: int = 200, n_keys: int = 4,
                      zipf_s: float = 1.1, update_frac: float = 0.1,
                      structure_frac: float = 0.0,
                      budget_mb: float = 0.0, max_batch: int = 8,
                      window_ms: float = 2.0, max_queue: int = 32,
                      overload: str = "reject", engine: str = "auto",
                      reorder: str = "baseline", devices: int = 1,
                      layout: str = "1d_rows", meshes: int = 2,
                      placement: str = "bin_pack", seed: int = 0,
                      device=None) -> dict:
    """Open-loop traffic run against the hardened service (one scenario).
    The matrix is registered under n_keys service keys with Zipf-skewed
    traffic; a budget_mb > 0 memory budget makes the operator LRU
    (eviction + zero-re-tune plan-store reload) part of the scenario,
    update_frac > 0 mixes in no-replan value swaps, structure_frac > 0
    mixes in StructureDelta background replans. devices > 1 serves the
    keys SHARDED from a RoutedSpmvService fleet (`meshes` meshes of
    `devices` devices each, keys placed by `placement`; budget_mb then
    bounds every DEVICE, not the fleet), rolled up as the JAX package
    does: the worst mesh's percentiles, summed builds and reloads.
    Reports outcome counts, SLO percentiles, the kernel launches and the
    hardening invariants (`ok` = every future — requests and replans —
    resolved, none failed, no update raised, budget respected, counters
    balance; for a fleet also every device within its budget and every
    mesh's high-water mark within its own)."""
    from ..matrices import suite
    from ..serving import traffic
    from ..serving.spmv_service import SpmvService

    mat = suite.get(matrix)
    pattern = traffic.TrafficPattern(
        arrival=arrival, rate_rps=rate_rps, requests=requests,
        n_keys=n_keys, zipf_s=zipf_s, update_frac=update_frac,
        structure_frac=structure_frac, seed=seed)
    budget = None if budget_mb <= 0 else int(budget_mb * (1 << 20))
    keys = [f"{matrix}#{i}" for i in range(n_keys)]
    routed = devices > 1
    kw = dict(engine=engine, reorder=reorder, max_batch=max_batch,
              window_ms=window_ms, max_queue=max_queue, overload=overload,
              device=device)
    if routed:
        from ..core.spmv.topology import Topology
        from ..router import MeshSpec, RoutedSpmvService

        fleet = [MeshSpec(f"mesh{i}",
                          Topology(devices=devices, layout=layout),
                          budget_per_device=budget)
                 for i in range(meshes)]
        svc = RoutedSpmvService(fleet, policy=placement, **kw)
    else:
        svc = SpmvService(memory_budget_bytes=budget, **kw)
    before = dict(LAUNCHES)
    with svc:
        for k in keys:
            svc.register(k, mat)
        summary = traffic.run_open_loop(svc, {k: mat for k in keys},
                                        pattern)
        svc.flush()
        stats = svc.stats()
    if routed:
        # fleet rollup: worst-mesh SLO (over meshes that answered),
        # summed build/reload counters, the largest high-water mark
        per = [m["service"] for m in stats["per_mesh"].values()]
        served = [s for s in per if s["slo"]["latency_samples"]] or per
        slo = {k: max(s["slo"][k] for s in served)
               for k in ("p50_ms", "p95_ms", "p99_ms", "shed_rate",
                         "eviction_rate")}
        coalesce = max(s["coalesce_ratio"] for s in served)
        op_builds = sum(s["op_builds"] for s in per)
        op_reloads = sum(s["op_reloads"] for s in per)
        resident_max = max(s["resident_bytes_max"] for s in per)
        high_water_ok = all(s["memory_budget_bytes"] is None
                            or s["resident_bytes_max"]
                            <= s["memory_budget_bytes"] for s in per)
    else:
        slo = stats["slo"]
        coalesce = stats["coalesce_ratio"]
        op_builds = stats["op_builds"]
        op_reloads = stats["op_reloads"]
        resident_max = stats["resident_bytes_max"]
        high_water_ok = True
    balanced = (stats["requests"] == stats["results"] + stats["sheds"]
                + stats["errors"] and stats["pending"] == 0)
    rec = {
        "device": device_kind(svc.device),
        "matrix": matrix, "n_keys": n_keys, "arrival": arrival,
        "rate_rps": rate_rps, "requests": requests, "zipf_s": zipf_s,
        "update_frac": update_frac, "structure_frac": structure_frac,
        "overload": overload,
        "memory_budget_bytes": budget or 0,
        "offered": summary["offered"], "ok_count": summary["ok"],
        "shed": summary["shed"], "rejected": summary["rejected"],
        "errors": summary["errors"], "unresolved": summary["unresolved"],
        "updates": summary["updates"],
        "update_errors": summary["update_errors"],
        "structure_updates": summary["structure_updates"],
        "structure_errors": summary["structure_errors"],
        "replans_landed": summary["replans_landed"],
        "replan_errors": summary["replan_errors"],
        "replan_unresolved": summary["replan_unresolved"],
        "retry_after_positive": summary["retry_after_positive"],
        "offered_rps": summary["offered_rps"],
        "achieved_rps": summary["achieved_rps"],
        "wall_s": summary["wall_s"],
        "schedule_s": summary["schedule_s"],
        "submit_s": summary["submit_s"], "drain_s": summary["drain_s"],
        "p50_ms": slo["p50_ms"], "p95_ms": slo["p95_ms"],
        "p99_ms": slo["p99_ms"], "shed_rate": slo["shed_rate"],
        "eviction_rate": slo["eviction_rate"],
        "coalesce_ratio": coalesce,
        "op_builds": op_builds, "op_reloads": op_reloads,
        "evictions": stats["evictions"],
        "value_swaps": stats["value_swaps"],
        "resident_bytes_max": resident_max,
        "budget_ok": summary["budget_ok"] and high_water_ok,
        "counters_balanced": balanced,
        "launches": launches_since(before),
    }
    if routed:
        rec.update({
            "devices": devices, "layout": layout, "meshes": meshes,
            "placement": placement, "replans": stats["replans"],
            "per_device_ok": bool(stats["per_device_ok"]),
            "assignments": dict(stats["routing"]["assignments"]),
        })
    rec["ok"] = (summary["unresolved"] == 0
                 and summary["replan_unresolved"] == 0
                 and summary["errors"] == 0 and summary["replan_errors"] == 0
                 and summary["update_errors"] == 0
                 and summary["structure_errors"] == 0
                 and rec["budget_ok"] and rec.get("per_device_ok", True)
                 and balanced)
    fleet_tag = (f" [{meshes}x{devices}dev {layout} {placement}]"
                 if routed else "")
    print(f"[serve-traffic] {matrix} x{n_keys} keys {arrival}@"
          f"{rate_rps:g}rps {overload}{fleet_tag}: ok={rec['ok_count']} "
          f"shed={rec['shed']} rejected={rec['rejected']} "
          f"errors={rec['errors']} unresolved={rec['unresolved']} | "
          f"p50={rec['p50_ms']:.2f}ms p99={rec['p99_ms']:.2f}ms "
          f"coalesce={rec['coalesce_ratio']:.2f} "
          f"evictions={rec['evictions']} reloads={rec['op_reloads']} "
          f"swaps={rec['value_swaps']} "
          f"replans={rec['replans_landed']} budget_ok={rec['budget_ok']} "
          f"launches={rec['launches']}", flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def run_parallel(matrix: str, scheme: str = "baseline", engine: str = "auto",
                 devices: int = 8, layout: str = "1d_rows",
                 partition: str = "nnz_balanced", iters: int = 6, k: int = 1,
                 device=None, use_store: bool = True) -> dict:
    """One (matrix, scheme, topology) cell through the Runner ("parallel"
    kind), printed as one line and one JSON record. use_store=False
    (`--fresh`) deletes the cell's stored record first, so it measures
    again."""
    from ..experiments import (ExperimentSpec, MeasurePolicy, ResultStore,
                               Runner)
    from ..experiments.cells import parallel_variant

    if devices < 2:
        raise ValueError(f"--devices must be >= 2 in parallel mode, "
                         f"got {devices}")
    spec = ExperimentSpec(
        name="spmv_parallel_single", matrices=(matrix,), schemes=(scheme,),
        engines=(engine,), ps=(devices,), ks=(k,), kind="parallel",
        variants=(parallel_variant(layout, partition),),
        policy=MeasurePolicy(iters=iters, verify=True, with_yax=False,
                             with_parallel=False, with_metrics=False))
    store = ResultStore()
    runner = Runner(spec, store=store, verbose=False, device=device)
    if not use_store:
        store.delete(spec.cells(device=device_kind(runner.device))[0].key())
    rep = runner.run()
    if rep.failures:
        raise RuntimeError(f"parallel cell failed: "
                           f"{rep.failures[0]['error']}")
    cr = rep.records[0]
    rec = {
        "matrix": matrix, "scheme": scheme,
        "resolved_scheme": cr["resolved_scheme"],
        "engine": cr["engine"], "plan_label": cr["plan_label"],
        "devices": devices, "layout": layout,
        "partitioner": cr["partitioner"],
        "store_hit": cr["store_reused"], "cell_key": cr["cell_key"],
        "comm_schedule": cr["comm_schedule"],
        "comm_bytes_per_spmv": cr["comm_bytes_per_spmv"],
        "li": cr["li"], "cut_volume": cr["cut_volume"],
        "halo_width": cr["halo_width"],
        "reorder_ms": cr["reorder_ms"], "tune_ms": cr["tune_ms"],
        "plan_store_hit": cr["plan_store_hit"],
        "modelled_par_ms": cr["modelled_par_ms"],
        "gflops": cr["gflops"],
        "verify_rel_err": cr["verify_rel_err"],
        "verify_twin_rel_err": cr["verify_twin_rel_err"],
        "simulated": cr["simulated"], "launches": cr["launches"],
        "device": device_kind(runner.device),
    }
    print(f"[spmv-parallel] {matrix}/{scheme} {layout} p={devices} "
          f"partition={rec['partitioner']} engine={rec['engine']} "
          f"sched={rec['comm_schedule']} "
          f"comm={rec['comm_bytes_per_spmv']:.0f}B li={rec['li']:.3f} "
          f"par_ms={rec['modelled_par_ms']:.3f} "
          f"store_hit={rec['store_hit']} sim={rec['simulated']} "
          f"err={rec['verify_rel_err']:.2e} "
          f"twin_err={rec['verify_twin_rel_err']:.2e}", flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix",
                    help="suite matrix name (repro_torch.matrices.suite)")
    ap.add_argument("--scheme", default="baseline")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--probe", action="store_true",
                    help="empirically probe top tuner candidates")
    ap.add_argument("--learned", action="store_true",
                    help="probe only the TuneAdvisor shortlist mined from "
                         "prior campaign cells (plan(probe='learned'))")
    ap.add_argument("--spmm", type=int, default=1, metavar="K",
                    help="batch width: time K-RHS SpMM instead of SpMV")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--fresh", action="store_true",
                    help="delete the cell's stored record first, so it "
                         "measures again")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    ap.add_argument("--serve-sim", action="store_true",
                    help="micro-batching service simulation over smoke "
                         "matrices")
    ap.add_argument("--serve-traffic", action="store_true",
                    help="open-loop traffic run against the service "
                         "(arrivals, Zipf keys, budgets, shedding)")
    ap.add_argument("--serve-reorder", default="baseline",
                    help="reordering scheme the service applies internally "
                         "(requests stay in the original index space)")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=20.0)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "uniform", "bursty"])
    ap.add_argument("--rate", type=float, default=500.0,
                    help="mean offered arrival rate (requests/s)")
    ap.add_argument("--keys", type=int, default=4,
                    help="distinct service keys (Zipf-skewed traffic)")
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--update-frac", type=float, default=0.1,
                    help="fraction of arrivals that are value updates")
    ap.add_argument("--structure-frac", type=float, default=0.0,
                    help="fraction of arrivals that are StructureDelta "
                         "background replans")
    ap.add_argument("--meshes", type=int, default=2,
                    help="fleet size for routed --serve-traffic "
                         "(--devices > 1: meshes x devices)")
    ap.add_argument("--placement", default="bin_pack",
                    help="router placement policy for routed "
                         "--serve-traffic (bin_pack, nnz_balance, "
                         "comm_aware, or any @register_placement name)")
    ap.add_argument("--budget-mb", type=float, default=0.0,
                    help="operator memory budget in MiB (0 = unbudgeted; "
                         "per device with --devices > 1)")
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--overload", default="reject",
                    choices=["reject", "shed-oldest", "degrade-to-k1"])
    ap.add_argument("--devices", type=int, default=1,
                    help="with --matrix: one sharded cell over a Topology "
                         "of N devices (simulated on fewer cards); with "
                         "--serve-traffic: a routed fleet of --meshes "
                         "meshes of N devices")
    ap.add_argument("--layout", default=None,
                    choices=["1d_rows", "2d_panels"],
                    help="sharded layout (with --devices; default 1d_rows)")
    ap.add_argument("--partition", default=None,
                    help="partitioner name or 'auto' (with --devices; "
                         "default nnz_balanced)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with no --matrix: the distributed-SpMV dry-run "
                         "on the (2, 16, 16) mesh, not (16, 16)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="record the run's spans (repro_torch.obs): "
                         ".jsonl -> raw event log, anything else -> "
                         "Chrome-trace JSON (load in ui.perfetto.dev)")
    args = ap.parse_args(argv)
    from .. import obs

    with obs.trace_to(args.trace):
        _dispatch(ap, args)


def _dispatch(ap, args):
    if args.probe and args.learned:
        ap.error("--probe and --learned are mutually exclusive probe modes")
    probe = "learned" if args.learned else args.probe
    if args.serve_traffic:
        if args.spmm != 1 or probe:
            ap.error("--serve-traffic does not combine with "
                     "--spmm/--probe/--learned")
        # --devices > 1 serves routed SHARDED keys from a
        # RoutedSpmvService fleet (--meshes x --devices, --layout,
        # --placement); budget_mb then bounds every device
        rec = run_serve_traffic(
            matrix=args.matrix or "smoke_powerlaw", arrival=args.arrival,
            rate_rps=args.rate, requests=args.requests, n_keys=args.keys,
            zipf_s=args.zipf, update_frac=args.update_frac,
            structure_frac=args.structure_frac, budget_mb=args.budget_mb,
            max_batch=args.max_batch, window_ms=args.window_ms,
            max_queue=args.max_queue, overload=args.overload,
            engine=args.engine, reorder=args.serve_reorder,
            devices=args.devices, layout=args.layout or "1d_rows",
            meshes=args.meshes, placement=args.placement,
            device=args.device)
        if not rec["ok"]:
            raise SystemExit(
                f"serve-traffic invariants FAILED: "
                f"unresolved={rec['unresolved']} "
                f"replan_unresolved={rec['replan_unresolved']} "
                f"errors={rec['errors']} "
                f"replan_errors={rec['replan_errors']} "
                f"update_errors={rec['update_errors']} "
                f"structure_errors={rec['structure_errors']} "
                f"budget_ok={rec['budget_ok']} "
                f"per_device_ok={rec.get('per_device_ok', True)} "
                f"counters_balanced={rec['counters_balanced']}")
        return
    if args.serve_sim:
        if args.devices > 1:
            ap.error("--serve-sim serves one device; for a routed fleet "
                     "use --serve-traffic --devices N --meshes M")
        if args.matrix or args.spmm != 1 or probe:
            ap.error("--serve-sim does not combine with "
                     "--matrix/--spmm/--probe/--learned")
        rec = run_serve_sim(requests=args.requests, max_batch=args.max_batch,
                            window_ms=args.window_ms, engine=args.engine,
                            reorder=args.serve_reorder, device=args.device)
        if not rec["ok"]:
            raise SystemExit(f"serve-sim verification FAILED: max_rel_err="
                             f"{rec['max_rel_err']:.2e}")
        return
    if not args.matrix:
        if args.spmm != 1 or probe or args.devices > 1:
            ap.error("--spmm/--probe/--learned/--devices require --matrix "
                     "(single-cell mode)")
        run_multi_pod(multi_pod=args.multi_pod)
        return
    if args.multi_pod:
        ap.error("--multi-pod is the dry-run's (no --matrix)")
    if args.devices <= 1 and (args.layout or args.partition):
        ap.error("--layout/--partition require --devices > 1 "
                 "(sharded single-cell mode)")
    if args.devices > 1:
        if probe:
            ap.error("--devices does not combine with --probe/--learned "
                     "(sharded plans are model-based)")
        run_parallel(args.matrix, args.scheme, args.engine,
                     devices=args.devices, layout=args.layout or "1d_rows",
                     partition=args.partition or "nnz_balanced",
                     iters=args.iters, k=args.spmm, device=args.device,
                     use_store=not args.fresh)
        return
    run_single(args.matrix, args.scheme, args.engine, k=args.spmm,
               iters=args.iters, device=args.device, probe=probe,
               use_store=not args.fresh)


if __name__ == "__main__":
    main()
