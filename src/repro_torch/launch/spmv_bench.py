"""One paper cell on the card: plan → build → verify → IOS/YAX → CG.

    python -m repro_torch.launch.spmv_bench --matrix fig1_shuffled \\
        --scheme rcm --engine auto [--spmm K] [--iters N] [--device cuda]
    python -m repro_torch.launch.spmv_bench --campaign smoke [--device cpu]
    python -m repro_torch.launch.spmv_bench --serve-sim \
        --serve-reorder rcm [--device cpu]
    python -m repro_torch.launch.spmv_bench --serve-traffic \
        --matrix smoke_powerlaw --rate 500 --keys 4 [--budget-mb M]

The port's counterpart of the JAX package's `run_single`: one matrix, one
reordering scheme ("auto" searches), one engine ("auto" tunes). It prints
the resolved scheme and engine, the host plan and build times, the IOS
median and GFLOP/s (2 flops per nonzero per right-hand side), and the
launches of each hand-written kernel during the cell. Verification is
against the numpy float64 oracle `CSRMatrix.spmv` in the original index
space, for the cell's operator and for its structure twin (the same
structure with values U(-1, 1)). A single cell measures on every
invocation; its plan and operator come from the plan store when they are
there.

`--campaign smoke` is the port's counterpart of the JAX package's
`benchmarks/run.py --smoke`: the smoke matrices x {baseline, rcm} x the
auto engine through the experiments Runner (verify on, probe on), then the
same campaign again, which must be served entirely from the result store;
it writes the port's bench summary (experiments/report.py SUMMARY_PATH)
and exits nonzero on any failure.

`--serve-sim` sends a burst of requests over the smoke matrices through
the micro-batching SpmvService (serving/spmv_service.py) and checks every
response against the numpy oracle; `--serve-traffic` drives one open-loop
traffic scenario (serving/traffic.py) against it and checks the service's
invariants. Both print one line and one JSON record, as a single cell
does; `--devices > 1` (the router over sharded plans) is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..core.measure import cg, ios
from ..core.sparse.csr import CSRMatrix
from ..core.spmv.plan import SpmvProblem, plan
from ..device import device_kind, resolve_device, torch_dtype
from ..kernels import LAUNCHES, launches_since


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
    cell; returns the record, the operator and the plan's reordered
    matrix.

    Verification checks the cell's operator and, built under the same
    plan, the operator of its structure twin (`structure_twin`), which no
    dominant diagonal can hide a wrong term in."""
    if k < 1:
        raise ValueError(f"batch width must be >= 1, got {k}")
    dev = resolve_device(device)
    before = dict(LAUNCHES)
    pl = plan(SpmvProblem(mat, k=k, dtype=dtype, hints={"seed": seed}),
              reorder=scheme, engine=engine)
    op = pl.build(device=dev)
    rmat = pl.reordered_matrix()
    rec = {
        "device": device_kind(dev), "m": int(mat.m), "n": int(mat.n),
        "nnz": int(mat.nnz), "k": int(k), "scheme": scheme,
        "resolved_scheme": pl.scheme, "engine": pl.tune.engine,
        "plan_label": pl.label(), "reorder_ms": pl.reorder_ms,
        "tune_ms": pl.tune_ms, "plan_ms": pl.plan_ms,
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


def run_single(matrix: str, scheme: str = "baseline", engine: str = "auto",
               k: int = 1, iters: int = 20, device=None) -> dict:
    """One suite matrix through run_cell, printed as one line and one JSON
    record."""
    from ..matrices import suite

    t0 = time.perf_counter()
    mat = suite.get(matrix)
    rec, _, _ = run_cell(mat, scheme, engine, k=k, iters=iters,
                         device=device)
    rec["matrix"] = matrix
    rec["load_s"] = time.perf_counter() - t0
    tag = "spmm" if k > 1 else "spmv"
    print(f"[{tag}-single] {matrix}/{scheme}->{rec['resolved_scheme']} "
          f"engine={rec['engine']} label={rec['plan_label']} k={k} "
          f"plan_ms={rec['plan_ms']:.1f} build_ms={rec['build_ms']:.1f} "
          f"verify={rec['verify_rel_err']:.2e} "
          f"verify_twin={rec['verify_twin_rel_err']:.2e} "
          f"ios_ms={rec['ios_ms']:.4f} gflops={rec['ios_gflops']:.2f} "
          f"launches={rec['launches']} device={rec['device']}", flush=True)
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
                      reorder: str = "baseline", seed: int = 0,
                      device=None) -> dict:
    """Open-loop traffic run against the hardened service (one scenario).
    The matrix is registered under n_keys service keys with Zipf-skewed
    traffic; a budget_mb > 0 memory budget makes the operator LRU
    (eviction + zero-re-tune plan-store reload) part of the scenario,
    update_frac > 0 mixes in no-replan value swaps, structure_frac > 0
    mixes in StructureDelta background replans. Reports outcome counts,
    SLO percentiles, the kernel launches and the hardening invariants
    (`ok` = every future — requests and replans — resolved, none failed,
    no update raised, budget respected, counters balance)."""
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
    before = dict(LAUNCHES)
    with SpmvService(engine=engine, reorder=reorder, max_batch=max_batch,
                     window_ms=window_ms, max_queue=max_queue,
                     memory_budget_bytes=budget, overload=overload,
                     device=device) as svc:
        for k in keys:
            svc.register(k, mat)
        summary = traffic.run_open_loop(svc, {k: mat for k in keys},
                                        pattern)
        svc.flush()
        stats = svc.stats()
    slo = stats["slo"]
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
        "coalesce_ratio": stats["coalesce_ratio"],
        "op_builds": stats["op_builds"], "op_reloads": stats["op_reloads"],
        "evictions": stats["evictions"],
        "value_swaps": stats["value_swaps"],
        "resident_bytes_max": stats["resident_bytes_max"],
        "budget_ok": summary["budget_ok"],
        "counters_balanced": balanced,
        "launches": launches_since(before),
        "ok": (summary["unresolved"] == 0
               and summary["replan_unresolved"] == 0
               and summary["errors"] == 0 and summary["replan_errors"] == 0
               and summary["update_errors"] == 0
               and summary["structure_errors"] == 0
               and summary["budget_ok"] and balanced),
    }
    print(f"[serve-traffic] {matrix} x{n_keys} keys {arrival}@"
          f"{rate_rps:g}rps {overload}: ok={rec['ok_count']} "
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


def smoke_spec(matrices=None):
    from ..experiments import ExperimentSpec, MeasurePolicy
    from ..matrices import suite

    return ExperimentSpec(
        name="smoke_torch", matrices=tuple(matrices or suite.smoke_names()),
        schemes=("baseline", "rcm"), engines=("auto",),
        policy=MeasurePolicy(iters=3, warmup=1, with_yax=False,
                             with_parallel=False, with_metrics=False,
                             verify=True, probe=True))


def campaign_smoke(device=None, matrices=None) -> int:
    """The smoke campaign, then the resume check. Returns the number of
    failures (failed cells, or a second run that measured anything)."""
    from ..experiments import ResultStore, Runner
    from ..experiments.report import SUMMARY_PATH

    spec = smoke_spec(matrices)
    store = ResultStore()
    t0 = time.perf_counter()
    rep = Runner(spec, store=store, verbose=False, on_error="record",
                 device=device).run()
    first_s = time.perf_counter() - t0
    print("matrix,scheme,engine,plan_label,seq_ios_ms,verify_rel_err,"
          "verify_twin_rel_err,store", flush=True)
    for r in rep.records:
        print(f"{r['matrix']},{r['scheme']},{r.get('engine', '?')},"
              f"{r.get('plan_label', '?')},{r.get('seq_ios_ms', -1):.4f},"
              f"{r.get('verify_rel_err', -1):.2e},"
              f"{r.get('verify_twin_rel_err', -1):.2e},"
              f"{'hit' if r['store_reused'] else 'miss+measure'}",
              flush=True)
    failures = len(rep.failures)
    for f in rep.failures:
        print(f"{f['label']}: ERROR {f['error']}\n{f['traceback']}",
              flush=True)
    if not failures:
        t0 = time.perf_counter()
        rep2 = Runner(spec, store=store, verbose=False,
                      device=device).run()
        ncells = len(rep2.records)
        if rep2.measured != 0 or rep2.reused != ncells:
            print(f"RESUME FAILED: second run measured={rep2.measured} "
                  f"reused={rep2.reused} (want 0/{ncells})", flush=True)
            failures += 1
        else:
            print(f"# resume: {rep2.reused}/{ncells} cells served from the "
                  f"store ({time.perf_counter() - t0:.2f} s, first run "
                  f"{first_s:.2f} s)", flush=True)
    summary = rep.write_bench_summary()
    print(f"# {SUMMARY_PATH}: geomean={summary['geomean']} "
          f"speedup={summary.get('speedup_vs_baseline', {})}", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix",
                    help="suite matrix name (repro_torch.matrices.suite)")
    ap.add_argument("--campaign", choices=("smoke",),
                    help="run a campaign instead of one cell")
    ap.add_argument("--scheme", default="baseline")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--spmm", type=int, default=1, metavar="K",
                    help="batch width: time K-RHS SpMM instead of SpMV")
    ap.add_argument("--iters", type=int, default=20)
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
    ap.add_argument("--budget-mb", type=float, default=0.0,
                    help="operator memory budget in MiB (0 = unbudgeted)")
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--overload", default="reject",
                    choices=["reject", "shed-oldest", "degrade-to-k1"])
    ap.add_argument("--devices", type=int, default=1,
                    help="> 1 serves sharded keys through the router "
                         "(not ported)")
    args = ap.parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError("not ported: router and sharded plans "
                                  "(ROADMAP queue A item 5)")
    if args.serve_traffic:
        rec = run_serve_traffic(
            matrix=args.matrix or "smoke_powerlaw", arrival=args.arrival,
            rate_rps=args.rate, requests=args.requests, n_keys=args.keys,
            zipf_s=args.zipf, update_frac=args.update_frac,
            structure_frac=args.structure_frac, budget_mb=args.budget_mb,
            max_batch=args.max_batch, window_ms=args.window_ms,
            max_queue=args.max_queue, overload=args.overload,
            engine=args.engine, reorder=args.serve_reorder,
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
                f"counters_balanced={rec['counters_balanced']}")
        return
    if args.serve_sim:
        if args.matrix or args.spmm != 1:
            ap.error("--serve-sim does not combine with --matrix/--spmm")
        rec = run_serve_sim(requests=args.requests, max_batch=args.max_batch,
                            window_ms=args.window_ms, engine=args.engine,
                            reorder=args.serve_reorder, device=args.device)
        if not rec["ok"]:
            raise SystemExit(f"serve-sim verification FAILED: max_rel_err="
                             f"{rec['max_rel_err']:.2e}")
        return
    if args.campaign:
        raise SystemExit(1 if campaign_smoke(args.device) else 0)
    if not args.matrix:
        ap.error("give --matrix or --campaign")
    run_single(args.matrix, args.scheme, args.engine, k=args.spmm,
               iters=args.iters, device=args.device)


if __name__ == "__main__":
    main()
