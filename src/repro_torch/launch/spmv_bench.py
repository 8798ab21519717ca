"""One paper cell on the card: plan → build → verify → IOS/YAX → CG.

    python -m repro_torch.launch.spmv_bench --matrix fig1_shuffled \\
        --scheme rcm --engine auto [--spmm K] [--iters N] [--device cuda]
    python -m repro_torch.launch.spmv_bench --campaign smoke [--device cpu]

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
from ..kernels import LAUNCHES


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
    rec["launches"] = {name: LAUNCHES[name] - before[name]
                       for name in LAUNCHES}
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
    args = ap.parse_args(argv)
    if args.campaign:
        raise SystemExit(1 if campaign_smoke(args.device) else 0)
    if not args.matrix:
        ap.error("give --matrix or --campaign")
    run_single(args.matrix, args.scheme, args.engine, k=args.spmm,
               iters=args.iters, device=args.device)


if __name__ == "__main__":
    main()
