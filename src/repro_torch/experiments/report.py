"""Report — the typed view over a campaign's measured cells.

Replaces the ad-hoc `grid()`/baseline-index lookups of the legacy
benchmarks: accessors are STRICT (a missing cell or field raises
MissingCellError naming the exact cell, instead of silently yielding the
NaN speedups that used to skew consistency statistics), grids come back
as [scheme, matrix] arrays ready for measure/profiles.py, and the
standard paper statistics (Dolan-Moré profiles, speedup buckets,
pairwise win rates, cross-machine consistency) are one call each.

Amortization accounting (paper §3): `plan_run_split()` spreads each
cell's one-off plan time over the policy's `amortize_iters` SpMV calls;
`break_even()` reports, per (matrix, scheme), how many SpMV calls the
measured run-time saving needs to repay the plan time — the
"is reordering worth it for THIS solve length" number.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterable, Optional

import numpy as np

from ..core.measure import profiles as profile_stats
from .store import result_path

BENCH_SCHEMA_VERSION = 1
# the port's bench summary, under store.results_dir(); the JAX package
# writes its own elsewhere
SUMMARY_NAME = "BENCH_spmv_torch.json"


class MissingCellError(KeyError):
    """A report was asked for a cell (or a field of a cell) that was never
    measured. Carries the exact coordinates so the fix is obvious."""

    def __init__(self, coords: dict, field: Optional[str] = None,
                 hint: str = ""):
        self.coords = dict(coords)
        self.field = field
        what = (f"field {field!r} missing from cell" if field
                else "no measured cell for")
        msg = f"{what} {self.coords}"
        if hint:
            msg += f" ({hint})"
        super().__init__(msg)

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0]


class Report:
    def __init__(self, spec, entries, measured: int = 0, reused: int = 0,
                 failures: Optional[list] = None, store=None):
        self.spec = spec
        self.measured = measured
        self.reused = reused
        self.failures = failures or []
        self.store = store
        self.records = []
        self._buckets: dict = {}      # (matrix, scheme) -> [records]
        for entry in entries:
            cell, rec = entry[0], entry[1]
            merged = dict(rec)
            merged.update({
                "matrix": cell.matrix, "scheme": cell.scheme,
                "profile": cell.profile, "engine_request": cell.engine,
                "dtype": cell.dtype, "p": cell.p, "k": cell.k,
                "variant": cell.variant, "device": cell.device,
                "cell_key": cell.key(),
                # runner provenance (not persisted in the store record):
                # was THIS run's copy served from the store, and how long
                # did the measurement take if not
                "store_reused": bool(entry[2]) if len(entry) > 2 else False,
                "runner_wall_s": float(entry[3]) if len(entry) > 3 else 0.0,
            })
            self.records.append(merged)
            self._buckets.setdefault((cell.matrix, cell.scheme),
                                     []).append(merged)

    # -- cell/value accessors ---------------------------------------------
    def _resolve(self, matrix: str, scheme: str, profile: Optional[str],
                 engine: Optional[str], dtype: Optional[str],
                 p: Optional[int], k: Optional[int],
                 variant: Optional[str]) -> dict:
        """Match on every coordinate the caller pinned; unpinned axes must
        be unambiguous across the report's cells."""
        want = {"matrix": matrix, "scheme": scheme}
        for name, v in (("profile", profile), ("engine_request", engine),
                        ("dtype", dtype), ("p", p), ("k", k),
                        ("variant", variant)):
            if v is not None:
                want[name] = v
        bucket = self._buckets.get((matrix, scheme), ())
        hits = [r for r in bucket
                if all(r[f] == v for f, v in want.items())]
        if len(hits) == 1:
            return hits[0]
        if not hits:
            raise MissingCellError(want, hint=f"campaign {self.spec.name!r} "
                                   f"holds {len(self.records)} cells")
        raise MissingCellError(
            want, hint=f"{len(hits)} cells match — pin more axes "
            f"(profile/engine/k/variant)")

    def cell(self, matrix: str, scheme: str, profile: Optional[str] = None,
             engine: Optional[str] = None, dtype: Optional[str] = None,
             p: Optional[int] = None, k: Optional[int] = None,
             variant: Optional[str] = None) -> dict:
        return self._resolve(matrix, scheme, profile, engine, dtype, p, k,
                             variant)

    def value(self, field: str, matrix: str, scheme: str, **coords) -> float:
        rec = self.cell(matrix, scheme, **coords)
        if field not in rec:
            raise MissingCellError(
                {"matrix": matrix, "scheme": scheme, **coords}, field=field,
                hint="the cell exists but its policy never measured this")
        return rec[field]

    # -- grids -------------------------------------------------------------
    def grid(self, field: str, matrices: Iterable[str],
             schemes: Iterable[str], **coords) -> np.ndarray:
        """[scheme, matrix] array of `field` — STRICT (MissingCellError on
        any absent cell/field; no NaN placeholders)."""
        matrices, schemes = list(matrices), list(schemes)
        out = np.empty((len(schemes), len(matrices)), dtype=np.float64)
        for i, s in enumerate(schemes):
            for j, m in enumerate(matrices):
                out[i, j] = self.value(field, m, s, **coords)
        return out

    def speedup(self, field: str, matrices: Iterable[str],
                schemes: Iterable[str], baseline: str = "baseline",
                **coords) -> np.ndarray:
        """[scheme, matrix] speedup of `field` (higher-is-better) relative
        to the baseline scheme on the same (matrix, machine point)."""
        matrices, schemes = list(matrices), list(schemes)
        g = self.grid(field, matrices, schemes, **coords)
        base = self.grid(field, matrices, [baseline], **coords)[0]
        return g / base

    # -- paper statistics (measure/profiles.py) ---------------------------
    def performance_profile(self, field: str, matrices, schemes,
                            taus: np.ndarray, **coords) -> np.ndarray:
        return profile_stats.performance_profile(
            self.grid(field, matrices, schemes, **coords), np.asarray(taus))

    def speedup_buckets(self, field: str, matrices, schemes,
                        baseline: str = "baseline", **coords) -> np.ndarray:
        return profile_stats.speedup_buckets(
            self.speedup(field, matrices, schemes, baseline, **coords))

    def pairwise_win_rates(self, field: str, matrices, schemes,
                           **coords) -> np.ndarray:
        return profile_stats.pairwise_win_rates(
            self.grid(field, matrices, schemes, **coords))

    def consistency(self, field: str, matrices, scheme: str,
                    machine_profiles: Iterable[str], tau,
                    baseline: str = "baseline", **coords):
        """Cross-machine Consistent% (paper Eq. 1) of one scheme's
        speedups over the given profiles. `tau` may be a scalar
        (returns (consistent, |CCS|)) or a sequence (returns one tuple
        per tau — the [machines, matrices] stack is built once)."""
        sp = np.stack([
            self.speedup(field, matrices, [scheme], baseline,
                         profile=prof, **coords)[0]
            for prof in machine_profiles])
        if np.iterable(tau):
            return [profile_stats.consistency_ratio(sp, t) for t in tau]
        return profile_stats.consistency_ratio(sp, tau)

    # -- amortization accounting (paper §3) --------------------------------
    @staticmethod
    def _plan_ms(rec: dict) -> float:
        """One-off plan-time this run actually paid: reorder excluded (the
        paper never times it), plan-store hits count zero (that is the
        store's purpose)."""
        if rec.get("plan_store_hit") or rec.get("op_cache_hit"):
            return 0.0
        return rec.get("tune_ms", 0.0) + rec.get("format_build_ms", 0.0)

    def plan_run_split(self, field: str = "seq_ios_ms",
                       iters_to_amortize: Optional[int] = None) -> dict:
        """Per-cell plan-time vs run-time split + amortized run time (run
        time with the plan cost spread over `iters_to_amortize` calls —
        default: the spec policy's amortize_iters, a CG-length solve)."""
        iters = (self.spec.policy.amortize_iters
                 if iters_to_amortize is None else iters_to_amortize)
        out = {}
        for rec in self.records:
            if field not in rec:
                continue
            plan_ms, run_ms = self._plan_ms(rec), rec[field]
            out[rec["cell_key"]] = {
                "matrix": rec["matrix"], "scheme": rec["scheme"],
                "profile": rec["profile"],
                "plan_ms": plan_ms, "run_ms": run_ms,
                "tuner_choice": rec.get("tuner_choice",
                                        rec.get("engine", "csr")),
                "op_cache_hit": bool(rec.get("op_cache_hit", False)),
                "plan_over_run": plan_ms / max(run_ms, 1e-9),
                "amortized_ms": run_ms + plan_ms / max(iters, 1),
            }
        return out

    def break_even(self, field: str = "seq_ios_ms",
                   baseline: str = "baseline", **coords) -> list:
        """Per non-baseline cell: SpMV calls needed before the scheme's
        one-off plan time (reorder + tune + convert, as paid this run) is
        repaid by its per-call run-time saving vs the baseline cell at
        the SAME machine point / k / variant. inf when the scheme does
        not beat baseline at all. Returns one dict per cell (full
        coordinates included — a multi-profile campaign yields one entry
        per machine); cells whose baseline was never measured are
        skipped, any other lookup problem propagates."""
        fieldmap = {"engine": "engine_request"}
        out = []
        for rec in self.records:
            if rec["scheme"] == baseline or field not in rec:
                continue
            if any(rec.get(fieldmap.get(f, f)) != v
                   for f, v in coords.items()):
                continue
            try:
                # every axis pinned -> the lookup can miss but never be
                # ambiguous (ambiguity would be a harness bug, not data)
                base = self.value(field, rec["matrix"], baseline,
                                  profile=rec["profile"],
                                  engine=rec["engine_request"],
                                  dtype=rec["dtype"], p=rec["p"],
                                  k=rec["k"], variant=rec["variant"])
            except MissingCellError as e:
                if e.field is not None:
                    raise       # baseline cell exists but wasn't timed
                continue        # baseline cell genuinely absent
            saving = base - rec[field]
            plan_ms = self._plan_ms(rec) + rec.get("reorder_ms", 0.0)
            out.append({
                "matrix": rec["matrix"], "scheme": rec["scheme"],
                "profile": rec["profile"], "k": rec["k"],
                "variant": rec["variant"],
                "saving_ms_per_call": saving,
                "plan_ms": plan_ms,
                "break_even_iters": (plan_ms / saving if saving > 1e-12
                                     else float("inf")),
            })
        return out

    # -- emission ----------------------------------------------------------
    def write_csv(self, path: str, header: list, rows: list) -> None:
        write_csv(path, header, rows)

    def bench_summary(self, field: str = "seq_ios_gflops",
                      baseline: str = "baseline") -> dict:
        """The trajectory summary: per-scheme geomean GFLOPs + speedup over
        baseline, store-reuse counters, and the plan/run amortization
        medians."""
        by_scheme: dict = {}
        for rec in self.records:
            if field in rec:
                by_scheme.setdefault(rec["scheme"], []).append(rec[field])
        geo = {s: round(profile_stats.geomean(np.asarray(v)), 4)
               for s, v in by_scheme.items()}
        summary = {
            "schema": BENCH_SCHEMA_VERSION,
            "campaign": self.spec.name,
            "kind": self.spec.kind,
            "cells": len(self.records),
            "measured": self.measured,
            "reused": self.reused,
            "failures": len(self.failures),
            "field": field,
            "geomean": geo,
        }
        if baseline in geo:
            summary["speedup_vs_baseline"] = {
                s: round(v / geo[baseline], 4) for s, v in geo.items()
                if s != baseline}
        summary["scale"] = self._scale_stamp()
        phases = self._phase_medians()
        if phases:
            summary["phases"] = phases
        split = self.plan_run_split()
        if split:
            vals = list(split.values())
            summary["plan_run"] = {
                "median_plan_ms": round(float(np.median(
                    [v["plan_ms"] for v in vals])), 4),
                "median_run_ms": round(float(np.median(
                    [v["run_ms"] for v in vals])), 4),
                "median_amortized_ms": round(float(np.median(
                    [v["amortized_ms"] for v in vals])), 4),
                "amortize_iters": self.spec.policy.amortize_iters,
            }
        return summary

    REPRESENTATIVE_MIN_M = 100_000    # paper-scale row-count floor

    def _scale_stamp(self) -> dict:
        """Matrix-scale / iters provenance for the summary. `regress.py`
        refuses to compare summaries whose stamps differ, and
        `representative: false` marks smoke-scale numbers (e.g. RCM at
        0.70x on tiny matrices) as non-transferable to paper scale."""
        ms = [int(r["m"]) for r in self.records if "m" in r]
        nnzs = [int(r["nnz"]) for r in self.records if "nnz" in r]
        pol = self.spec.policy
        max_m = max(ms) if ms else 0
        stamp = {
            "matrices": sorted({r["matrix"] for r in self.records}),
            "max_m": max_m,
            "max_nnz": max(nnzs) if nnzs else 0,
            "iters": int(pol.iters),
            "warmup": int(pol.warmup),
            "use_kernel": pol.use_kernel,
            "representative": max_m >= self.REPRESENTATIVE_MIN_M,
        }
        if not stamp["representative"]:
            stamp["note"] = (
                f"smoke-scale measurement (max m={max_m} < "
                f"{self.REPRESENTATIVE_MIN_M}); speedups are NOT "
                f"representative of paper-scale matrices")
        return stamp

    def _phase_medians(self) -> dict:
        """Per-phase plan-time attribution medians (ms) over the cells
        that recorded each phase — the span-backed timing fields."""
        out = {}
        for field, label in (("reorder_ms", "reorder_ms"),
                             ("tune_ms", "tune_ms"),
                             ("format_build_ms", "build_ms"),
                             ("op_load_ms", "load_ms")):
            vals = [r[field] for r in self.records if field in r]
            if vals:
                out[f"median_{label}"] = round(float(np.median(vals)), 4)
        return out

    def write_bench_summary(self, path: Optional[str] = None,
                            field: str = "seq_ios_gflops") -> dict:
        """Write the summary (default: SUMMARY_NAME under the drivers'
        results directory, store.results_dir()). The JAX package's
        BENCH_spmv.json is never written."""
        if path is None:
            path = result_path(SUMMARY_NAME)
        if os.path.basename(path) == "BENCH_spmv.json":
            raise ValueError("BENCH_spmv.json is the JAX package's summary; "
                             "write the port's elsewhere")
        summary = self.bench_summary(field=field)
        summary["written_at"] = time.time()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=1)
        os.replace(tmp, path)
        return summary


def write_csv(path: str, header: list, rows: list) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    os.replace(tmp, path)
