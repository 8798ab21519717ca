"""Open-loop traffic simulator for SpmvService — SLO-vs-load curves.

The paper's amortization argument (reorder/tune cost is only worth paying
over many executions) becomes measurable only under traffic: this module
generates OPEN-LOOP request streams — arrivals fire on their own schedule
whether or not the service keeps up, which is what makes overload visible
(a closed loop self-throttles and can never push the service past
capacity) — and drives a service instance, classifying every outcome.

Three pieces:

  * TrafficPattern      — declarative load shape: arrival process
                          (poisson / uniform / bursty), offered rate,
                          request count, Zipf hot-key skew over n_keys,
                          and a value-update mix (update_frac of arrivals
                          are update_values calls, exercising the
                          no-replan value-swap path under load).
  * arrival_times / zipf_keys / update_mask
                        — the deterministic (seeded) schedule pieces,
                          unit-testable without a service.
  * run_open_loop(svc, mats, pattern)
                        — drive a service, resolve EVERY future, return a
                          summary: outcome counts (ok / shed / rejected /
                          errors / unresolved), achieved vs offered rate,
                          budget compliance, and the service's stats()
                          snapshot. `unresolved` > 0 means a Future never
                          resolved — the invariant the soak test asserts
                          to zero. Beside the JAX package's keys it
                          reports the schedule's span, the submit window
                          and `drain_s`, the time to the last request's
                          answer (replans excluded).

The `"serve"` experiment cell kind (experiments/cells.py) wraps this so
SLO-vs-load curves flow through ExperimentSpec → ResultStore → Report
like every other measurement; `python -m repro_torch.launch.spmv_bench
--serve-traffic` drives one scenario.

The JAX package's module, in numpy: the same seeds give the same
schedules, bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict

import numpy as np

from ..core.sparse.csr import CSRMatrix
from .errors import KeyBusy, QueueFull, RequestShed

ARRIVALS = ("poisson", "uniform", "bursty")


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    """One load shape, fully deterministic given `seed`.

    arrival      — "poisson" (memoryless, the open-loop default),
                   "uniform" (evenly spaced — isolates queueing from
                   arrival variance), or "bursty" (on/off modulated
                   Poisson: burst_factor x the mean rate for burst_duty
                   of each burst_period, starved in between — same mean
                   rate, much worse tail).
    rate_rps     — MEAN offered arrival rate, requests per second.
    requests     — total arrivals (submits + value updates).
    n_keys       — distinct matrix keys; requests pick keys Zipf(zipf_s)
                   -skewed (key 0 hottest). More keys than the memory
                   budget fits is the LRU-thrash scenario.
    zipf_s       — Zipf exponent (0 = uniform over keys).
    update_frac  — fraction of arrivals that are update_values() calls
                   instead of submits (the dynamic-values mix).
    structure_frac — fraction of arrivals that are update_structure()
                   calls carrying a small deletion-only StructureDelta
                   (always churn/bandwidth-legal, so the delta-apply
                   path — not the full-replan fallback — is what soaks).
                   Takes precedence over update_frac on an arrival
                   masked by both.
    """

    arrival: str = "poisson"
    rate_rps: float = 200.0
    requests: int = 200
    n_keys: int = 1
    zipf_s: float = 1.1
    update_frac: float = 0.0
    structure_frac: float = 0.0
    burst_factor: float = 4.0
    burst_duty: float = 0.2
    burst_period_s: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival must be one of {ARRIVALS}, "
                             f"got {self.arrival!r}")
        if self.rate_rps <= 0 or self.requests < 1 or self.n_keys < 1:
            raise ValueError("rate_rps must be > 0, requests and n_keys "
                             ">= 1")
        if not 0.0 <= self.update_frac < 1.0:
            raise ValueError("update_frac must be in [0, 1)")
        if not 0.0 <= self.structure_frac < 1.0:
            raise ValueError("structure_frac must be in [0, 1)")
        if not (self.burst_factor > 1.0 and 0.0 < self.burst_duty < 1.0
                and self.burst_period_s > 0.0):
            raise ValueError("burst_factor must be > 1, burst_duty in "
                             "(0, 1), burst_period_s > 0")


def arrival_times(pattern: TrafficPattern) -> np.ndarray:
    """Offsets (seconds, ascending, starting after 0) of each arrival."""
    rng = np.random.default_rng(pattern.seed)
    n, rate = pattern.requests, pattern.rate_rps
    if pattern.arrival == "uniform":
        return (np.arange(1, n + 1) / rate).astype(np.float64)
    if pattern.arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, size=n))
    # bursty: piecewise-Poisson, rate modulated by an on/off square wave
    # with the SAME mean rate (lo = (1 - duty*factor)/(1 - duty) * rate,
    # floored at 1% of rate — with the defaults duty*factor <= 1 so the
    # floor never engages and the mean is exact). Generated by
    # Lewis-Shedler thinning: candidate gaps at the hi rate, accepted
    # with probability r(t)/hi — naively sampling at the CURRENT phase
    # rate is wrong (a long off-phase gap leaps over later bursts
    # entirely, collapsing the realized mean rate).
    duty, factor, period = (pattern.burst_duty, pattern.burst_factor,
                            pattern.burst_period_s)
    hi = rate * factor
    lo = max(rate * (1.0 - duty * factor) / max(1.0 - duty, 1e-9),
             rate * 0.01)
    out = np.empty(n, np.float64)
    t = 0.0
    for i in range(n):
        while True:
            t += float(rng.exponential(1.0 / hi))
            r = hi if (t % period) / period < duty else lo
            if rng.random() * hi < r:
                break
        out[i] = t
    return out


def zipf_keys(pattern: TrafficPattern) -> np.ndarray:
    """Key index per arrival, Zipf(zipf_s)-skewed (index 0 hottest)."""
    rng = np.random.default_rng(pattern.seed + 1)
    w = 1.0 / np.arange(1, pattern.n_keys + 1) ** pattern.zipf_s
    return rng.choice(pattern.n_keys, size=pattern.requests, p=w / w.sum())


def update_mask(pattern: TrafficPattern) -> np.ndarray:
    """Boolean per arrival: True = update_values() instead of submit()."""
    rng = np.random.default_rng(pattern.seed + 2)
    return rng.random(pattern.requests) < pattern.update_frac


def structure_mask(pattern: TrafficPattern) -> np.ndarray:
    """Boolean per arrival: True = update_structure() with a small
    deletion delta. Wins over update_mask on a doubly masked arrival."""
    rng = np.random.default_rng(pattern.seed + 4)
    return rng.random(pattern.requests) < pattern.structure_frac


def _deletion_delta(mat: CSRMatrix, rng, frac: float = 0.005):
    """A small always-legal StructureDelta: delete ~frac of the entries
    (floored at 1). Deletions never grow bandwidth and the churn stays
    far under delta.MAX_CHURN, so Plan.apply_delta accepts it."""
    from ..core.spmv.delta import StructureDelta

    nnz = mat.nnz
    k = max(1, int(round(frac * nnz)))
    pick = np.sort(rng.choice(nnz, size=min(k, nnz), replace=False))
    rows = np.repeat(np.arange(mat.shape[0], dtype=np.int64),
                     np.diff(mat.rowptr.astype(np.int64)))
    return StructureDelta(del_rows=rows[pick],
                          del_cols=mat.cols.astype(np.int64)[pick])


def run_open_loop(svc, mats: Dict[str, CSRMatrix],
                  pattern: TrafficPattern,
                  result_timeout_s: float = 60.0,
                  speedup: float = 1.0, prewarm: bool = True) -> dict:
    """Drive `svc` with the pattern over the (already registered) keys in
    `mats`, open-loop: each arrival fires at its scheduled offset whether
    or not earlier requests completed (late = fire immediately, never
    skipped). Every submitted Future is then resolved and classified.

    prewarm resolves every key's operator BEFORE the clock starts (the
    production warm-up step): the stream then measures steady-state
    serving, not first-build latency, and value updates hit existing
    plans (the eager no-replan swap path) instead of keys that were
    never planned. Under a memory budget the prewarm itself already
    exercises LRU eviction. speedup > 1 compresses the schedule (CI
    knob: same arrival sequence, shorter wall time). Returns the summary
    dict (see module docstring); `svc` is NOT closed — the caller owns
    its lifecycle (flush() before reading svc.stats() if quiescent
    counters are wanted).
    """
    if len(mats) < pattern.n_keys:
        raise ValueError(f"pattern wants {pattern.n_keys} keys, "
                         f"got {len(mats)} matrices")
    keys = list(mats)[:pattern.n_keys]
    if prewarm:
        for k in keys:
            svc.operator(k)
    rng = np.random.default_rng(pattern.seed + 3)
    xs = {k: rng.standard_normal(mats[k].shape[1]) for k in keys}

    times = arrival_times(pattern) / float(speedup)
    kidx = zipf_keys(pattern)
    is_update = update_mask(pattern)
    is_structure = structure_mask(pattern)
    cur = dict(mats)          # tracks structure as deltas land
    drng = np.random.default_rng(pattern.seed + 5)

    futures = []
    replan_futures = []
    submitted = rejected = updates = update_conflicts = update_errors = 0
    structure_updates = structure_conflicts = structure_errors = 0
    retry_after_positive = True
    t0 = time.monotonic()
    for i in range(pattern.requests):
        delay = t0 + times[i] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        key = keys[kidx[i]]
        if is_structure[i]:
            try:
                d = _deletion_delta(cur[key], drng)
                replan_futures.append(
                    svc.update_structure(key, delta=d))
                cur[key] = d.apply_to(cur[key])
                structure_updates += 1
            except KeyBusy:
                structure_conflicts += 1   # replan already in flight
            except Exception:
                structure_errors += 1
        elif is_update[i]:
            try:
                svc.update_values(key, cur[key].vals * (1.0 + 0.01 * i))
                updates += 1
            except KeyBusy:
                update_conflicts += 1   # replan in flight: benign race
            except Exception:
                update_errors += 1
        else:
            try:
                futures.append(svc.submit(key, xs[key]))
                submitted += 1
            except QueueFull as e:
                rejected += 1
                if e.retry_after_ms <= 0:
                    retry_after_positive = False
    wall_submit_s = time.monotonic() - t0

    ok = shed = errors = unresolved = 0
    for fut in futures:
        try:
            fut.result(timeout=result_timeout_s)
            ok += 1
        except RequestShed:
            shed += 1
        except FutureTimeout:
            unresolved += 1             # the no-silent-drops violation
        except Exception:
            errors += 1
    drain_s = time.monotonic() - t0
    replans_landed = replan_errors = replan_unresolved = 0
    for fut in replan_futures:
        try:
            fut.result(timeout=result_timeout_s)
            replans_landed += 1
        except FutureTimeout:
            replan_unresolved += 1
        except Exception:
            replan_errors += 1
    wall_s = time.monotonic() - t0

    stats = svc.stats()
    budget = stats.get("memory_budget_bytes")
    budget_ok = (budget is None
                 or stats.get("resident_bytes_max", 0) <= budget)
    if "per_device_ok" in stats:        # routed fleet: per-device verdict
        budget_ok = budget_ok and bool(stats["per_device_ok"])
    return {
        "pattern": dataclasses.asdict(pattern),
        "offered": int(pattern.requests),
        "submitted": int(submitted),
        "ok": int(ok),
        "shed": int(shed),
        "rejected": int(rejected),
        "errors": int(errors),
        "unresolved": int(unresolved),
        "updates": int(updates),
        "update_conflicts": int(update_conflicts),
        "update_errors": int(update_errors),
        "structure_updates": int(structure_updates),
        "structure_conflicts": int(structure_conflicts),
        "structure_errors": int(structure_errors),
        "replans_landed": int(replans_landed),
        "replan_errors": int(replan_errors),
        "replan_unresolved": int(replan_unresolved),
        "retry_after_positive": bool(retry_after_positive),
        "offered_rps": pattern.requests / max(wall_submit_s, 1e-9),
        "schedule_s": float(times[-1]) if times.size else 0.0,
        "submit_s": float(wall_submit_s),
        "drain_s": float(drain_s),
        "achieved_rps": ok / max(wall_s, 1e-9),
        "wall_s": float(wall_s),
        "budget_ok": bool(budget_ok),
        "stats": stats,
    }
