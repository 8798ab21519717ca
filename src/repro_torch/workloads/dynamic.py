"""Dynamic sparse problems and the plan-amortization session.

`DynamicSparseProblem` is the stream-of-structures analogue of
`SpmvProblem`: a workload name + scenario + seed that yields
`WorkloadStep`s (sources.py). `WorkloadSession` is where the paper's
amortization question gets an explicit policy instead of an assumption:

  reuse   — structure AND values identical to a cached step: hand back
            the cached Operator, zero plan cost.
  rebuild — structure identical, values changed: `Plan.rebuild` swaps
            the value array under the frozen plan (no reorder, no tune).
  plan    — first time a role sees this structure: full `plan()`.
  replan  — a role that already planned sees a NEW structure: full
            `plan()` again; this is the cost that must amortize.

Identity is `structure_key` (rowptr+cols sha1, core/spmv/plan.py) for
structure and `values_key` for values — content, not object identity, so
a drifted-then-returned structure still reuses. Every decision bumps a
`workload.{plans,replans,reuses,rebuilds}` counter and runs under a
`workload.*` span; reuse_rate = (reuses + rebuilds + deltas) / requests
and
plan_cost_share = plan_ms / (plan_ms + exec_ms) are the two headline
numbers the "workload" cell kind reports.

Operators live on one device: the card by default (`device=None`; it
raises without one), the CPU when the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np

from .. import obs
from ..core.spmv.plan import (SpmvProblem, plan as plan_fn, structure_key,
                              values_key)
from ..device import resolve_device
from . import adapters, sources
from .sources import WorkloadStep


@dataclasses.dataclass(frozen=True)
class DynamicSparseProblem:
    """A per-step sparse structure stream, addressable like a problem.

    `name` is a `workload://` name (sources.parse_workload grammar),
    `scenario` one of sources.SCENARIOS. `steps()` yields the stream;
    `lower(mat)` produces the static `SpmvProblem` a single step's
    operand lowers to (what the session feeds `plan()`).
    """

    name: str
    scenario: str = "drift"
    seed: int = 0
    dtype: str = "float32"
    hints: Optional[dict] = None

    def __post_init__(self):
        sources.parse_workload(self.name)          # validate eagerly
        if self.scenario not in sources.SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; "
                             f"known: {sources.SCENARIOS}")

    @property
    def wdef(self) -> sources.WorkloadDef:
        return sources.parse_workload(self.name)

    @property
    def width(self) -> int:
        return self.wdef.width

    def steps(self) -> Iterator[WorkloadStep]:
        return sources.steps(self.wdef, self.scenario, self.seed)

    def lower(self, mat) -> SpmvProblem:
        hints = dict(self.hints or {})
        wd = self.wdef
        if wd.kind == "attn":
            # the mask is dense inside (b × b) blocks — tell the planner
            b = int(wd.params["b"])
            hints.setdefault("block_shape", (b, b))
        return SpmvProblem(mat=mat, k=self.width, dtype=self.dtype,
                           hints=hints)


class WorkloadSession:
    """Plan-amortization cache for one stream: structure_key → frozen
    Plan (+ per-values Operator). See module docstring for the policy."""

    def __init__(self, problem: DynamicSparseProblem, *,
                 reorder: str = "baseline", engine: str = "auto",
                 probe=False, use_deltas: bool = False, device=None):
        self.problem = problem
        self.device = resolve_device(device)
        self.reorder = reorder
        self.engine = engine
        self.probe = probe
        # opt-in: when a role's structure drifts, try to express the move
        # as a StructureDelta against the role's previous plan and
        # Plan.apply_delta it (frozen decision + perm kept, no reorder,
        # no tuner search) instead of a full replan. Off by default so
        # replan counts stay the amortization ground truth.
        self.use_deltas = bool(use_deltas)
        self._cache: dict = {}        # skey -> {plan, vkey, op}
        self._planned_roles: set = set()
        self._role_skey: dict = {}    # role -> last structure key seen
        self.counts = {"plans": 0, "replans": 0, "reuses": 0,
                       "rebuilds": 0, "deltas": 0}
        self.plan_ms = 0.0            # wall time spent planning/rebuilding
        self.events: list = []        # per-request event log

    @property
    def requests(self) -> int:
        return sum(self.counts.values())

    @property
    def reuse_rate(self) -> float:
        total = self.requests
        if not total:
            return 0.0
        return (self.counts["reuses"] + self.counts["rebuilds"]
                + self.counts["deltas"]) / total

    def operator(self, mat, role: str = ""):
        """Resolve a step operand to an Operator under the amortization
        policy. Returns (op, event) with event in plan/replan/reuse/
        rebuild."""
        skey = structure_key(mat)
        vkey = values_key(mat)
        ent = self._cache.get(skey)
        t0 = time.perf_counter()
        if ent is not None and ent["vkey"] == vkey:
            event = "reuses"
            op = ent["op"]
        elif ent is not None:
            event = "rebuilds"
            with obs.span("workload.rebuild", role=role):
                ent["op"] = ent["plan"].rebuild(mat, device=self.device)
                ent["vkey"] = vkey
            op = ent["op"]
        else:
            op = None
            if self.use_deltas and role in self._planned_roles:
                op, pl = self._try_delta(mat, role, vkey)
            if op is not None:
                event = "deltas"
                self._cache[skey] = {"plan": pl, "vkey": vkey, "op": op}
            else:
                event = ("plans" if role not in self._planned_roles
                         else "replans")
                self._planned_roles.add(role)
                with obs.span("workload.plan", role=role, event=event):
                    pl = plan_fn(self.problem.lower(mat),
                                 reorder=self.reorder,
                                 engine=self.engine, probe=self.probe,
                                 device=self.device)
                    op = pl.build(device=self.device)
                self._cache[skey] = {"plan": pl, "vkey": vkey, "op": op}
        self._role_skey[role] = skey
        dt_ms = (time.perf_counter() - t0) * 1e3
        if event != "reuses":
            self.plan_ms += dt_ms
        self.counts[event] += 1
        obs.counter(f"workload.{event}").inc()
        self.events.append({"role": role, "event": event, "ms": dt_ms})
        return op, event

    def _try_delta(self, mat, role: str, vkey: str):
        """Express the role's structure drift as a StructureDelta against
        its previous plan and apply it (frozen decision kept). Returns
        (op, plan) or (None, None) when no delta expresses the move or it
        exceeds the churn/bandwidth thresholds (DeltaTooLarge — the
        caller replans). Surviving entries may carry drifted values, so a
        values mismatch after the apply is settled with a rebuild."""
        from ..core.spmv import delta as delta_mod

        prev = self._cache.get(self._role_skey.get(role))
        if prev is None or prev["plan"]._mat is None:
            return None, None
        d = delta_mod.delta_between(prev["plan"]._mat, mat)
        if d is None or d.is_empty:
            return None, None
        try:
            pl = prev["plan"].apply_delta(d)
        except delta_mod.DeltaTooLarge:
            return None, None
        with obs.span("workload.delta", role=role,
                      edited=d.churn_nnz):
            op = (pl.build(device=self.device)
                  if values_key(pl._mat) == vkey
                  else pl.rebuild(mat, device=self.device))
        return op, pl


def run_stream(problem: DynamicSparseProblem,
               session: Optional[WorkloadSession] = None, *,
               iters: int = 3, compare_dense: bool = True,
               verify: bool = True, device=None) -> dict:
    """Drive the full stream through the session; the shared step loop
    behind the "workload" cell kind, tests, and examples.

    Per step: resolve each operand chain stage to an Operator (amortized
    per the session policy), execute the chain `iters` times (median
    wall ms), and — when `compare_dense` — run the kind's reference path
    (onehot scatter-dispatch for moe, dense matmul for attn/gnn) for the
    sorted-vs-onehot / sparse-vs-dense speedup. `verify` checks the
    sparse output against the reference (rel err) and, for moe, that the
    dispatch buffer is BITWISE equal to the onehot scatter (both place
    each token's row with no summation, so exact equality is the spec,
    not a tolerance). `device` places the default session (a given
    session keeps its own).
    """
    session = session or WorkloadSession(problem, device=device)
    dev = session.device
    kind = problem.wdef.kind
    per_step = []
    li, drops = [], []
    exec_ms_total = 0.0
    ref_ms = []
    max_rel_err = 0.0
    bitwise_ok = True
    nsteps = 0
    m0 = n0 = nnz0 = 0
    for step in problem.steps():
        nsteps += 1
        with obs.span("workload.step", step=step.index, kind=kind,
                      scenario=problem.scenario):
            plan_ms_before = session.plan_ms
            ops, events = [], []
            for opnd in step.operands:
                op, ev = session.operator(opnd.mat, role=opnd.role)
                ops.append(op)
                events.append(ev)
            if step.index == 0:
                m0, n0 = step.operands[0].mat.shape
                nnz0 = step.operands[0].mat.nnz
            xs = [adapters.to_device(o.x, dev) if o.x is not None else None
                  for o in step.operands]

            def chain():
                y = None
                for op, x in zip(ops, xs):
                    y = op.matmul(x if x is not None else y)
                return adapters.block_until_ready(y)

            outs = chain()                       # warm + output for verify
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                chain()
                times.append((time.perf_counter() - t0) * 1e3)
            exec_ms = float(np.median(times))
            exec_ms_total += exec_ms

            rec = {"step": step.index, "events": events,
                   "plan_ms": session.plan_ms - plan_ms_before,
                   "exec_ms": exec_ms, "li": step.meta.get("li")}
            if compare_dense:
                ref = adapters.reference(kind, step, iters=iters,
                                         device=dev)
                ref_ms.append(ref["ms"])
                rec["ref_ms"] = ref["ms"]
                if verify:
                    y = outs.cpu().numpy()
                    err = adapters.rel_err(y, ref["y"])
                    max_rel_err = max(max_rel_err, err)
                    rec["rel_err"] = err
                    if kind == "moe":
                        buf = ops[0].matmul(xs[0]).cpu().numpy()
                        if not np.array_equal(buf, ref["buf"]):
                            bitwise_ok = False
            if step.meta.get("li") is not None:
                li.append(step.meta["li"])
            if "drop_frac" in step.meta:
                drops.append(step.meta["drop_frac"])
            per_step.append(rec)

    plan_ms = session.plan_ms
    out = {
        "workload": problem.name, "kind": kind,
        "scenario": problem.scenario, "steps": nsteps,
        "width": problem.width, "m": m0, "n": n0, "nnz": nnz0,
        "plans": session.counts["plans"],
        "replans": session.counts["replans"],
        "reuses": session.counts["reuses"],
        "rebuilds": session.counts["rebuilds"],
        "deltas": session.counts["deltas"],
        "reuse_rate": round(session.reuse_rate, 4),
        "plan_ms_total": round(plan_ms, 3),
        "exec_ms_total": round(exec_ms_total, 3),
        "plan_cost_share": round(
            plan_ms / max(plan_ms + exec_ms_total, 1e-9), 4),
        "li_mean": round(float(np.mean(li)), 3) if li else None,
        "li_max": round(float(np.max(li)), 3) if li else None,
        "sparse_ms": round(exec_ms_total / max(nsteps, 1), 4),
        "per_step": per_step,
    }
    if drops:
        out["drop_frac"] = round(float(np.mean(drops)), 4)
    if compare_dense and ref_ms:
        out["ref_ms"] = round(float(np.mean(ref_ms)), 4)
        out["speedup_vs_ref"] = round(out["ref_ms"]
                                      / max(out["sparse_ms"], 1e-9), 3)
        if verify:
            out["max_rel_err"] = float(max_rel_err)
            out["verify_ok"] = bool(max_rel_err < 1e-3)
            if kind == "moe":
                out["dispatch_bitwise_equal"] = bool(bitwise_ok)
    return out
