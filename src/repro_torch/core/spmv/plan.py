"""Problem → Plan → Operator: the staged SpMV pipeline (single device).

The paper's core loop — reorder, convert, tune, measure — as three stages:

    problem = SpmvProblem(mat, k=8)                  # what to multiply
    pl      = plan(problem, reorder="auto")          # serializable decision
    op      = pl.build()                             # operator on the card

`plan()` jointly selects (scheme x engine x shape x k) exactly as the JAX
package's planner does: for each candidate reordering scheme it computes
the permuted matrix's structural features and scores every registered
engine's candidate grid with the k-aware cost model (core/spmv/tune.py).
Given the same matrix and request, both packages decide the same scheme,
engine, shape and permutation.

Plans are content-addressed in ONE persistent store, the port's own
(REPRO_TORCH_PLAN_CACHE, default `repro_torch_plans` under the system temp
directory; "off" disables it): an entry holds the plan record, the
permutation and the built operator's host arrays, so `Plan.save` /
`Plan.load` round-trip a tuned operator across processes with zero re-tune
and zero re-conversion. Entries are device-independent: a restored
operator is built on the device its caller asks for. Writes are tmp+rename
with the .json last (opcache.py's convention); a corrupt or truncated
entry reads as a miss and is rebuilt. The port's keys carry a "torch"
token and its records a "torch" backend tag, so the JAX package's store
and this one never read each other's entries.

The built operator CARRIES its permutation: `op(x)` / `op.matmul(X)` take
vectors in the ORIGINAL index space and return results in the original
index space. `permuted=True` (or `op.unwrap()`) runs in the reordered
space — what the measurement harness times.

`Plan.apply_delta` edits a plan's matrix by a StructureDelta under the
frozen decision (core/spmv/delta.py). Not ported yet: topology-aware
(sharded) plans.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from ... import obs
from ...device import resolve_device, torch_dtype
from .. import registry
from ..sparse.csr import CSRMatrix
from . import opcache
from . import tune as tune_mod
from .tune import TunePlan


def _store_dir() -> str:
    """Plan-store directory. Falls back to a `plans/` sibling under
    REPRO_TORCH_OPERATOR_CACHE when only that is set (a run that repoints
    the operator cache gets a hermetic plan store with it); "off" in either
    variable disables the store."""
    d = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    if d is not None:
        return d
    opd = os.environ.get("REPRO_TORCH_OPERATOR_CACHE")
    if opd is not None:
        return opd if opd.lower() in opcache.OFF \
            else os.path.join(opd, "plans")
    return os.path.join(tempfile.gettempdir(), "repro_torch_plans")


def store_enabled() -> bool:
    return _store_dir().lower() not in opcache.OFF


@dataclasses.dataclass(frozen=True)
class SpmvProblem:
    """What to multiply: the matrix, the expected RHS batch width, the
    compute dtype, and free-form planning hints.

    hints (all optional):
      seed        — reordering seed (default 0)
      schemes     — scheme names plan(reorder="auto") should consider
                    (default: every registered scheme with auto_candidate)
      block_shape — (bm, bn) / (C, W) for fixed block engines
      sell_sigma  — σ sort window for the fixed sell engine
      use_kernel  — "auto" | "cuda" | "ref"
    """

    mat: CSRMatrix
    k: int = 1
    dtype: Any = None
    hints: dict = dataclasses.field(default_factory=dict)

    def dtype_name(self) -> str:
        if self.dtype is None:
            return "float32"
        return str(torch_dtype(self.dtype)).replace("torch.", "")


def _mat_key(mat: CSRMatrix) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mat.rowptr).tobytes())
    h.update(np.ascontiguousarray(mat.cols).tobytes())
    h.update(np.ascontiguousarray(mat.vals).tobytes())
    h.update(f"{tuple(mat.shape)}".encode())
    return h.hexdigest()[:20]


def structure_key(mat: CSRMatrix) -> str:
    """sha1 over the STRUCTURE only (rowptr + cols + shape, never vals).

    Everything a plan decides is a function of the sparsity pattern, so
    two matrices with equal structure_key share one Plan: new values are a
    rebuild (`Plan.rebuild`), never a replan. The same bytes as the JAX
    package's, so the same hex string."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mat.rowptr).tobytes())
    h.update(np.ascontiguousarray(mat.cols).tobytes())
    h.update(f"{tuple(mat.shape)}".encode())
    return h.hexdigest()[:20]


def values_key(mat: CSRMatrix) -> str:
    """sha1 over the VALUES only — structure_key's complement."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mat.vals).tobytes())
    return h.hexdigest()[:20]


def plan_key(problem: SpmvProblem, reorder: str, engine: str, probe,
             seed: int, schemes=None) -> str:
    """sha1 over matrix content + the full plan request + the backend.

    As in the JAX package, k joins the key unless both engine and scheme
    are fixed. The "torch" token keeps the port's keys apart from the JAX
    package's, so the two can never read each other's entries.
    """
    k = problem.k if (engine == "auto" or reorder == "auto") else 1
    hints = problem.hints
    h = hashlib.sha1()
    h.update(_mat_key(problem.mat).encode())
    h.update(f"torch:{reorder}:{tuple(schemes or ())}:{seed}:{engine}:"
             f"{problem.dtype_name()}:"
             f"{tuple(hints.get('block_shape', (8, 128)))}:"
             f"{hints.get('sell_sigma')}:{probe}:{int(k)}".encode())
    return h.hexdigest()[:20]


class Operator:
    """Permutation-carrying SpMV/SpMM operator.

    `op(x)` and `op.matmul(X)` accept vectors in the ORIGINAL index space:
    x is gathered through `perm` before the reordered-space engine runs and
    the result is gathered back through `iperm`. `permuted=True` opts out
    (x already in the reordered space, result in the reordered space).
    """

    def __init__(self, inner, perm: Optional[np.ndarray], plan: "Plan",
                 device: torch.device, build_info: Optional[dict] = None):
        self.inner = inner
        self.plan = plan
        self.device = device
        self.build_info = build_info or {}
        if perm is not None and np.array_equal(perm, np.arange(perm.size)):
            perm = None                     # identity: skip the gathers
        self._perm_np = perm
        if perm is None:
            self._perm = self._iperm = None
        else:
            iperm = np.empty_like(perm)
            iperm[perm] = np.arange(perm.size, dtype=perm.dtype)
            self._perm = torch.as_tensor(perm).to(device)
            self._iperm = torch.as_tensor(iperm).to(device)

    @property
    def perm(self) -> Optional[np.ndarray]:
        """perm[i] = original row at reordered position i (None = identity)."""
        return self._perm_np

    @property
    def iperm(self) -> Optional[np.ndarray]:
        """iperm[r] = reordered position of original row r (None = identity)."""
        return None if self._iperm is None else self._iperm.cpu().numpy()

    @property
    def shape(self) -> tuple:
        inner = self.inner
        if hasattr(inner, "shape"):
            return tuple(inner.shape)
        if hasattr(inner, "m"):
            return (inner.m, inner.n)
        return tuple(inner.a.shape)         # DeviceDense

    def unwrap(self):
        """The bare reordered-space engine operator (what the measurement
        harness times)."""
        return self.inner

    def __call__(self, x: torch.Tensor, permuted: bool = False):
        if self._perm is None or permuted:
            return self.inner(x)
        y = self.inner(x.index_select(0, self._perm))
        return y.index_select(0, self._iperm)

    def matmul(self, x: torch.Tensor, permuted: bool = False):
        """x: [n, k] -> y: [m, k], original index space unless permuted."""
        if self._perm is None or permuted:
            return self.inner.matmul(x)
        y = self.inner.matmul(x.index_select(0, self._perm))
        return y.index_select(0, self._iperm)


@dataclasses.dataclass
class Plan:
    """A serializable pipeline decision: which scheme, which engine/shape,
    for which problem — plus the permutation that realizes the scheme.
    `build()` materializes the operator (from the plan store when possible,
    otherwise by permute + format conversion), never by re-tuning."""

    scheme: str
    seed: int
    engine_request: str               # what the caller asked ("auto"/fixed)
    tune: TunePlan                    # resolved engine decision
    k: int
    dtype_name: str
    probe: Any
    use_kernel: str
    mat_shape: tuple
    mat_nnz: int
    key: str                          # plan-store content key
    scheme_costs: dict = dataclasses.field(default_factory=dict)
    reorder_ms: float = 0.0
    tune_ms: float = 0.0
    plan_ms: float = 0.0
    cache_hit: bool = False           # this plan was loaded, not computed
    advisor_confidence: float = 0.0   # probe="learned": nearest-neighbor
    #                                   confidence of the advisor (else 0)
    perm: Optional[np.ndarray] = None  # None = identity
    _mat: Optional[CSRMatrix] = dataclasses.field(
        default=None, repr=False, compare=False)
    _rmat: Optional[CSRMatrix] = dataclasses.field(
        default=None, repr=False, compare=False)
    _op_state: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    def label(self) -> str:
        return f"{self.scheme}+{self.tune.label()}"

    # -- serialization (the JAX package's field names) ---------------------
    def to_json(self) -> dict:
        return {
            "scheme": self.scheme, "seed": self.seed,
            "engine_request": self.engine_request,
            "tune": self.tune.to_json(), "k": self.k,
            "dtype_name": self.dtype_name, "probe": self.probe,
            "use_kernel": self.use_kernel,
            "mat_shape": list(self.mat_shape), "mat_nnz": self.mat_nnz,
            "key": self.key, "scheme_costs": self.scheme_costs,
            "reorder_ms": self.reorder_ms, "tune_ms": self.tune_ms,
            "plan_ms": self.plan_ms,
            "advisor_confidence": self.advisor_confidence,
        }

    @staticmethod
    def from_json(d: dict, perm: Optional[np.ndarray] = None,
                  mat: Optional[CSRMatrix] = None) -> "Plan":
        """From this class's or the JAX package's to_json() (the JAX
        package's `nnz_bucket`, a padding that only shares XLA
        compilations, is dropped)."""
        return Plan(scheme=d["scheme"], seed=d["seed"],
                    engine_request=d["engine_request"],
                    tune=TunePlan.from_json(d["tune"]), k=d["k"],
                    dtype_name=d["dtype_name"], probe=d["probe"],
                    use_kernel=d["use_kernel"],
                    mat_shape=tuple(d["mat_shape"]), mat_nnz=d["mat_nnz"],
                    key=d["key"], scheme_costs=d.get("scheme_costs", {}),
                    reorder_ms=d.get("reorder_ms", 0.0),
                    tune_ms=d.get("tune_ms", 0.0),
                    plan_ms=d.get("plan_ms", 0.0),
                    advisor_confidence=d.get("advisor_confidence", 0.0),
                    perm=perm, _mat=mat)

    def save(self, op=None, path: Optional[str] = None) -> str:
        """Persist this plan (and, if given, a built operator's arrays) to
        the plan store, or to `path` (`<name>.json`). Returns the entry's
        json path."""
        d = (os.path.dirname(path) or ".") if path else _store_dir()
        os.makedirs(d, exist_ok=True)
        base = (path[:-5] if path and path.endswith(".json")
                else os.path.join(d, self.key))
        arrays: dict = {}
        if self.perm is not None:
            arrays["perm"] = np.asarray(self.perm, np.int64)
        rec = {"backend": opcache.BACKEND, "plan": self.to_json(), "op": None}
        if op is None and self._op_state is not None:
            # re-prefix the loaded arrays so the entry round-trips
            op_rec, op_arrays = self._op_state
            rec["op"] = op_rec
            arrays.update({f"op__{k}": v for k, v in op_arrays.items()})
        elif op is not None:
            meta, op_arrays = op.state()
            rec["op"] = {"cls": type(op).__name__, "meta": meta,
                         "dtypes": opcache.array_dtypes(op_arrays,
                                                        self.dtype_name)}
            arrays.update({f"op__{k}": v for k, v in op_arrays.items()})
        opcache.write_entry(base, rec, arrays)
        obs.counter("plan_store.writes").inc()
        return base + ".json"

    @staticmethod
    def load(key_or_path: str, mat: Optional[CSRMatrix] = None
             ) -> Optional["Plan"]:
        """Load a plan (and any stored operator arrays) by store key or
        explicit `<path>.json`. None on a miss, a corrupt entry or an entry
        that is not the port's: the store persists across code versions, so
        an unreadable entry is absent, never fatal."""
        if key_or_path.endswith(".json"):
            base = key_or_path[:-5]
        else:
            base = os.path.join(_store_dir(), key_or_path)
        jpath, zpath = base + ".json", base + ".npz"
        if not (os.path.exists(jpath) and os.path.exists(zpath)):
            obs.counter("plan_store.misses").inc()
            return None
        try:
            with open(jpath) as f:
                rec = json.load(f)
            if rec.get("backend") != opcache.BACKEND:
                raise ValueError("not an entry of the port's plan store")
            z = np.load(zpath)
            perm = z["perm"] if "perm" in z.files else None
            pl = Plan.from_json(rec["plan"], perm=perm, mat=mat)
            if rec.get("op"):
                op_arrays = {k[len("op__"):]: z[k] for k in z.files
                             if k.startswith("op__")}
                opcache.check_dtypes(op_arrays, rec["op"]["dtypes"])
                pl._op_state = (rec["op"], op_arrays)
            pl.cache_hit = True
            # this invocation paid none of the plan-time costs; the
            # originals stay in the record on disk
            pl.tune_ms = pl.reorder_ms = pl.plan_ms = 0.0
            obs.counter("plan_store.hits").inc()
            return pl
        except Exception:
            obs.counter("plan_store.misses").inc()
            return None

    # -- materialization ---------------------------------------------------
    def reordered_matrix(self) -> CSRMatrix:
        """The problem matrix in the plan's reordered index space."""
        if self._rmat is None:
            if self._mat is None:
                raise ValueError("plan has no attached matrix; pass mat= "
                                 "to Plan.load or use plan(problem, ...)")
            self._rmat = (self._mat if self.perm is None
                          else self._mat.permute(self.perm))
        return self._rmat

    def _restore_operator(self, dtype, device):
        """Operator from stored host arrays on `device` (no conversion, no
        matrix); None when the payload cannot be restored."""
        if self._op_state is None:
            return None
        op_rec, arrays = self._op_state
        cls = opcache.operator_registry().get(op_rec["cls"])
        if cls is None:
            return None
        try:
            op = cls.from_state(op_rec["meta"], arrays, dtype=dtype,
                                device=device)
        except Exception:
            return None
        if getattr(op, "use_kernel", None) is not None:
            op.use_kernel = self.use_kernel
        op.plan = self.tune
        return op

    def build(self, device=None, values: Optional[np.ndarray] = None,
              cache: bool = True) -> Operator:
        """The permutation-carrying Operator on `device` (None = the card).
        Store hit: the operator's arrays reload (load_ms); miss: permute +
        format conversion (build_ms), and with the store on the complete
        entry (plan + perm + operator arrays) is written. Never re-tunes.

        `values` (float[nnz], in the original matrix's CSR order) replaces
        the matrix's values for this build, as `rebuild` does: the decision
        and the permutation depend only on the sparsity structure, so they
        hold; such a build neither reads nor writes the store."""
        if values is not None:
            mat = self._mat
            if mat is None:
                raise ValueError("plan has no attached matrix")
            if np.shape(values) != (mat.nnz,):
                raise ValueError(f"values must be float[{mat.nnz}], got "
                                 f"shape {np.shape(values)}")
            return self.rebuild(dataclasses.replace(
                mat, vals=np.asarray(values)), device=device)
        dev = resolve_device(device)
        dt = torch_dtype(self.dtype_name)
        with obs.span("plan.build", key=self.key, scheme=self.scheme,
                      engine=self.tune.engine, backend="torch") as sp:
            info = {"cache_hit": False, "key": self.key,
                    "tune_ms": self.tune_ms, "build_ms": 0.0,
                    "load_ms": 0.0, "engine": self.tune.engine,
                    "plan": self.tune.to_json()}
            use_store = cache and store_enabled()
            inner = None
            if use_store:
                t0 = time.perf_counter()
                if self._op_state is None and self.cache_hit:
                    # only a loaded plan can find operator arrays in the
                    # store (plan() writes a plan-only entry)
                    stored = Plan.load(self.key, mat=self._mat)
                    if stored is not None and stored._op_state is not None:
                        self._op_state = stored._op_state
                inner = self._restore_operator(dt, dev)
                if inner is not None:
                    info["load_ms"] = (time.perf_counter() - t0) * 1e3
                    info["cache_hit"] = True
            if inner is None:
                t0 = time.perf_counter()
                inner = tune_mod.build_from_plan(
                    self.reordered_matrix(), self.tune, dtype=dt,
                    use_kernel=self.use_kernel, device=dev)
                info["build_ms"] = (time.perf_counter() - t0) * 1e3
                if use_store:
                    self.save(op=inner)
            sp.set(cache_hit=info["cache_hit"])
            return Operator(inner, self.perm, self, dev, build_info=info)

    def rebuild(self, mat: CSRMatrix, use_kernel: Optional[str] = None,
                device=None) -> Operator:
        """Operator for a matrix with the SAME sparsity structure and
        (possibly) other values, under this plan's frozen decision: permute
        through the carried perm, convert with the chosen (engine, shape)
        — no re-tune, no re-plan and no store write (the store is
        content-addressed over values). Raises ValueError on a structure
        mismatch."""
        if tuple(mat.shape) != tuple(self.mat_shape) \
                or mat.nnz != self.mat_nnz:
            raise ValueError(
                f"rebuild() needs the plan's structure "
                f"({self.mat_shape}, nnz={self.mat_nnz}); got "
                f"({tuple(mat.shape)}, nnz={mat.nnz}) — replan instead")
        dev = resolve_device(device)
        with obs.span("plan.rebuild", key=self.key,
                      engine=self.tune.engine, backend="torch"):
            rmat = mat if self.perm is None else mat.permute(self.perm)
            t0 = time.perf_counter()
            inner = tune_mod.build_from_plan(
                rmat, self.tune, dtype=torch_dtype(self.dtype_name),
                use_kernel=(self.use_kernel if use_kernel is None
                            else use_kernel), device=dev)
            info = {"cache_hit": False, "key": self.key, "tune_ms": 0.0,
                    "build_ms": (time.perf_counter() - t0) * 1e3,
                    "load_ms": 0.0, "engine": self.tune.engine,
                    "plan": self.tune.to_json(), "value_swap": True}
        return Operator(inner, self.perm, self, dev, build_info=info)

    def apply_delta(self, delta, *, max_churn: Optional[float] = None,
                    max_bw_growth: Optional[float] = None) -> "Plan":
        """A NEW Plan for this plan's matrix edited by a StructureDelta
        (core/spmv/delta.py), reusing the frozen tuning decision and
        permutation — the amortization tier between `rebuild` (values
        only) and a full replan (new search).

        An empty delta returns this plan unchanged (no counters move).
        A small delta (nnz churn <= max_churn AND bandwidth growth <=
        max_bw_growth, defaults delta.MAX_CHURN / delta.MAX_BW_GROWTH)
        returns the edited plan under a `plan.delta` span, counting
        `delta.applies`; appended rows extend the permutation with
        identity tail positions. Past either threshold the frozen
        decision is stale: DeltaTooLarge is raised (counting
        `delta.fallbacks`) and the caller replans."""
        from . import delta as delta_mod

        kw = {}
        if max_churn is not None:
            kw["max_churn"] = max_churn
        if max_bw_growth is not None:
            kw["max_bw_growth"] = max_bw_growth
        return delta_mod.apply_delta(self, delta, **kw)


def _auto_schemes(hints: dict) -> list:
    names = hints.get("schemes")
    if names is None:
        names = [s.name for s in registry.SCHEME_REGISTRY.values()
                 if s.auto_candidate]
    return list(names)


def plan(problem: SpmvProblem, reorder: str = "auto", engine: str = "auto",
         probe=False, cache: bool = True, device=None) -> Plan:
    """Decide (scheme, engine, shape) for the problem; see _plan_decide.

    cache — consult and populate the plan store (and the reorder cache);
    a hit returns the stored plan with cache_hit=True and zero plan-time
    costs. `device` matters only to probe=True / "exhaustive", which build
    and time candidates there (None = the card)."""
    with obs.span("plan", shape=str(tuple(problem.mat.shape)),
                  nnz=int(problem.mat.nnz), reorder=reorder,
                  engine=engine, probe=str(probe), k=int(problem.k),
                  backend="torch") as sp:
        pl = _plan_decide(problem, reorder, engine, probe, cache, device)
        sp.set(scheme=pl.scheme, engine_chosen=pl.tune.engine,
               cache_hit=bool(pl.cache_hit), key=pl.key)
        return pl


def _plan_decide(problem: SpmvProblem, reorder: str, engine: str, probe,
                 cache: bool, device) -> Plan:
    """reorder — a registered scheme name, or "auto" to jointly search the
    auto-candidate schemes (hints["schemes"] overrides the set): each
    candidate is permuted, its features recomputed and every engine
    candidate re-scored, so the winner is the (scheme, engine, shape)
    argmin of modelled bytes at the problem's k. engine — a registered
    engine name, or "auto" for the tuner. probe — tune.PROBE_MODES;
    auto-scheme selection stays model-based and the winning scheme is
    re-tuned with the requested probe mode."""
    from . import ops  # noqa: F401 — ensure built-in engines are registered
    from ..reorder import api as reorder_api

    if probe not in tune_mod.PROBE_MODES:
        raise ValueError(
            f"probe must be one of {tune_mod.PROBE_MODES}, got {probe!r}")
    t_start = time.perf_counter()
    mat = problem.mat
    hints = problem.hints
    seed = int(hints.get("seed", 0))
    use_kernel = hints.get("use_kernel", "auto")
    block_shape = tuple(hints.get("block_shape", (8, 128)))
    sell_sigma = hints.get("sell_sigma")
    k = max(int(problem.k), 1)

    if engine != "auto":
        registry.get_engine(engine)
    schemes = _auto_schemes(hints) if reorder == "auto" else [reorder]
    if not schemes:
        raise ValueError("no candidate schemes: hints['schemes'] is empty "
                         "and no registered scheme is auto_candidate")
    for s in schemes:
        registry.get_scheme(s)
    key = plan_key(problem, reorder, engine, probe, seed,
                   schemes=schemes if reorder == "auto" else None)
    if cache and store_enabled():
        hit = Plan.load(key, mat=mat)
        if hit is not None:
            # use_kernel is a run-time choice, not plan identity: the
            # requesting caller's preference wins
            hit.use_kernel = use_kernel
            return hit

    reorder_ms = tune_ms = 0.0
    best = None                       # (cost, scheme, perm, rmat, tuneplan)
    scheme_costs: dict = {}
    for s in schemes:
        t0 = time.perf_counter()
        perm = (None if s == "baseline"
                else reorder_api.reorder(mat, s, seed, cache=cache))
        rmat = mat if perm is None else mat.permute(perm)
        reorder_ms += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if engine == "auto":
            # single explicit scheme: probe directly; a multi-scheme search
            # stays model-based until a winner exists
            tp = tune_mod.tune(rmat,
                               probe=(probe if len(schemes) == 1 else False),
                               dtype=problem.dtype, use_kernel=use_kernel,
                               k=k, device=device)
            cost = tp.cost_bytes
        else:
            feat = tune_mod.matrix_features(rmat)
            sp = None
            if engine == "sell":
                from ..sparse.sell import sell_padded_nnz

                c, w = block_shape
                sg = 8 * c if sell_sigma is None else sell_sigma
                sp = sell_padded_nnz(rmat, c, sg, w)
            cost = tune_mod.candidate_cost(feat, engine, block_shape,
                                           sell_sigma, sp, k=k)
            tp = tune_mod.fixed_plan(engine, block_shape, sell_sigma, k=k)
        tune_ms += (time.perf_counter() - t0) * 1e3
        scheme_costs[s] = float(cost)
        if best is None or cost < best[0]:
            best = (cost, s, perm, rmat, tp)
    _, scheme, perm, rmat, tp = best
    if probe and engine == "auto" and tp.source not in ("probe", "learned"):
        # the model picked the scheme; the empirical search refines the
        # engine choice on the winner only, in the caller's probe mode
        t0 = time.perf_counter()
        tp = tune_mod.tune(rmat, probe=probe, dtype=problem.dtype,
                           use_kernel=use_kernel, k=k, device=device)
        tune_ms += (time.perf_counter() - t0) * 1e3

    pl = Plan(scheme=scheme, seed=seed, engine_request=engine, tune=tp,
              k=k, dtype_name=problem.dtype_name(), probe=probe,
              use_kernel=use_kernel, mat_shape=tuple(mat.shape),
              mat_nnz=mat.nnz, key=key, scheme_costs=scheme_costs,
              reorder_ms=reorder_ms, tune_ms=tune_ms,
              plan_ms=(time.perf_counter() - t_start) * 1e3,
              advisor_confidence=float(
                  (tp.advisor or {}).get("confidence", 0.0)),
              perm=None if perm is None else np.asarray(perm, np.int64),
              _mat=mat, _rmat=rmat)
    if cache and store_enabled():
        pl.save()
    return pl
