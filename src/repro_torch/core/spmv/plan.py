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

The built operator CARRIES its permutation: `op(x)` / `op.matmul(X)` take
vectors in the ORIGINAL index space and return results in the original
index space. `permuted=True` (or `op.unwrap()`) runs in the reordered
space — what the measurement harness times.

Not ported yet: the persistent plan store (so `plan(cache=True)` raises),
`Plan.rebuild`, `Plan.apply_delta` and topology-aware (sharded) plans.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Optional

import numpy as np
import torch

from ... import obs
from ...device import resolve_device, torch_dtype
from .. import registry
from ..sparse.csr import CSRMatrix
from . import tune as tune_mod
from .tune import TunePlan


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
    `build()` materializes the operator by permute + format conversion,
    never by re-tuning."""

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
    key: str
    scheme_costs: dict = dataclasses.field(default_factory=dict)
    reorder_ms: float = 0.0
    tune_ms: float = 0.0
    plan_ms: float = 0.0
    perm: Optional[np.ndarray] = None  # None = identity
    _mat: Optional[CSRMatrix] = dataclasses.field(
        default=None, repr=False, compare=False)
    _rmat: Optional[CSRMatrix] = dataclasses.field(
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
                    perm=perm, _mat=mat)

    # -- materialization ---------------------------------------------------
    def reordered_matrix(self) -> CSRMatrix:
        """The problem matrix in the plan's reordered index space."""
        if self._rmat is None:
            if self._mat is None:
                raise ValueError("plan has no attached matrix; pass mat= "
                                 "or use plan(problem, ...)")
            self._rmat = (self._mat if self.perm is None
                          else self._mat.permute(self.perm))
        return self._rmat

    def build(self, device=None,
              values: Optional[np.ndarray] = None) -> Operator:
        """The permutation-carrying Operator on `device` (None = the card):
        permute + format conversion under this plan's decision.

        `values` (float[nnz], in the original matrix's CSR order) replaces
        the matrix's values for this build: the decision and the
        permutation depend only on the sparsity structure, so they hold."""
        dev = resolve_device(device)
        rmat = self.reordered_matrix()
        if values is not None:
            mat = self._mat
            if np.shape(values) != (mat.nnz,):
                raise ValueError(f"values must be float[{mat.nnz}], got "
                                 f"shape {np.shape(values)}")
            mat = dataclasses.replace(mat, vals=np.asarray(values))
            rmat = mat if self.perm is None else mat.permute(self.perm)
        with obs.span("plan.build", key=self.key, scheme=self.scheme,
                      engine=self.tune.engine, backend="torch"):
            t0 = time.perf_counter()
            inner = tune_mod.build_from_plan(
                rmat, self.tune,
                dtype=torch_dtype(self.dtype_name),
                use_kernel=self.use_kernel, device=dev)
            info = {"key": self.key, "tune_ms": self.tune_ms,
                    "build_ms": (time.perf_counter() - t0) * 1e3,
                    "engine": self.tune.engine, "plan": self.tune.to_json()}
            return Operator(inner, self.perm, self, dev, build_info=info)


def _auto_schemes(hints: dict) -> list:
    names = hints.get("schemes")
    if names is None:
        names = [s.name for s in registry.SCHEME_REGISTRY.values()
                 if s.auto_candidate]
    return list(names)


def plan(problem: SpmvProblem, reorder: str = "auto", engine: str = "auto",
         probe=False, cache: bool = False, device=None) -> Plan:
    """Decide (scheme, engine, shape) for the problem; see _plan_decide.

    cache=True (the persistent plan store) is not ported yet and raises.
    `device` matters only to probe=True / "exhaustive", which build and
    time candidates there (None = the card)."""
    if cache:
        raise NotImplementedError(
            "repro_torch has no plan store yet (it comes with the slice "
            "that ports core/spmv/opcache.py and the plan store); call "
            "plan(..., cache=False)")
    with obs.span("plan", shape=str(tuple(problem.mat.shape)),
                  nnz=int(problem.mat.nnz), reorder=reorder,
                  engine=engine, probe=str(probe), k=int(problem.k),
                  backend="torch") as sp:
        pl = _plan_decide(problem, reorder, engine, probe, device)
        sp.set(scheme=pl.scheme, engine_chosen=pl.tune.engine, key=pl.key)
        return pl


def _plan_decide(problem: SpmvProblem, reorder: str, engine: str, probe,
                 device) -> Plan:
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

    reorder_ms = tune_ms = 0.0
    best = None                       # (cost, scheme, perm, rmat, tuneplan)
    scheme_costs: dict = {}
    for s in schemes:
        t0 = time.perf_counter()
        perm = (None if s == "baseline"
                else reorder_api.reorder(mat, s, seed, cache=False))
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
    if probe and engine == "auto" and tp.source != "probe":
        # the model picked the scheme; the empirical search refines the
        # engine choice on the winner only
        t0 = time.perf_counter()
        tp = tune_mod.tune(rmat, probe=probe, dtype=problem.dtype,
                           use_kernel=use_kernel, k=k, device=device)
        tune_ms += (time.perf_counter() - t0) * 1e3

    return Plan(scheme=scheme, seed=seed, engine_request=engine, tune=tp,
                k=k, dtype_name=problem.dtype_name(), probe=probe,
                use_kernel=use_kernel, mat_shape=tuple(mat.shape), mat_nnz=mat.nnz, key=key,
                scheme_costs=scheme_costs, reorder_ms=reorder_ms,
                tune_ms=tune_ms,
                plan_ms=(time.perf_counter() - t_start) * 1e3,
                perm=None if perm is None else np.asarray(perm, np.int64),
                _mat=mat, _rmat=rmat)
