"""Micro-batching SpMV service — the production-hardened operator front-end.

The ROADMAP north star ("serve heavy traffic from millions of users") means
concurrent `y = A @ x` requests against a set of planned operators. This
service coalesces concurrent same-matrix requests into ONE SpMM call

    Y[:, 0..b) = A @ [x_0 | x_1 | ... | x_{b-1}]

so the matrix bytes are paid once per batch — the amortization the k-aware
tuner (core/spmv/tune.py) models — and hardens that front-end for real
traffic along four axes (DESIGN.md "Serving & degradation"):

* **Bounded residency.** Resident operators live in a memory-budgeted LRU
  (`memory_budget_bytes`): device bytes are accounted per operator
  (opcache.operator_nbytes) and the least-recently-used operators are
  evicted past the budget. Eviction drops device arrays ONLY — the plan
  survives in the content-addressed plan store, so an evicted key reloads
  with zero re-tune on its next request.
* **Admission control + QoS.** Per-key (`max_queue`) and global
  (`max_queue_global` requests / `max_queue_bytes` payload bytes) queue
  limits; overload surfaces as TYPED retryable errors (serving/errors.py)
  under one of three policies — `"reject"` (refuse the newcomer with
  `QueueFull.retry_after_ms`), `"shed-oldest"` (fail the oldest queued
  request of the lowest-priority key with `RequestShed` and admit the
  newcomer), `"degrade-to-k1"` (admit, and above the half-full watermark
  the dispatcher stops waiting out batch windows — latency-optimal
  coalescing degrades, possibly to singleton batches, so the backlog
  drains at maximum rate). Keys carry priority classes
  (`register(priority=)`); the dispatcher serves the highest class first
  and sheds from the lowest.
* **Dynamic matrices.** `update_values(key, vals)` swaps values under an
  UNCHANGED structure hash: the plan is kept (`Plan.rebuild` — permute +
  convert under the frozen scheme/engine decision, no replan, no re-tune)
  and the operator is swapped atomically. `update_structure(key, mat)`
  keeps serving the STALE operator while a background thread replans the
  new structure, then swaps matrix + plan + operator atomically; a
  staleness bound (`max_staleness_s`) gates dispatch once exceeded until
  the replan lands.
* **SLO observability.** `stats()` is one self-consistent snapshot (taken
  under the service lock): p50/p95/p99 end-to-end latency from a bounded
  reservoir, throughput, shed/eviction rates, coalesce ratio, resident
  bytes vs budget, and counters that balance —
  requests == results + sheds + errors + pending.

The dispatcher sleeps on genuine condition-variable wakeups (notify on
enqueue / drain / replan) — a quiescent service performs ZERO wakeups
(`stats()["wakeups"]` is the regression counter), where the pre-hardening
dispatcher polled every 50 ms.

Policy (classic micro-batching): requests enqueue per matrix key; the
dispatcher serves the highest-priority class first, and within it the key
whose batch window expired, else a full batch, else the oldest request. A
batch closes at `max_batch` requests or `window_ms` after its oldest
request. Operators resolve once per key through the pipeline
(core/spmv/plan.py `plan` + `Plan.build`, persistent plan store) with a
k=max_batch-specialized plan; the service may reorder internally
(`reorder=`) — operators carry their permutation, so requests and
responses stay in the ORIGINAL index space.

Equivalence guarantee: request j of a coalesced batch receives column j of
`op.matmul(X)`, which matches the unbatched `op(x_j)` to fp32 accumulation
tolerance. A lone request takes `op(x)` (K1 under a sell plan), a batch
`op.matmul(X)` (K2 under sell, K3 under bcsr). The open-loop load
harness is serving/traffic.py.

The device. The service runs its operators on one device, the card by
default (`device=None`; it raises without one), the CPU when the caller
passes `device="cpu"`. A batch is stacked on the host as numpy, copied
to the device once in the service's dtype, and its result copied back
once; the Futures carry numpy arrays. Three threads touch the device: the
dispatcher (`_run`), the background replanner (`_replan_loop`) and the
caller of `update_values`, whose rebuild runs in its own thread. Each
uses its current stream, the legacy default stream of the device, so an
operator built on one thread is ordered before its first use on another.

Sharded keys. A key registered with a non-trivial `topology` (or a service
built with one) plans through `plan(topology=..., partition=...)` and
serves through a ShardedOperator, still in the original index space; on
one card its panels run simulated (core/spmv/distributed.py). As in the
JAX package, `update_values`/`update_structure` on a sharded key of a
plain service raise RoutedElsewhere: per-shard swaps and replans belong
to the multi-shard router (router/service.py), whose per-mesh service
allows them.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.sparse.csr import CSRMatrix
from ..core.spmv import delta as delta_mod
from ..core.spmv import opcache
from ..core.spmv import plan as plan_mod
from ..device import resolve_device, torch_dtype
from .errors import (BadRequest, KeyBusy, QueueFull, RequestShed,
                     RoutedElsewhere, ServiceClosed, UnregisteredKey)

OVERLOAD_POLICIES = ("reject", "shed-oldest", "degrade-to-k1")

_RESERVOIR_SIZE = 2048
_SERVICE_IDS = itertools.count(1)

# every legacy integer/float counter of SpmvService.stats(); each backs
# onto a process-wide obs counter `service.<key>{service=<sid>}`
_STAT_KEYS = ("requests", "batches", "dispatches", "errors", "results",
              "sheds", "rejected", "batch_size_sum", "batch_size_max",
              "wait_ms_sum", "wakeups", "op_builds", "op_reloads",
              "evictions", "budget_overruns", "value_swaps",
              "replans", "replan_errors")


class _RegistryStats:
    """Dict-like stats view backed by the obs metrics registry.

    Every legacy counter key reads/writes a per-service labelled counter
    in `repro_torch.obs` — `SpmvService.stats()` is therefore a *view*
    over the registry (obs.snapshot() shows the same numbers) while every
    existing `self._stats["x"] += 1` mutation site keeps working
    verbatim.

    Lock discipline is unchanged: all mutation happens under the
    service's `_cv`, so a `stats()` read under `_cv` is still one atomic
    cut across all counters (the per-metric locks are redundant here but
    harmless). `batch_hist` stays a local Counter — it is a dict-valued
    legacy key, not a scalar metric.
    """

    def __init__(self, sid: str):
        self.sid = sid
        self._c = {k: obs.counter(f"service.{k}", service=sid)
                   for k in _STAT_KEYS}
        self.batch_hist: collections.Counter = collections.Counter()

    def __getitem__(self, key):
        if key == "batch_hist":
            return self.batch_hist
        return self._c[key].value

    def __setitem__(self, key, value):
        if key == "batch_hist":
            self.batch_hist = value
        else:
            self._c[key].set(value)

    def as_dict(self) -> dict:
        d = {k: c.value for k, c in self._c.items()}
        d["batch_hist"] = dict(self.batch_hist)
        return d


@dataclasses.dataclass
class _Request:
    key: str
    x: np.ndarray
    future: Future
    t_submit: float


class _Reservoir:
    """Bounded latency reservoir (Vitter's Algorithm R): a uniform sample
    of all observations in O(size) memory, so p50/p95/p99 stay meaningful
    over unbounded request streams. Deterministic per service (seeded)."""

    def __init__(self, size: int = _RESERVOIR_SIZE, seed: int = 0):
        self.size = int(size)
        self.count = 0
        self._buf: list = []
        self._rng = np.random.default_rng(seed)

    def add(self, value: float) -> None:
        self.count += 1
        if len(self._buf) < self.size:
            self._buf.append(float(value))
        else:
            j = int(self._rng.integers(self.count))
            if j < self.size:
                self._buf[j] = float(value)

    def snapshot(self) -> list:
        return list(self._buf)


def _host(y: torch.Tensor) -> np.ndarray:
    """A result as host numpy (numpy has no bf16: bf16 comes back f32)."""
    if y.dtype == torch.bfloat16:
        y = y.float()
    return y.cpu().numpy()


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an ascending list (NaN when empty)."""
    if not sorted_vals:
        return float("nan")
    i = max(0, min(len(sorted_vals) - 1,
                   int(np.ceil(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[i]


class SpmvService:
    """Queue + coalesce concurrent (matrix_key, x) requests into SpMM calls.

    Usage:
        svc = SpmvService(max_batch=8, window_ms=2.0,
                          memory_budget_bytes=64 << 20, overload="reject")
        svc.register("mesh", mat, priority=1)
        fut = svc.submit("mesh", x)          # -> concurrent.futures.Future
        y = fut.result()                      # typed errors: serving.errors
        svc.update_values("mesh", new_vals)   # same structure: no replan
        svc.update_structure("mesh", mat2)    # background replan, stale ok
        print(svc.stats()["slo"])             # p50/p95/p99, shed rate, ...
        svc.close()

    Also usable as a context manager (close() on exit).
    """

    # Sharded keys refuse update_values/update_structure on a PLAIN
    # service (RoutedElsewhere): the per-shard replan lifecycle belongs
    # to the multi-shard router, whose per-mesh service (router/
    # service.py `_MeshService`) flips this.
    _allow_sharded_updates = False

    def __init__(self, engine: str = "auto", max_batch: int = 32,
                 window_ms: float = 2.0, use_kernel: str = "auto",
                 dtype=None, cache: bool = True, probe: bool = False,
                 max_queue: int = 1024, reorder: str = "baseline",
                 topology=None, partition: str = "auto",
                 memory_budget_bytes: Optional[int] = None,
                 overload: str = "reject",
                 max_queue_global: Optional[int] = None,
                 max_queue_bytes: Optional[int] = None,
                 max_staleness_s: Optional[float] = None,
                 reservoir_size: int = _RESERVOIR_SIZE, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(f"overload must be one of {OVERLOAD_POLICIES}, "
                             f"got {overload!r}")
        if memory_budget_bytes is not None and memory_budget_bytes <= 0:
            raise ValueError("memory_budget_bytes must be positive or None")
        self.device = resolve_device(device)
        self.engine = engine
        self.reorder = reorder
        self.topology = topology
        self.partition = partition
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_queue_global = (None if max_queue_global is None
                                 else int(max_queue_global))
        self.max_queue_bytes = (None if max_queue_bytes is None
                                else int(max_queue_bytes))
        self.memory_budget_bytes = (None if memory_budget_bytes is None
                                    else int(memory_budget_bytes))
        self.overload = overload
        self.max_staleness_s = max_staleness_s
        self.window_s = float(window_ms) * 1e-3
        self.use_kernel = use_kernel
        self.cache = cache
        self.probe = probe
        self._dtype = torch_dtype(dtype)
        self._matrices: Dict[str, CSRMatrix] = {}
        self._schemes: Dict[str, str] = {}
        self._topologies: Dict[str, object] = {}
        self._priorities: Dict[str, int] = {}
        self._gen: collections.Counter = collections.Counter()
        # key -> (gen, operator, nbytes); insertion order IS the LRU order
        # (move_to_end on every touch, evict from the front)
        self._ops: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._resident_bytes = 0
        self._resident_bytes_max = 0
        # key -> (structure_key, scheme, Plan): the frozen decision the
        # dynamic-matrix path rebuilds from without replanning
        self._plans: Dict[str, tuple] = {}
        self._dirty: Dict[str, bool] = {}   # values diverged from plan store
        self._build_info: Dict[str, dict] = {}
        self._queues: Dict[str, collections.deque] = {}
        self._queued = 0                    # total queued requests
        self._queued_bytes = 0              # total queued payload bytes
        self._cv = threading.Condition()
        self._op_lock = threading.Lock()    # serializes operator builds;
        # ordering discipline: _op_lock may be taken first and _cv inside
        # it, NEVER the reverse
        self._stop = False
        self._inflight = 0                  # dispatching batches
        self._inflight_reqs = 0             # requests inside those batches
        self._key_inflight: collections.Counter = collections.Counter()
        self._current_batch: Optional[list] = None
        self._replan_pending: Dict[str, dict] = {}
        self._replan_q: collections.deque = collections.deque()
        self._replanner: Optional[threading.Thread] = None
        self._latency = _Reservoir(reservoir_size)
        self._t_start = time.monotonic()
        self.sid = f"svc{next(_SERVICE_IDS)}"
        self._stats = _RegistryStats(self.sid)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="spmv-service-dispatch")
        self._worker.start()

    # -- registry ----------------------------------------------------------
    def register(self, key: str, mat: CSRMatrix,
                 reorder: Optional[str] = None, topology=None,
                 priority: int = 0) -> None:
        """Make `key` servable. Operator build is lazy (first batch).

        reorder overrides the service-wide scheme for this key, topology
        (a Topology) overrides the service-wide topology (a SHARDED key
        serves through a ShardedOperator), and priority is the key's QoS
        class: the dispatcher serves higher classes first and the
        shed-oldest policy sheds from the lowest class. Requests stay in
        the original index space either way.

        Re-registering a key drops its memoized operator — but when the
        new matrix has the SAME structure hash, the kept plan makes the
        next resolve a value-swap rebuild, not a replan. Re-registration
        is REFUSED (KeyBusy) while the key has queued/in-flight requests
        or a structure replan in flight — a request validated against
        matrix A must never be answered from matrix B (flush() first)."""
        with self._cv:
            if self._stop:
                raise ServiceClosed("service is closed")
            if key in self._matrices and (self._queues[key]
                                          or self._key_inflight[key]
                                          or key in self._replan_pending):
                raise KeyBusy(
                    f"cannot re-register {key!r} with pending requests; "
                    f"flush() first (or update_values/update_structure)")
            self._matrices[key] = mat
            self._schemes[key] = self.reorder if reorder is None else reorder
            self._topologies[key] = (self.topology if topology is None
                                     else topology)
            self._priorities[key] = int(priority)
            # bumping the generation under _cv invalidates any memoized
            # operator atomically with the matrix swap — operator() only
            # trusts an entry whose generation matches the matrix it read
            self._gen[key] += 1
            self._evict_locked(key)
            hint = self._plans.get(key)
            if hint is not None:
                if (hint[0] == plan_mod.structure_key(mat)
                        and hint[1] == self._schemes[key]):
                    self._dirty[key] = True    # same structure: value swap
                else:
                    del self._plans[key]       # new structure: fresh plan
                    self._dirty.pop(key, None)
            self._queues.setdefault(key, collections.deque())

    # -- operator residency (memory-budgeted LRU) --------------------------
    def _evict_locked(self, key: str) -> None:
        """Drop `key`'s resident operator (if any), adjusting the gauge."""
        ent = self._ops.pop(key, None)
        if ent is not None:
            self._resident_bytes -= ent[2]
            self._sync_lru_gauges_locked()

    def _sync_lru_gauges_locked(self) -> None:
        obs.gauge("service.resident_bytes", service=self.sid).set(
            self._resident_bytes)
        obs.gauge("service.resident_ops", service=self.sid).set(
            len(self._ops))

    def _op_nbytes(self, op) -> int:
        """Device bytes an operator is charged against the memory
        budget."""
        return opcache.operator_nbytes(op)

    def _install_locked(self, key: str, gen: int, op, nbytes: int):
        """Install a freshly built operator under the memory budget:
        evict LRU-first residents until the newcomer fits, so the
        resident-bytes gauge NEVER exceeds the budget. An operator that
        alone exceeds the budget is served transiently (never tracked as
        resident) and counted as a budget overrun."""
        self._evict_locked(key)
        budget = self.memory_budget_bytes
        if budget is not None and nbytes > budget:
            self._stats["evictions"] += 1
            self._stats["budget_overruns"] += 1
            return
        if budget is not None:
            while self._resident_bytes + nbytes > budget and self._ops:
                k2, (_, _, b2) = next(iter(self._ops.items()))
                del self._ops[k2]
                self._resident_bytes -= b2
                self._stats["evictions"] += 1
        self._ops[key] = (gen, op, nbytes)
        self._resident_bytes += nbytes
        self._resident_bytes_max = max(self._resident_bytes_max,
                                       self._resident_bytes)
        self._sync_lru_gauges_locked()

    def operator(self, key: str):
        """Resolve (and memoize, budget permitting) the operator for
        `key` via the pipeline facade, tuned for this service's max batch
        width. An evicted key resolves through the plan store (device
        arrays reload, zero re-tune); a key whose values were swapped
        since its plan was stored rebuilds from the kept plan (format
        conversion only, no replan). The returned operator accepts
        original-index-space vectors."""
        while True:
            with self._cv:
                if key not in self._matrices:
                    raise UnregisteredKey(f"unregistered matrix key {key!r}")
                ent = self._ops.get(key)
                gen = self._gen[key]
                if ent is not None and ent[0] == gen:
                    self._ops.move_to_end(key)
                    return ent[1]
            with self._op_lock:
                with self._cv:
                    ent = self._ops.get(key)
                    gen = self._gen[key]
                    if ent is not None and ent[0] == gen:
                        self._ops.move_to_end(key)
                        return ent[1]
                    mat = self._matrices[key]
                    scheme = self._schemes[key]
                    topology = self._topologies.get(key)
                    hint = self._plans.get(key)
                    dirty = self._dirty.get(key, False)
                op, pl, info = self._build_operator(mat, scheme, topology,
                                                    hint, dirty)
                nb = self._op_nbytes(op)
                with self._cv:
                    if self._gen[key] != gen:
                        continue       # superseded mid-build: resolve again
                    self._plans[key] = (plan_mod.structure_key(mat),
                                        scheme, pl)
                    self._build_info[key] = info
                    self._stats["op_builds"] += 1
                    if info.get("cache_hit"):
                        self._stats["op_reloads"] += 1
                    self._install_locked(key, gen, op, nb)
                    return op

    def _build_operator(self, mat, scheme, topology, hint, dirty):
        """Build outside the service lock. Returns (op, plan, build_info).

        When the key's values have diverged from the plan store (dirty)
        and the kept plan still matches the structure + scheme, rebuild
        under the frozen decision — plan() would otherwise replan from
        scratch because its content key hashes the values. Sharded plans
        take the same shortcut: Plan.rebuild repacks the frozen layout
        (partition, panel split, schedule all kept)."""
        if (dirty and hint is not None
                and hint[0] == plan_mod.structure_key(mat)
                and hint[1] == scheme):
            op = hint[2].rebuild(mat, use_kernel=self.use_kernel,
                                 device=self.device)
            return op, hint[2], op.build_info
        pl = plan_mod.plan(
            plan_mod.SpmvProblem(mat, k=self.max_batch, dtype=self._dtype,
                                 hints={"use_kernel": self.use_kernel}),
            reorder=scheme, engine=self.engine, probe=self.probe,
            cache=self.cache, device=self.device, topology=topology,
            partition=self.partition)
        op = pl.build(device=self.device, cache=self.cache)
        return op, pl, op.build_info

    # -- dynamic matrices --------------------------------------------------
    def update_values(self, key: str, vals) -> None:
        """Swap `key`'s numeric values in place — the structure hash is
        unchanged by construction, so the plan is KEPT: the new operator
        is a `Plan.rebuild` (permute + format conversion under the frozen
        scheme/engine decision; zero reorder, zero re-tune, no replan)
        and is swapped in atomically. In-flight batches complete against
        the old values; later dispatches see the new ones."""
        vals = np.asarray(vals)
        with self._cv:
            if self._stop:
                raise ServiceClosed("service is closed")
            if key not in self._matrices:
                raise UnregisteredKey(f"unregistered matrix key {key!r}")
            if (not self._allow_sharded_updates
                    and plan_mod.topology_mod.normalize(
                        self._topologies.get(key)) is not None):
                raise RoutedElsewhere(
                    f"update_values on sharded key {key!r}: per-shard "
                    f"swaps belong to the router")
            if key in self._replan_pending:
                raise KeyBusy(f"structure replan in flight for {key!r}")
            mat = self._matrices[key]
            if vals.shape != mat.vals.shape:
                raise BadRequest(
                    f"vals for {key!r} must have shape {mat.vals.shape}, "
                    f"got {vals.shape}")
            new_mat = CSRMatrix(rowptr=mat.rowptr, cols=mat.cols,
                                vals=vals.astype(mat.vals.dtype, copy=False),
                                shape=mat.shape)
            gen = self._gen[key] + 1
            self._gen[key] = gen
            self._matrices[key] = new_mat
            self._dirty[key] = True
            hint = self._plans.get(key)
            scheme = self._schemes[key]
        if hint is None or hint[1] != scheme:
            return          # no operator planned yet: first dispatch plans
        # rebuild OUTSIDE the lock — the old operator keeps serving
        op = hint[2].rebuild(new_mat, use_kernel=self.use_kernel,
                             device=self.device)
        nb = self._op_nbytes(op)
        with self._cv:
            if self._gen[key] == gen and not self._stop:
                self._build_info[key] = op.build_info
                self._install_locked(key, gen, op, nb)
                self._stats["value_swaps"] += 1
                self._cv.notify_all()

    def update_structure(self, key: str, mat: Optional[CSRMatrix] = None,
                         staleness_s: Optional[float] = None,
                         delta=None) -> Future:
        """Replace `key`'s matrix with one of a DIFFERENT structure. The
        stale operator keeps serving while a background thread replans
        (reorder + tune on the new structure); matrix, plan and operator
        then swap atomically. Returns a Future resolving to the new
        generation (or the replan error — the stale operator keeps
        serving on failure).

        Either pass the full replacement matrix (`mat=`) or an
        incremental `delta=` (core.spmv.delta.StructureDelta) describing
        the edit against the CURRENT matrix; with a delta the background
        worker first tries `Plan.apply_delta` (reuse the frozen tuning
        decision + permutation, skip reorder and re-tune entirely) and
        only falls back to a full replan when the delta is over the
        churn/bandwidth thresholds (DeltaTooLarge).

        staleness_s (default: the service's max_staleness_s) bounds how
        long the stale operator may keep answering: once exceeded, the
        key's dispatch GATES on the replan instead of serving staler
        results. The matrix shape must be unchanged (queued requests were
        validated against it)."""
        if (mat is None) == (delta is None):
            raise BadRequest("update_structure takes exactly one of "
                             "mat= or delta=")
        with self._cv:
            if self._stop:
                raise ServiceClosed("service is closed")
            if key not in self._matrices:
                raise UnregisteredKey(f"unregistered matrix key {key!r}")
            if (not self._allow_sharded_updates
                    and plan_mod.topology_mod.normalize(
                        self._topologies.get(key)) is not None):
                raise RoutedElsewhere(
                    f"update_structure on sharded key {key!r}: the "
                    f"per-shard replan lifecycle belongs to the router")
            if key in self._replan_pending:
                raise KeyBusy(f"structure replan already in flight for "
                              f"{key!r}")
            if delta is not None:
                # materialize eagerly so malformed deltas (BadDelta, a
                # ValueError) surface at the call site, not in the Future
                mat = delta.apply_to(self._matrices[key])
            if tuple(mat.shape) != tuple(self._matrices[key].shape):
                raise BadRequest(
                    f"update_structure must keep the shape "
                    f"{tuple(self._matrices[key].shape)}, got "
                    f"{tuple(mat.shape)} (queued x would be malformed)")
            bound = self.max_staleness_s if staleness_s is None \
                else staleness_s
            now = time.monotonic()
            fut: Future = Future()
            self._replan_pending[key] = {
                "mat": mat, "delta": delta, "t_req": now, "future": fut,
                "deadline": (float("inf") if bound is None
                             else now + float(bound)),
            }
            self._replan_q.append(key)
            if self._replanner is None or not self._replanner.is_alive():
                self._replanner = threading.Thread(
                    target=self._replan_loop, daemon=True,
                    name="spmv-service-replan")
                self._replanner.start()
            self._cv.notify_all()
        return fut

    def _replan_loop(self) -> None:
        while True:
            with self._cv:
                while not self._replan_q and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                key = self._replan_q.popleft()
                ent = self._replan_pending.get(key)
                if ent is None:
                    continue
                mat, scheme = ent["mat"], self._schemes[key]
                topology = self._topologies.get(key)
                hint = self._plans.get(key)
                dirty = self._dirty.get(key, False)
                delta = ent.get("delta")
                skey_cur = plan_mod.structure_key(self._matrices[key])
            try:
                with obs.span("serve.replan", key=key,
                              delta=delta is not None):
                    op = pl = info = None
                    if (delta is not None and hint is not None
                            and hint[1] == scheme and hint[0] == skey_cur):
                        # incremental path: keep the frozen tuning
                        # decision + perm, skip reorder/tune entirely;
                        # refuse -> full replan below
                        try:
                            pl = hint[2].apply_delta(delta)
                            op = (pl.rebuild(mat,
                                             use_kernel=self.use_kernel,
                                             device=self.device)
                                  if dirty else pl.build(device=self.device,
                                                         cache=self.cache))
                            info = op.build_info
                        except delta_mod.DeltaTooLarge:
                            op = pl = info = None
                    if op is None:
                        op, pl, info = self._build_operator(
                            mat, scheme, topology, None, False)
                    nb = self._op_nbytes(op)
            except Exception as e:
                with self._cv:
                    if self._replan_pending.get(key) is ent:
                        del self._replan_pending[key]
                    self._stats["replan_errors"] += 1
                    self._cv.notify_all()
                ent["future"].set_exception(e)
                continue
            with self._cv:
                ok = (not self._stop and key in self._matrices
                      and self._replan_pending.get(key) is ent)
                if ok:
                    gen = self._gen[key] + 1
                    self._gen[key] = gen
                    self._matrices[key] = mat
                    self._plans[key] = (plan_mod.structure_key(mat),
                                        scheme, pl)
                    self._dirty[key] = False
                    self._build_info[key] = info
                    self._install_locked(key, gen, op, nb)
                    del self._replan_pending[key]
                    self._stats["replans"] += 1
                    self._cv.notify_all()
            if ok:
                ent["future"].set_result(gen)
            else:
                ent["future"].set_exception(
                    ServiceClosed("service closed before replan landed"))

    # -- request path ------------------------------------------------------
    def _retry_after_ms_locked(self) -> float:
        """Backlog drain-time estimate: batches queued x batch window."""
        window = max(self.window_s * 1e3, 0.5)
        return window * (1.0 + self._queued / max(self.max_batch, 1))

    def _over_limit_locked(self, key: str,
                           nbytes: int) -> Optional[Tuple[str, str]]:
        """(reason, scope) of the first violated admission limit, or
        None. scope is "key" (only shedding from `key`'s own queue can
        relieve it) or "global"."""
        if len(self._queues[key]) >= self.max_queue:
            return (f"queue for {key!r} is full ({self.max_queue} "
                    f"pending)", "key")
        if (self.max_queue_global is not None
                and self._queued >= self.max_queue_global):
            return (f"global queue is full ({self.max_queue_global} "
                    f"pending)", "global")
        if (self.max_queue_bytes is not None and self._queued
                and self._queued_bytes + nbytes > self.max_queue_bytes):
            return (f"global queue payload is full "
                    f"({self._queued_bytes} of {self.max_queue_bytes} B)",
                    "global")
        return None

    def _shed_oldest_locked(self, incoming_key: str, scope: str) -> bool:
        """Fail one queued request with RequestShed to make room. The
        victim is scoped to the violated limit: a full PER-KEY queue can
        only be relieved from that key's own queue (oldest first —
        classic drop-oldest; shedding other keys would drain unrelated
        work without freeing a slot), a GLOBAL limit from the oldest
        request of the lowest-priority key. Returns False when nothing
        may be shed (every eligible request outranks the newcomer)."""
        victim_key, victim_prio = None, None
        candidates = ([incoming_key] if scope == "key"
                      else list(self._queues))
        for k in candidates:
            q = self._queues[k]
            if not q:
                continue
            p = self._priorities.get(k, 0)
            if victim_prio is None or p < victim_prio or \
                    (p == victim_prio
                     and q[0].t_submit < self._queues[victim_key][0].t_submit):
                victim_key, victim_prio = k, p
        if victim_key is None \
                or victim_prio > self._priorities.get(incoming_key, 0):
            return False
        r = self._queues[victim_key].popleft()
        self._queued -= 1
        self._queued_bytes -= r.x.nbytes
        self._stats["sheds"] += 1
        try:
            r.future.set_exception(RequestShed(
                f"shed to admit newer work (overload policy shed-oldest)",
                retry_after_ms=self._retry_after_ms_locked()))
        except Exception:       # already failed by a wedged close()
            pass
        return True

    def submit(self, key: str, x) -> Future:
        """Enqueue one y = A_key @ x request; returns a Future of np [m].

        Raises (serving/errors.py — all keep their legacy builtin bases):
          ServiceClosed    after close()
          UnregisteredKey  unknown key
          BadRequest       x has the wrong shape
          QueueFull        admission refused (retryable; retry_after_ms)
        Under overload="shed-oldest" the newcomer is admitted and the
        oldest lowest-priority queued request fails with RequestShed."""
        x = np.asarray(x)
        with obs.span("serve.submit", key=key), self._cv:
            if self._stop:
                raise ServiceClosed("service is closed")
            if key not in self._matrices:
                raise UnregisteredKey(f"unregistered matrix key {key!r}")
            n = self._matrices[key].shape[1]
            # reject malformed requests HERE: a bad x inside a coalesced
            # batch would otherwise fail every well-formed neighbour
            if x.shape != (n,):
                raise BadRequest(
                    f"x for {key!r} must have shape ({n},), got {x.shape}")
            # admission control: bounded queues — shed or reject loudly
            # instead of letting a fast producer grow pending vectors
            # unboundedly
            limit = self._over_limit_locked(key, x.nbytes)
            while limit is not None and self.overload == "shed-oldest":
                if not self._shed_oldest_locked(key, limit[1]):
                    break
                limit = self._over_limit_locked(key, x.nbytes)
            if limit is not None:
                self._stats["rejected"] += 1
                raise QueueFull(
                    f"backpressure: {limit[0]}",
                    retry_after_ms=self._retry_after_ms_locked())
            fut: Future = Future()
            self._queues[key].append(
                _Request(key, x, fut, time.monotonic()))
            self._queued += 1
            self._queued_bytes += x.nbytes
            self._stats["requests"] += 1
            self._cv.notify_all()
        return fut

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every queued request has been dispatched & resolved.
        Event-driven: woken by the dispatcher's drain notifies, no
        polling loop."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while any(self._queues.values()) or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("flush timed out")
                self._cv.wait(remaining)

    def close(self, timeout: float = 60.0) -> None:
        """Drain outstanding work (up to timeout), then stop the
        dispatcher and replanner. The service ALWAYS stops — if draining
        times out the TimeoutError is re-raised after shutdown, never
        before it — and any request still queued (or stuck in a wedged
        dispatch) gets its Future failed with ServiceClosed, so no caller
        blocked in result() hangs forever."""
        err = None
        try:
            self.flush(timeout=timeout)
        except TimeoutError as e:
            err = e
        with self._cv:
            self._stop = True
            leftovers = [r for q in self._queues.values() for r in q]
            dropped = len(leftovers)
            for q in self._queues.values():
                q.clear()
            self._queued = 0
            self._queued_bytes = 0
            self._stats["errors"] += dropped
            pending_replans = list(self._replan_pending.values())
            self._replan_pending.clear()
            self._replan_q.clear()
            self._cv.notify_all()
        self._worker.join(timeout=10.0)
        if self._replanner is not None:
            self._replanner.join(timeout=10.0)
        if self._worker.is_alive():
            # dispatch wedged in device code: fail its batch best-effort
            # (the zombie daemon thread's late set_result is swallowed by
            # _dispatch's InvalidStateError guard)
            with self._cv:
                wedged = list(self._current_batch or [])
                self._stats["errors"] += len(wedged)
                leftovers.extend(wedged)
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(
                    ServiceClosed("service closed before dispatch"))
        for ent in pending_replans:
            if not ent["future"].done():
                ent["future"].set_exception(
                    ServiceClosed("service closed before replan landed"))
        if err is not None:
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """One self-consistent snapshot: every counter, gauge and the
        latency reservoir are read under a single lock acquisition, so
        the invariant requests == results + sheds + errors + pending
        holds in ANY snapshot, not just at quiescence.

        Since the obs layer landed this is a VIEW over the process-wide
        metrics registry: each legacy key reads the per-service counter
        `service.<key>{service=<sid>}` that obs.snapshot() also reports
        (all mutation still happens under `_cv`, preserving snapshot
        atomicity)."""
        with self._cv:
            s = self._stats.as_dict()
            s["queued"] = self._queued
            s["queued_bytes"] = self._queued_bytes
            s["inflight_requests"] = self._inflight_reqs
            s["pending"] = self._queued + self._inflight_reqs
            s["resident_bytes"] = self._resident_bytes
            s["resident_bytes_max"] = self._resident_bytes_max
            s["resident_ops"] = len(self._ops)
            s["memory_budget_bytes"] = self.memory_budget_bytes
            s["replans_pending"] = len(self._replan_pending)
            op_hits = {k: v["cache_hit"] for k, v in self._build_info.items()}
            lat = sorted(self._latency.snapshot())
            lat_count = self._latency.count
            elapsed = max(time.monotonic() - self._t_start, 1e-9)
        b = max(s["batches"], 1)
        s["avg_batch"] = s["batch_size_sum"] / b       # dispatched reqs/batch
        s["avg_wait_ms"] = s["wait_ms_sum"] / b
        # DISPATCHED requests per dispatch (error batches included) — the
        # amortization the service exists for; computed from completed
        # work only, so a mid-stream snapshot is not inflated by requests
        # still sitting in the queues
        s["coalesce_ratio"] = (s["batch_size_sum"] + s["errors"]) \
            / max(s["dispatches"], 1)
        s["op_cache_hits"] = op_hits
        s["slo"] = {
            "p50_ms": _percentile(lat, 50.0),
            "p95_ms": _percentile(lat, 95.0),
            "p99_ms": _percentile(lat, 99.0),
            "latency_samples": lat_count,
            "throughput_rps": s["results"] / elapsed,
            "shed_rate": s["sheds"] / max(s["requests"], 1),
            "reject_rate": s["rejected"] / max(s["requests"]
                                               + s["rejected"], 1),
            "eviction_rate": s["evictions"] / max(s["op_builds"], 1),
            "coalesce_ratio": s["coalesce_ratio"],
        }
        return s

    # -- dispatcher --------------------------------------------------------
    def _gated_locked(self, key: str, now: float) -> bool:
        """True when `key` must not dispatch: its structure replan has
        exceeded the staleness bound, so serving the stale operator any
        longer would violate it. The replanner's completion notify lifts
        the gate (replan failure also lifts it — best-effort bound)."""
        ent = self._replan_pending.get(key)
        return ent is not None and now > ent["deadline"]

    def _drain_locked(self) -> bool:
        """degrade-to-k1 overload mode: above the half-full watermark the
        dispatcher stops waiting out batch windows and drains whatever is
        queued immediately (coalescing degrades, possibly to k=1)."""
        if self.overload != "degrade-to-k1":
            return False
        if (self.max_queue_global is not None
                and self._queued >= max(1, self.max_queue_global // 2)):
            return True
        wm = max(1, self.max_queue // 2)
        return any(len(q) >= wm for q in self._queues.values())

    def _pick_key(self) -> Optional[str]:
        """Next key to serve (None if nothing is dispatchable).

        QoS first: only the highest-priority class with pending requests
        is considered (strict classes — shedding policies, not the
        scheduler, protect low classes under sustained load). Within the
        class: (1) the oldest request whose batch window already expired
        — the latency bound always wins; (2) any key with a FULL batch
        ready; (3) the oldest pending request. Staleness-gated keys are
        skipped entirely (their replan notify re-wakes the dispatcher).
        """
        now = time.monotonic()
        cands = []                    # (prio, t_oldest, full, key)
        for key, q in self._queues.items():
            if not q or self._gated_locked(key, now):
                continue
            cands.append((self._priorities.get(key, 0), q[0].t_submit,
                          len(q) >= self.max_batch, key))
        if not cands:
            return None
        top = max(c[0] for c in cands)
        cands = [c for c in cands if c[0] == top]
        expired = [c for c in cands if now >= c[1] + self.window_s]
        pool = expired or [c for c in cands if c[2]] or cands
        return min(pool, key=lambda c: c[1])[3]

    def _run(self) -> None:
        while True:
            with self._cv:
                key = self._pick_key()
                while key is None and not self._stop:
                    # pure condition-variable sleep: a quiescent service
                    # performs ZERO wakeups (tests assert on the counter);
                    # submit/update/replan/close all notify
                    self._cv.wait()
                    self._stats["wakeups"] += 1
                    key = self._pick_key()
                if key is None and self._stop:
                    return
                # batch window: wait for more same-key arrivals, bounded by
                # the oldest request's deadline and the batch size cap —
                # re-evaluating the pick each wake so a key that becomes
                # dispatchable (full batch / expired window) preempts. The
                # wait is EXACTLY the remaining window (no poll cap): each
                # wake is an enqueue notify or the single deadline expiry.
                q = self._queues[key]
                deadline = q[0].t_submit + self.window_s if q else 0.0
                while (q and len(q) < self.max_batch and not self._stop
                       and not self._drain_locked()
                       and time.monotonic() < deadline):
                    self._cv.wait(max(deadline - time.monotonic(), 1e-4))
                    self._stats["wakeups"] += 1
                    nk = self._pick_key()
                    if nk is None:
                        q = self._queues[key]   # emptied externally
                        break
                    if nk != key:
                        key = nk
                    q = self._queues[key]
                    deadline = q[0].t_submit + self.window_s if q else 0.0
                batch = [q.popleft()
                         for _ in range(min(self.max_batch, len(q)))]
                # defensive: the queue can be emptied externally while we
                # waited (forced shutdown paths clear it under _cv)
                if not batch:
                    continue
                self._queued -= len(batch)
                self._queued_bytes -= sum(r.x.nbytes for r in batch)
                self._inflight += 1
                self._inflight_reqs += len(batch)
                self._key_inflight[key] += 1
                self._current_batch = batch
            try:
                self._dispatch(key, batch)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._inflight_reqs -= len(batch)
                    self._key_inflight[key] -= 1
                    self._current_batch = None
                    self._cv.notify_all()

    def _dispatch(self, key: str, batch: list) -> None:
        t0 = time.monotonic()
        try:
            with obs.span("serve.dispatch", key=key,
                          batch_size=len(batch)):
                op = self.operator(key)
                dt = self._dtype
                with obs.span("serve.execute", key=key,
                              batch_size=len(batch)):
                    if len(batch) == 1:
                        # a lone request takes the SpMV path: matmul's
                        # k-tile padding would do tile-width times the
                        # work for 1 column
                        y = _host(op(torch.as_tensor(
                            batch[0].x, dtype=dt,
                            device=self.device)))[:, None]
                    else:
                        # assemble on host, ONE device put per batch
                        x_block = torch.as_tensor(
                            np.stack([r.x for r in batch], axis=1),
                            dtype=dt, device=self.device)
                        y = _host(op.matmul(x_block))
        except Exception as e:                       # pragma: no cover
            with self._cv:
                self._stats["dispatches"] += 1
                self._stats["errors"] += len(batch)
            for r in batch:
                try:
                    r.future.set_exception(e)
                except Exception:    # already failed by a wedged close()
                    pass
            return
        done = time.monotonic()
        with self._cv:
            self._stats["dispatches"] += 1
            self._stats["batches"] += 1
            self._stats["batch_size_sum"] += len(batch)
            self._stats["batch_size_max"] = max(
                self._stats["batch_size_max"], len(batch))
            self._stats["batch_hist"][len(batch)] += 1
            self._stats["wait_ms_sum"] += (t0 - batch[0].t_submit) * 1e3
            self._stats["results"] += len(batch)
            for r in batch:
                self._latency.add((done - r.t_submit) * 1e3)
        for j, r in enumerate(batch):
            try:
                r.future.set_result(y[:, j])
            except Exception:        # already failed by a wedged close()
                pass
