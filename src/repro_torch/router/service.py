"""RoutedSpmvService — one serving front-end over a fleet of device
meshes.

The plain SpmvService serves every key from ONE topology and accounts
device memory as a single global number. This router scales that front
end out: a RoutingTable places each registered key onto one mesh of a
fleet (placement.py policies — bin-pack by estimated bytes, per-device
nnz balance, comm-model-aware co-placement), each mesh is served by its
own `_MeshService` (an SpmvService subclass whose budget bounds EVERY
device via per-device operator accounting), and requests dispatch through
a `router.dispatch` span to the owning mesh.

Updates are where the router earns its subclass: a plain service refuses
sharded-key updates (`RoutedElsewhere`), while `_MeshService` flips
`_allow_sharded_updates` — `update_values` is a sharded `Plan.rebuild`
(frozen partition/panel split/schedule, array repack only) and
`update_structure` replans in the BACKGROUND with a generation-tagged
swap per shard, so sibling keys on the same mesh keep serving the whole
time. Pass `delta=` (core.spmv.delta.StructureDelta) and the replanner
first tries `Plan.apply_delta` — reorder and tuner search skipped
entirely — falling back to a full replan only past the churn/bandwidth
thresholds.

Per-device budget invariant (why `_op_nbytes` is max x devices): the base
LRU tracks Sum_op charge(op) <= budget. With charge(op) =
max_d per_dev(op)[d] * ndev and budget = budget_per_device * ndev,

    Sum_op max_d per_dev(op)[d] <= budget_per_device

and device d's true residency Sum_op per_dev(op)[d] is bounded by the
left side — so NO device ever exceeds budget_per_device, and because
`_install_locked` evicts BEFORE installing, the bound holds even
transiently (each mesh service's `resident_bytes_max` high-water mark
stays within its budget). `bench.run --smoke-route` checks it.

The device. Every mesh service runs on the router's one device (`device=`,
the card by default; it raises without one unless the caller passes
`device="cpu"`). A mesh of d > 1 devices is a Topology: its sharded keys
run their d panels simulated, batched on that one device, and its
per-device budgets are the accounting of `operator_nbytes_per_device`
over those d devices — on one card the fleet checks routing, placement,
budgets and the update lifecycle, not multi-card speed. Each mesh service
has its own dispatcher and replanner threads; all use the device's
legacy default stream (serving/spmv_service.py), so an operator built on
one thread is ordered before its first use on another.

Unlike the JAX package's router, this one keeps no copy of each key's
matrix beside its mesh service's: nothing read that copy, and keeping it
current applied every structure delta a second time on the caller's
thread (about 4 s for a 0.5% delta of a Fig. 1 matrix).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import obs
from ..core.sparse.csr import CSRMatrix
from ..core.spmv import opcache
from ..device import resolve_device
from ..serving.errors import UnregisteredKey
from ..serving.spmv_service import SpmvService
from .table import MeshSpec, RoutingTable


class _MeshService(SpmvService):
    """SpmvService for ONE mesh of the fleet: sharded updates allowed,
    memory accounted per device (the budget passed to the base class is
    budget_per_device x devices; see the module docstring invariant)."""

    _allow_sharded_updates = True

    def _op_nbytes(self, op) -> int:
        per = opcache.operator_nbytes_per_device(op)
        return max(per) * len(per)

    def per_device_bytes(self) -> list:
        """Current true per-device residency (sum of each resident
        operator's device slice) — what the budget invariant bounds."""
        with self._cv:
            ops = [ent[1] for ent in self._ops.values()]
        totals: Dict[int, int] = {}
        for op in ops:
            for d, b in enumerate(opcache.operator_nbytes_per_device(op)):
                totals[d] = totals.get(d, 0) + b
        ndev = max(totals) + 1 if totals else 1
        return [totals.get(d, 0) for d in range(ndev)]


class RoutedSpmvService:
    """Route keys across meshes; serve each from its own SpmvService.

    Usage:
        meshes = [MeshSpec("m8", Topology(devices=8),
                           budget_per_device=8 << 20),
                  MeshSpec("m2", Topology(devices=2),
                           budget_per_device=8 << 20)]
        with RoutedSpmvService(meshes, policy="bin_pack",
                               max_batch=8) as router:
            router.register("gnn", mat)              # policy placement
            y = router.submit("gnn", x).result()
            router.update_values("gnn", new_vals)    # sharded rebuild
            fut = router.update_structure("gnn", delta=delta)
            fut.result()                             # replan landed
            print(router.stats()["per_device_ok"])

    Extra **service_kw (max_batch, window_ms, overload, ...) are passed
    to every per-mesh service verbatim, and so is `device`.
    """

    def __init__(self, meshes: List[MeshSpec], policy: str = "bin_pack",
                 device=None, **service_kw):
        self.device = resolve_device(device)
        self.table = RoutingTable(meshes, policy=policy)
        service_kw.pop("topology", None)
        service_kw.pop("memory_budget_bytes", None)
        self._services: Dict[str, _MeshService] = {}
        for spec in self.table.meshes:
            budget = (None if spec.budget_per_device is None
                      else int(spec.budget_per_device)
                      * spec.topology.devices)
            self._services[spec.name] = _MeshService(
                topology=spec.topology, memory_budget_bytes=budget,
                device=self.device, **service_kw)
        self._lock = threading.Lock()
        self._closed = False

    # -- key lifecycle -----------------------------------------------------
    def register(self, key: str, mat: CSRMatrix,
                 reorder: Optional[str] = None, priority: int = 0,
                 mesh: Optional[str] = None) -> MeshSpec:
        """Place `key` (policy, or pinned with mesh=) and register it on
        the owning mesh's service. Returns the MeshSpec it landed on."""
        spec = self.table.assign(key, mat, mesh=mesh)
        try:
            self._services[spec.name].register(
                key, mat, reorder=reorder, topology=spec.topology,
                priority=priority)
        except Exception:
            self.table.remove(key, mat)
            raise
        return spec

    def _service(self, key: str) -> _MeshService:
        try:
            spec = self.table.mesh_of(key)
        except KeyError:
            raise UnregisteredKey(f"unrouted matrix key {key!r}") from None
        return self._services[spec.name]

    def mesh_of(self, key: str) -> MeshSpec:
        return self.table.mesh_of(key)

    # -- request path ------------------------------------------------------
    def submit(self, key: str, x):
        spec = self.table.mesh_of(key)
        with obs.span("router.dispatch", key=key, mesh=spec.name):
            fut = self._services[spec.name].submit(key, x)
        obs.counter("router.requests", mesh=spec.name).inc()
        return fut

    def operator(self, key: str):
        return self._service(key).operator(key)

    # -- dynamic matrices --------------------------------------------------
    def update_values(self, key: str, vals) -> None:
        """Sharded value swap: Plan.rebuild under the frozen partition —
        array repack only, no replan, siblings unaffected."""
        self._service(key).update_values(key, vals)
        obs.counter("router.value_swaps").inc()

    def update_structure(self, key: str, mat: Optional[CSRMatrix] = None,
                         delta=None, staleness_s: Optional[float] = None):
        """Background shard replan (or delta apply): the owning mesh's
        replanner swaps matrix + plan + operator generation-atomically
        while the stale shards — and every sibling key — keep serving.
        Returns the replan Future (resolves to the new generation)."""
        fut = self._service(key).update_structure(
            key, mat=mat, delta=delta, staleness_s=staleness_s)
        obs.counter("router.replans_requested",
                    delta=str(delta is not None).lower()).inc()
        return fut

    # -- lifecycle / observability -----------------------------------------
    def flush(self, timeout: float = 60.0) -> None:
        for svc in self._services.values():
            svc.flush(timeout=timeout)

    def close(self, timeout: float = 60.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        err = None
        for svc in self._services.values():
            try:
                svc.close(timeout=timeout)
            except TimeoutError as e:
                err = e
        if err is not None:
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self) -> dict:
        """Fleet snapshot: aggregated counters, per-mesh service stats,
        the routing ledger, and the per-device budget verdict
        (`per_device_ok`: every device of every mesh currently within
        its budget_per_device)."""
        per_mesh = {}
        agg = {k: 0 for k in ("requests", "results", "errors", "sheds",
                              "rejected", "replans", "replan_errors",
                              "value_swaps", "evictions",
                              "budget_overruns", "pending")}
        per_device_ok = True
        for spec in self.table.meshes:
            svc = self._services[spec.name]
            s = svc.stats()
            per_dev = svc.per_device_bytes()
            budget = spec.budget_per_device
            ok = budget is None or all(b <= budget for b in per_dev)
            per_device_ok = per_device_ok and ok
            per_mesh[spec.name] = {
                "service": s,
                "devices": spec.topology.devices,
                "budget_per_device": budget,
                "per_device_bytes": per_dev,
                "per_device_ok": ok,
            }
            for k in agg:
                agg[k] += int(s.get(k, 0))
        return {**agg, "per_mesh": per_mesh,
                "per_device_ok": per_device_ok,
                "routing": self.table.snapshot()}
