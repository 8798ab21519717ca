"""RoutingTable — the key -> mesh ledger the router dispatches through.

A MeshSpec names one device mesh (a Topology) plus its per-device memory
budget; the table owns the authoritative assignment of matrix keys to
meshes, made once at register time by a pluggable placement policy
(placement.py) and stable until the key is removed — SpMV requests must
never migrate mid-flight, so re-placement is an explicit
remove + register, never a side effect.

Every assignment runs under a `router.assign` span and counts
`router.assigned{mesh=...}`; `snapshot()` is the load ledger the policies
score against (estimates — the per-mesh budgeted LRU enforces truth).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from .. import obs
from ..core.sparse.csr import CSRMatrix
from ..core.spmv import topology as topology_mod
from . import placement as placement_mod


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One routable device mesh.

    name              — routing label (unique within a table)
    topology          — Topology (devices, layout, mesh shape)
    budget_per_device — device-memory budget in bytes for EACH device of
                        this mesh (None = unbounded); the router's
                        per-mesh service enforces it via per-device
                        operator accounting (opcache
                        .operator_nbytes_per_device).
    """

    name: str
    topology: topology_mod.Topology
    budget_per_device: Optional[int] = None

    def __post_init__(self):
        topo = topology_mod.normalize(self.topology) \
            or topology_mod.Topology(devices=1)
        object.__setattr__(self, "topology", topo)
        if self.budget_per_device is not None \
                and int(self.budget_per_device) <= 0:
            raise ValueError("budget_per_device must be positive or None")

    @property
    def budget_bytes(self) -> Optional[int]:
        """Total budget across the mesh (what bin-pack fits against)."""
        if self.budget_per_device is None:
            return None
        return int(self.budget_per_device) * self.topology.devices


class RoutingTable:
    """Thread-safe key -> MeshSpec assignment under one placement policy."""

    def __init__(self, meshes: List[MeshSpec], policy: str = "bin_pack"):
        if not meshes:
            raise ValueError("RoutingTable needs at least one MeshSpec")
        names = [m.name for m in meshes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh names: {names}")
        self.meshes = list(meshes)
        self.policy = placement_mod.get_placement(policy)
        self._by_name = {m.name: m for m in meshes}
        self._assigned: Dict[str, str] = {}        # key -> mesh name
        self._loads = {m.name: {"keys": 0, "nnz": 0, "est_bytes": 0}
                       for m in meshes}
        self._lock = threading.Lock()

    def assign(self, key: str, mat: CSRMatrix,
               mesh: Optional[str] = None) -> MeshSpec:
        """Place `key` (policy-chosen, or pinned with mesh=). Idempotent
        re-assign of a live key is refused — remove() first."""
        with self._lock:
            if key in self._assigned:
                raise ValueError(f"key {key!r} is already routed to "
                                 f"{self._assigned[key]!r}; remove() first")
            with obs.span("router.assign", key=key,
                          policy=self.policy.name) as sp:
                if mesh is not None:
                    if mesh not in self._by_name:
                        raise KeyError(f"unknown mesh {mesh!r}; known: "
                                       f"{sorted(self._by_name)}")
                    name = mesh
                else:
                    name = self.policy.fn(key, mat, self.meshes,
                                          {n: dict(v) for n, v
                                           in self._loads.items()})
                    if name not in self._by_name:
                        raise KeyError(
                            f"placement {self.policy.name!r} returned "
                            f"unknown mesh {name!r}")
                spec = self._by_name[name]
                self._assigned[key] = name
                load = self._loads[name]
                load["keys"] += 1
                load["nnz"] += int(mat.nnz)
                load["est_bytes"] += placement_mod.estimate_nbytes(mat)
                sp.set(mesh=name, est_bytes=load["est_bytes"])
            obs.counter("router.assigned", mesh=name).inc()
            obs.gauge("router.keys", mesh=name).set(load["keys"])
            return spec

    def mesh_of(self, key: str) -> MeshSpec:
        with self._lock:
            name = self._assigned.get(key)
            if name is None:
                raise KeyError(f"key {key!r} is not routed; known keys: "
                               f"{sorted(self._assigned)}")
            return self._by_name[name]

    def remove(self, key: str, mat: Optional[CSRMatrix] = None) -> None:
        with self._lock:
            name = self._assigned.pop(key, None)
            if name is None:
                return
            load = self._loads[name]
            load["keys"] -= 1
            if mat is not None:
                load["nnz"] -= int(mat.nnz)
                load["est_bytes"] -= placement_mod.estimate_nbytes(mat)
            obs.gauge("router.keys", mesh=name).set(load["keys"])

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy.name,
                "assignments": dict(self._assigned),
                "loads": {n: dict(v) for n, v in self._loads.items()},
            }
