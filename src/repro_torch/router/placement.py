"""Placement policies — WHICH mesh a newly routed key lands on.

A policy is a pure function over the routing table's current load state:

    @register_placement("my_policy")
    def my_policy(key, mat, meshes, loads):
        return <mesh name>

`meshes` is the ordered list of MeshSpec candidates, `loads` maps mesh
name -> {"keys", "nnz", "est_bytes"} accumulated from prior assignments
(estimates, not device truth — placement runs BEFORE planning, so it can
only reason from the matrix and the ledger). Returning a name not in
`meshes` is a policy bug and raises at the table.

Built-ins cover the three costs a placement can optimize:

  bin_pack    — best-fit by estimated operator bytes against each mesh's
                total budget (budget_per_device x devices): the mesh with
                the least headroom that still fits, so big keys don't
                strand capacity. Falls back to least-loaded when nothing
                fits — the per-mesh LRU enforces the real budget.
  nnz_balance — argmin of per-device nnz after assignment: equalizes the
                compute (and SpMV memory traffic) each device pays.
  comm_aware  — scores every mesh with the plan-time collective cost
                model (core/spmv/topology.comm_model on a uniform row
                split): modelled collective bytes per SpMV on THAT mesh
                shape plus a per-device compute-bytes load penalty, so a
                matrix whose structure gathers badly on a wide mesh is
                co-placed onto a narrower one.

The registry follows core/registry.py: frozen spec, decorator, KeyError
with the sorted known list. The JAX package's module, in numpy: the same
inputs choose the same mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..core.sparse.csr import CSRMatrix
from ..core.sparse.partition import static_partition
from ..core.spmv import topology as topology_mod


def estimate_nbytes(mat: CSRMatrix, dtype_size: int = 4) -> int:
    """Pre-plan operator footprint estimate: CSR payload (cols + vals +
    rowptr) at the compute dtype. Engines pad (ELL/SELL/BELL) and sharded
    layouts replicate index maps, so this undershoots — placement treats
    it as a relative load signal; the budgeted LRU enforces truth."""
    m = mat.shape[0]
    return int(mat.nnz * (4 + dtype_size) + (m + 1) * 4)


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    name: str
    fn: Callable
    description: str = ""


PLACEMENT_REGISTRY: Dict[str, PlacementSpec] = {}


def register_placement(name: str, description: str = "",
                       override: bool = False):
    """Decorator: register `(key, mat, meshes, loads) -> mesh_name`."""

    def deco(fn):
        if name in PLACEMENT_REGISTRY and not override:
            raise ValueError(f"placement {name!r} already registered "
                             f"(pass override=True to replace)")
        PLACEMENT_REGISTRY[name] = PlacementSpec(
            name=name, fn=fn, description=description or (fn.__doc__ or ""))
        return fn

    return deco


def get_placement(name: str) -> PlacementSpec:
    spec = PLACEMENT_REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"unknown placement policy {name!r}; known: "
                       f"{sorted(PLACEMENT_REGISTRY)}")
    return spec


def _least_loaded(meshes, loads) -> str:
    return min(meshes, key=lambda s: loads[s.name]["est_bytes"]).name


@register_placement("bin_pack",
                    "best-fit by estimated bytes against mesh budgets")
def bin_pack(key: str, mat: CSRMatrix, meshes, loads) -> str:
    est = estimate_nbytes(mat)
    best: Optional[str] = None
    best_headroom = None
    for spec in meshes:
        cap = spec.budget_bytes
        if cap is None:
            continue                      # unbounded meshes are fallback
        headroom = cap - loads[spec.name]["est_bytes"] - est
        if headroom < 0:
            continue
        if best_headroom is None or headroom < best_headroom:
            best, best_headroom = spec.name, headroom
    if best is not None:
        return best
    unbounded = [s for s in meshes if s.budget_bytes is None]
    if unbounded:
        return _least_loaded(unbounded, loads)
    return _least_loaded(meshes, loads)   # nothing fits: LRU will evict


@register_placement("nnz_balance",
                    "argmin per-device nnz after assignment")
def nnz_balance(key: str, mat: CSRMatrix, meshes, loads) -> str:
    return min(
        meshes,
        key=lambda s: (loads[s.name]["nnz"] + mat.nnz)
        / max(s.topology.devices, 1),
    ).name


@register_placement("comm_aware",
                    "modelled collective bytes (comm_model) + load penalty")
def comm_aware(key: str, mat: CSRMatrix, meshes, loads) -> str:
    dsize = 4
    best, best_score = None, None
    for spec in meshes:
        topo = spec.topology
        if topo.trivial:
            comm_bytes = 0.0
        else:
            starts = static_partition(mat, topo.row_devices)
            model = topology_mod.comm_model(mat, starts, topo,
                                            dtype_size=dsize, k=1,
                                            block_shape=(8, 128))
            comm_bytes = float(model["bytes_per_spmv"]) * topo.devices
        per_dev_compute = ((loads[spec.name]["nnz"] + mat.nnz)
                           / max(topo.devices, 1)) * (4 + dsize)
        score = comm_bytes + per_dev_compute
        if best_score is None or score < best_score:
            best, best_score = spec.name, score
    assert best is not None
    return best
