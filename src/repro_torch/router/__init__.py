"""repro_torch.router — multi-shard serving: key -> mesh routing,
per-device memory budgets, non-stalling shard replans, incremental
structure deltas.

    from repro_torch.router import MeshSpec, RoutedSpmvService
    from repro_torch.api import Topology

See service.py for the serving contract, table.py for the routing
ledger, placement.py for the policy registry
(@register_placement), and core/spmv/delta.py for StructureDelta.
"""
from .placement import (PLACEMENT_REGISTRY, PlacementSpec,  # noqa: F401
                        estimate_nbytes, get_placement, register_placement)
from .service import RoutedSpmvService  # noqa: F401
from .table import MeshSpec, RoutingTable  # noqa: F401

__all__ = [
    "MeshSpec",
    "PLACEMENT_REGISTRY",
    "PlacementSpec",
    "RoutedSpmvService",
    "RoutingTable",
    "estimate_nbytes",
    "get_placement",
    "register_placement",
]
