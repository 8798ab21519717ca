"""repro_torch.api — the unified Problem → Plan → Operator pipeline facade,
the JAX package's `repro.api` on PyTorch.

    from repro_torch.api import SpmvProblem, plan

    problem = SpmvProblem(mat, k=8)              # matrix + RHS width + dtype
    pl = plan(problem, reorder="auto")           # scheme x engine x shape x k
    op = pl.build()                              # on the card (device=None)
    y = op(x)                                    # x in the ORIGINAL space

    pl.save()                                    # one content-addressed
    pl2 = Plan.load(pl.key, mat=mat)             # store: plan + perm + op
    op2 = pl2.build()                            # arrays — no re-tune

Schemes, engines and row partitioners are plugins: anything registered
through @register_scheme / @register_engine / @register_partitioner
(core/registry.py) takes part in planning, `plan(reorder="auto",
engine="auto")` included. Importing this module registers every built-in
(core.reorder.api schemes, core.spmv.ops engines, core.sparse.partition
partitioners).

The same facade covers one device through a mesh: pass
`topology=Topology(devices=8, layout="1d_rows" | "2d_panels")` and plan()
jointly selects (partition x scheme x engine x shape x k) with the
communication-volume cost model, while `Plan.build()` returns a
`ShardedOperator` carrying perm + panel starts + collective schedule —
still fed ORIGINAL-index-space vectors, still round-tripping through the
plan store.

Measurement is the same shape one level up: `repro_torch.experiments`
turns a declarative ExperimentSpec into a resumable campaign over a
content-addressed ResultStore; its key types are re-exported here.
"""
from __future__ import annotations

from . import obs
from .core.registry import (ENGINE_REGISTRY, PARTITIONER_REGISTRY,
                            PROFILE_REGISTRY, SCHEME_REGISTRY, EngineSpec,
                            PartitionerSpec, ProfileSpec, SchemeSpec,
                            get_engine, get_partitioner, get_profile,
                            get_scheme, register_engine,
                            register_partitioner, register_profile,
                            register_scheme)
# importing these populates the registries with every built-in
from .core.reorder import api as _reorder_api  # noqa: F401
from .core.sparse import partition as _partition  # noqa: F401
from .core.spmv import ops as _ops  # noqa: F401
from .core.spmv.distributed import ShardedOperator
from .core.spmv.plan import Operator, Plan, SpmvProblem, plan, plan_key
from .core.spmv.topology import Topology
from .experiments import (ExperimentSpec, MeasurePolicy, MissingCellError,
                          Report, ResultStore, Runner)

__all__ = [
    "SpmvProblem", "plan", "Plan", "Operator", "plan_key", "Topology",
    "ShardedOperator", "obs",
    "register_scheme", "register_engine", "register_partitioner",
    "register_profile",
    "get_scheme", "get_engine", "get_partitioner", "get_profile",
    "SchemeSpec", "EngineSpec", "PartitionerSpec", "ProfileSpec",
    "SCHEME_REGISTRY", "ENGINE_REGISTRY", "PARTITIONER_REGISTRY",
    "PROFILE_REGISTRY",
    "ExperimentSpec", "MeasurePolicy", "MissingCellError", "Report",
    "ResultStore", "Runner",
]
