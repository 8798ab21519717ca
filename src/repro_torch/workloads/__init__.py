"""repro_torch.workloads — workload-shaped dynamic sparsity through the
Problem → Plan → Operator pipeline.

The paper's amortization question, asked where it is least favorable:
model-layer sparse structures (MoE token routing, block-sparse attention
masks, GNN adjacencies) that change step to step. sources.py lowers each
workload to a per-step stream of CSR operands, dynamic.py runs the
stream through `plan()` under an explicit reuse policy
(`WorkloadSession`: reuse / rebuild / plan / replan / delta, keyed on
`structure_key`/`values_key`), adapters.py rewires the model layers
through registry operators and supplies the onehot and plain reference
paths. The `"workload"` experiment cell kind (experiments/cells.py) makes
these resumable campaign cells. The JAX package's `repro.workloads`,
on the card.
"""
from . import adapters, dynamic, sources
from .adapters import (block_sparse_attention, gnn_aggregate,
                       moe_sorted_dispatch)
from .dynamic import DynamicSparseProblem, WorkloadSession, run_stream
from .sources import (SCENARIOS, WORKLOAD_PRESETS, WorkloadDef,
                      WorkloadStep, moe_capacity, moe_route_np,
                      parse_workload, preset_names, representative,
                      routing_matrices, steps)

__all__ = [
    "DynamicSparseProblem", "WorkloadSession", "run_stream",
    "block_sparse_attention", "gnn_aggregate", "moe_sorted_dispatch",
    "SCENARIOS", "WORKLOAD_PRESETS", "WorkloadDef", "WorkloadStep",
    "moe_capacity", "moe_route_np", "parse_workload", "preset_names",
    "representative", "routing_matrices", "steps",
    "adapters", "dynamic", "sources",
]
