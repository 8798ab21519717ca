"""Paper technique inside the LM framework: MoE routing as a sparse matrix.

    python -m repro_torch.bench.run --only moe_dispatch [--quick]

A thin VIEW over the `"workload"` campaign cells (bench/workloads
`moe_dispatch_spec`): the (E, k) grid at d=128, measured through the
Problem→Plan→Operator pipeline under the WorkloadSession amortization
policy — sorted dispatch is the sparse operator chain, onehot the
GShard-style scatter oracle (repro_torch.workloads.adapters). The CSV
holds the router LI metric (paper §6.1), the drop fraction under the
capacity (= nnz-balanced) schedule, and the wall-clock of sorted
(reordered) vs one-hot (unreordered) dispatch. Measures on the card
unless it is given device="cpu"; the CSV goes under
common.results_dir().
"""
from __future__ import annotations

import re

from ..experiments import Runner
from .common import result_path, result_store, write_csv
from .workloads import moe_dispatch_spec

CSV = "moe_dispatch.csv"
HEADER = ["config", "dispatch", "ms", "router_li", "drop_frac"]


def run(quick: bool = False, device=None):
    tokens = 2048 if quick else 8192
    spec = moe_dispatch_spec(tokens)
    rep = Runner(spec, store=result_store(), verbose=False,
                 device=device).run()
    rows, out = [], {}
    for rec in rep.records:
        m = re.search(r"moe-e(\d+)-k(\d+)", rec["matrix"])
        cfg = f"e{m.group(1)}_k{m.group(2)}"
        li = round(float(rec["li_mean"]), 3)
        drop = round(float(rec["drop_frac"]), 4)
        rows.append([cfg, "sorted", round(rec["sorted_ms"], 2), li, drop])
        rows.append([cfg, "onehot", round(rec["onehot_ms"], 2), li, drop])
        out[f"{cfg}_dispatch_agree"] = bool(rec["dispatch_agree"])
        out[f"{cfg}_sorted_ms"] = round(rec["sorted_ms"], 2)
        out[f"{cfg}_onehot_ms"] = round(rec["onehot_ms"], 2)
        out[f"{cfg}_router_li"] = li
    write_csv(result_path(CSV), HEADER, rows)
    return out
