"""How reordering changes the Block-ELL/BCSR format quality — block fill
ratio, padded-FLOP overhead, and distinct x-tiles per row panel. These
are the quantities that become tensor-core utilization and memory
traffic in the block kernels (K3, K4). Structural: host metrics only,
nothing runs on a device."""
from __future__ import annotations

import numpy as np

from ..core.reorder import api as reorder_api
from ..core.sparse import metrics, partition
from . import common

BM, BN = 8, 128
CSV = "bell_formats.csv"
HEADER = ["matrix", "scheme", "fill_ratio", "nblocks", "flop_overhead",
          "mean_xtiles_per_panel"]


def run(quick: bool = False, matrices=None, device=None):
    """device is accepted for the drivers' uniform call; nothing here
    touches one."""
    from ..matrices import suite

    if matrices is None:
        matrices = suite.bench_names()[:6] if quick else \
            suite.bench_names()[:16]
    rows, out = [], {}
    agg = {s: [] for s in common.SCHEMES}
    for name in matrices:
        mat = suite.get(name)
        for scheme in common.SCHEMES:
            perm = reorder_api.reorder(mat, scheme)
            rmat = mat.permute(perm) if scheme != "baseline" else mat
            fill = metrics.block_fill_ratio(rmat, BM, BN)
            nblocks = metrics.num_nonempty_blocks(rmat, BM, BN)
            # padded-FLOP overhead of the BCSR kernel vs nnz flops
            overhead = nblocks * BM * BN / max(rmat.nnz, 1)
            panels = partition.static_partition(rmat, 8)
            xtiles = metrics.distinct_col_blocks(rmat, panels, BN).mean()
            rows.append([name, scheme, round(fill, 5), nblocks,
                         round(overhead, 2), round(float(xtiles), 1)])
            agg[scheme].append(overhead)
    for s, v in agg.items():
        out[f"{s}_geomean_flop_overhead"] = round(
            float(np.exp(np.mean(np.log(np.maximum(v, 1e-9))))), 2)
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return out
