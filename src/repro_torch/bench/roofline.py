"""Roofline table from the dry-run records: the reference's
`benchmarks/roofline.py` over `launch.dryrun`'s records and the H100's
`launch.mesh.HardwareSpec`.

Per (arch x shape x mesh) record, per device:
  compute term    = walk_flops / peak bf16 FLOP/s (989e12)
  memory term     = walk_bytes / HBM bandwidth (3.35e12 B/s)
  collective term = collective wire bytes / ici_bw (25e9 B/s: one NVLink 4
                    link each way, used as the reference uses its ICI link
                    figure)
the dominant term, MODEL_FLOPS = 6 N(_active) D for a train cell and
2 N D for prefill and decode, its ratio to the counted flops
(`model_over_hlo_flops`) and the roofline fraction (model flops over the
largest term, against the peak). The terms are reckoned from datasheet
figures, not measured on a card; the counts are the port's per-rank
counts (see `launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.bench.roofline
    PYTHONPATH=src python -m repro_torch.bench.run --only roofline

Reads <results_dir()>/dryrun/*.json and writes roofline.csv under
common.results_dir(). Host-only: `device` is accepted and unused.
"""
from __future__ import annotations

import glob
import json
import os

from ..configs.base import SHAPES
from ..launch.dryrun import dryrun_dir
from ..launch.mesh import HardwareSpec
from . import common

CSV = "roofline.csv"
HEADER = ["arch", "shape", "mesh", "status", "compute_s", "memory_s",
          "collective_s", "dominant", "model_over_hlo_flops",
          "roofline_fraction", "note"]


def model_flops_per_device(rec) -> float:
    """6 * N(_active) * tokens / chips (train includes backward: the 6x;
    decode/prefill use 2*N*D forward-only)."""
    shape = SHAPES[rec["shape"]]
    chips = 512 if rec["mesh"] == "2x16x16" else 256
    n = rec.get("active_params") or rec.get("params")
    if shape.kind == "train":
        total = 6.0 * n * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n * shape.global_batch
    return total / chips


def load_records():
    """The dry-run records under `dryrun_dir()`, in file-name order."""
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir(), "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _variant(rec) -> str:
    """The record's layout variant beside its cell: decode's kv_shard and
    the weight-stationary layout."""
    parts = []
    if SHAPES[rec["shape"]].kind == "decode":
        parts.append(f"kv_shard={rec['kv_shard']}")
    if rec.get("weight_stationary"):
        parts.append("weight_stationary")
    return ";".join(parts)


def row(rec) -> list:
    """One CSV row of a record: ERROR with the error's start, else the
    three terms, the dominant one, the useful-flop ratio and the roofline
    fraction."""
    if rec.get("status") != "ok":
        return [rec["arch"], rec["shape"], rec["mesh"], "ERROR",
                "", "", "", "", "", "", rec.get("error", "")[:80]]
    hw = HardwareSpec
    flops = rec.get("walk_flops", 0.0)
    coll = rec.get("collectives", {})
    wire = coll.get("wire", coll.get("total", 0))
    terms = {"compute": flops / hw["peak_flops_bf16"],
             "memory": rec.get("walk_bytes", 0.0) / hw["hbm_bw"],
             "collective": wire / hw["ici_bw"]}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    useful = mf / max(flops, 1.0)
    mfu_bound = mf / max(terms[dominant], 1e-12) / hw["peak_flops_bf16"]
    return [rec["arch"], rec["shape"], rec["mesh"], "ok",
            f"{terms['compute']:.4e}", f"{terms['memory']:.4e}",
            f"{terms['collective']:.4e}", dominant, f"{useful:.3f}",
            f"{mfu_bound:.3f}", _variant(rec)]


def run(quick: bool = False, device=None):
    """roofline.csv over the records; returns {"cells_ok", "cells_err"}."""
    rows = [row(rec) for rec in load_records()]
    common.write_csv(common.result_path(CSV), HEADER, rows)
    err = sum(r[3] == "ERROR" for r in rows)
    return {"cells_ok": len(rows) - err, "cells_err": err}


if __name__ == "__main__":
    print(run())
