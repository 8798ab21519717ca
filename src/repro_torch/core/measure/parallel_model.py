"""Calibrated parallel-execution model (the paper's parallel rows).

The paper times SpMV on P cores under a static schedule. One card runs one
operator at a time, so the model reproduces the mechanism the paper
analyses — per-panel work plus static-schedule imbalance:

    T_par(P) = max_p T_seq(panel_p) + alpha_sync

where T_seq(panel_p) is *measured*: the IOS time of the panel's own
sub-operator, which includes its real x-gather locality. alpha_sync is a
fixed small barrier cost. This is exact for the load-imbalance term (the
one §6 studies) and leaves out shared-bandwidth contention. Panels are
timed with CUDA events on the card and with the host clock on the CPU, as
core/measure/ios.py times a call. Every number from this model is labelled
"modelled parallel".
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ..sparse.csr import CSRMatrix
from ..sparse.partition import nnz_balanced_partition, static_partition
from ..spmv.ops import make_engine
from .ios import _sync, time_call

ALPHA_SYNC_MS = 0.005  # barrier cost estimate (one core-to-core sync)


def panel_submatrix(mat: CSRMatrix, r0: int, r1: int,
                    m_pad: int = 0) -> CSRMatrix:
    """Rows [r0, r1) as an (h, n) submatrix; optionally pad the height to a
    multiple of m_pad with empty rows (their outputs are zeros)."""
    rp = mat.rowptr.astype(np.int64)
    s, e = rp[r0], rp[r1]
    h = r1 - r0
    if m_pad:
        h = ((h + m_pad - 1) // m_pad) * m_pad
    rowptr = np.full(h + 1, e - s, dtype=np.int32)
    rowptr[: r1 - r0 + 1] = (rp[r0:r1 + 1] - s).astype(np.int32)
    return CSRMatrix(rowptr=rowptr, cols=mat.cols[s:e], vals=mat.vals[s:e],
                     shape=(h, mat.n))


def modelled_parallel_ms(mat: CSRMatrix, p: int, engine: str = "csr",
                         schedule: str = "static", iters: int = 8,
                         rng_seed: int = 0, panels=None,
                         device=None) -> float:
    """Median modelled parallel SpMV time for P cores on `device` (None =
    the card).

    panels — an explicit int[P+1] contiguous row split; overrides the
    schedule name."""
    dev = resolve_device(device)
    if panels is not None:
        starts = np.asarray(panels, np.int64)
        if starts.size != p + 1:
            raise ValueError(f"panels has {starts.size - 1} panels, "
                             f"expected {p}")
    else:
        starts = (static_partition(mat, p) if schedule == "static"
                  else nnz_balanced_partition(mat, p))
    rng = np.random.default_rng(rng_seed)
    x = torch.as_tensor(rng.standard_normal(mat.n)).to(dev, torch.float32)
    panel_ms = []
    for k in range(p):
        r0, r1 = int(starts[k]), int(starts[k + 1])
        if r1 <= r0:
            panel_ms.append(0.0)
            continue
        op = make_engine(panel_submatrix(mat, r0, r1), engine, device=dev)
        # IOS-style, but x comes from outside the panel (real CG dataflow):
        # only the panel's slice of x is refreshed each iteration
        ms = run_ios_panel(op, x.clone(), r0, r1, iters)
        panel_ms.append(float(np.median(ms)))
        del op
    return max(panel_ms) + ALPHA_SYNC_MS


def run_ios_panel(op, x: torch.Tensor, r0: int, r1: int,
                  iters: int) -> np.ndarray:
    """IOS variant for a panel: y_panel replaces x[r0:r1] between runs (x
    is updated in place). Returns ms[iters]."""
    for _ in range(2):
        x[r0:r1] = op(x)[: r1 - r0]
    _sync(x)
    times = np.empty(iters)
    for i in range(iters):
        times[i], y = time_call(op, x)
        x[r0:r1] = y[: r1 - r0]
    return times
