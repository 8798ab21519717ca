"""Row-panel partitioning — the paper's two scheduling strategies, plus
the partitioner plugin registry the topology-aware planner searches.

* static_partition      — default OpenMP static schedule: equal ROW counts
                          (paper §3.2, the winner of the scheduling study).
* nnz_balanced_partition— equal NNZ counts (paper Listing 5): the custom
                          load-balanced schedule used in §6.2 to isolate
                          load-balance effects from data-movement effects.
* chunked_cyclic_panels — static,chunk round-robin (for the Fig. 4 sweep).

Each strategy is also registered as a PARTITIONER plugin
(@register_partitioner, core/registry.py) with the uniform contract

    fn(mat, p, seed=0, **kw) -> (perm | None, panel_starts[p + 1])

that the topology-aware planner (core/spmv/plan.py, `plan(topology=)`)
searches for sharded plans. Partitioners that regroup rows (chunked_cyclic) return the grouping
permutation instead of emitting non-contiguous panels — contiguous panels
of the permuted matrix ARE the strided assignment.

The port's own copy of the JAX package's numpy code (the same panels and
permutations, bit for bit), the cut-minimizing `metis_cut` included.
"""
from __future__ import annotations

import functools
import re

import numpy as np

from ..registry import PARTITIONER_REGISTRY, get_partitioner, \
    register_partitioner
from .csr import CSRMatrix
from .metrics import static_block_panels


def static_partition(mat: CSRMatrix, p: int) -> np.ndarray:
    """int[P+1] — contiguous equal-row panels (default static schedule)."""
    return static_block_panels(mat.m, p)


def nnz_balanced_partition(mat: CSRMatrix, p: int) -> np.ndarray:
    """int[P+1] — contiguous panels with ~equal nnz (paper Listing 5).

    Greedy prefix splitter: panel k ends at the first row where the running
    nnz count reaches (k+1)/P of total. Rows are never split (same
    granularity as the paper's rowPanel_start).

    Invariants (property-tested on the reference): result
    has length p+1, starts at 0, ends at m, is nondecreasing, and panel
    loads sum to nnz with max load <= nnz/p + max_row_nnz. Edge cases:
      * p > m — trailing/interspersed panels come out empty but the offsets
        stay monotone and cover every row exactly once;
      * a giant row swallowing several targets — maximum.accumulate
        collapses the overtaken cuts onto the row boundary (empty panels);
      * nnz == 0 — no balance signal exists, fall back to equal-row panels.
    """
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    if mat.m == 0:
        return np.zeros(p + 1, dtype=np.int64)
    if mat.nnz == 0:
        return static_block_panels(mat.m, p)
    rp = mat.rowptr.astype(np.int64)
    targets = (np.arange(1, p, dtype=np.float64) * mat.nnz / p)
    # rp is nondecreasing; searchsorted finds the split rows.
    cuts = np.searchsorted(rp[1:], targets, side="left") + 1
    cuts = np.minimum(cuts, mat.m)
    starts = np.concatenate([[0], cuts, [mat.m]]).astype(np.int64)
    # enforce monotonicity when several targets land in one giant row
    starts = np.maximum.accumulate(starts)
    return starts


def chunked_cyclic_panels(m: int, p: int, chunk: int) -> list[np.ndarray]:
    """static,chunk scheduling: thread t gets rows {t*chunk..(t+1)*chunk-1,
    (t+P)*chunk.., ...}. Returns, per thread, the array of its row ids.
    (Non-contiguous — used only by the Fig. 4 scheduling benchmark.)"""
    out = []
    nchunks = (m + chunk - 1) // chunk
    for t in range(p):
        ids = []
        for ck in range(t, nchunks, p):
            ids.append(np.arange(ck * chunk, min((ck + 1) * chunk, m)))
        out.append(np.concatenate(ids) if ids else np.empty(0, dtype=np.int64))
    return out


def partition_to_owner(panel_starts: np.ndarray, m: int) -> np.ndarray:
    """int[m] — panel id owning each row. panel_starts must cover [0, m]."""
    starts = np.asarray(panel_starts, dtype=np.int64)
    if starts.size == 0 or starts[0] != 0 or starts[-1] != m:
        raise ValueError(f"panel_starts must cover [0, {m}], got "
                         f"{starts[:1]}..{starts[-1:]}")
    return np.repeat(np.arange(starts.size - 1, dtype=np.int32),
                     np.diff(starts))


# --------------------------------------------------------------------------
# Partitioner plugins (the topology-aware planning axis)
# --------------------------------------------------------------------------
@register_partitioner("static", auto_candidate=True,
                      description="equal contiguous row panels "
                                  "(default static schedule)")
def static_partitioner(mat: CSRMatrix, p: int, seed: int = 0):
    return None, static_partition(mat, p)


@register_partitioner("nnz_balanced", auto_candidate=True,
                      description="~equal-nnz contiguous panels "
                                  "(paper Listing 5)")
def nnz_balanced_partitioner(mat: CSRMatrix, p: int, seed: int = 0):
    return None, nnz_balanced_partition(mat, p)


@register_partitioner("chunked_cyclic", reorders=True,
                      description="static,chunk round-robin; panels made "
                                  "contiguous by a grouping permutation")
def chunked_cyclic_partitioner(mat: CSRMatrix, p: int, seed: int = 0,
                               chunk: int = 16):
    """Thread t owns rows {t*chunk.., (t+p)*chunk.., ...}; the returned
    permutation concatenates each thread's strided row set so panel t of
    the permuted matrix IS thread t's assignment (including its striding
    locality loss)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    panels = chunked_cyclic_panels(mat.m, p, chunk)
    sizes = np.array([ids.size for ids in panels], dtype=np.int64)
    perm = (np.concatenate(panels).astype(np.int64) if mat.m
            else np.empty(0, np.int64))
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return perm, starts


@register_partitioner("metis_cut", reorders=True,
                      description="cut-minimizing: METIS k-way labels group "
                                  "rows, nnz-balanced contiguous split")
def metis_cut_partitioner(mat: CSRMatrix, p: int, seed: int = 0):
    """Communication-volume-minimizing partition: rows are grouped by their
    METIS k-way partition label, then the grouped matrix is split into p
    nnz-balanced contiguous panels. The label groups minimize the cut, the
    balanced split bounds the load imbalance."""
    from ..reorder.metis import metis_partition

    labels = metis_partition(mat, p, seed)
    perm = np.argsort(labels, kind="stable").astype(np.int64)
    starts = nnz_balanced_partition(mat.permute(perm), p)
    return perm, starts


def resolve_partitioner(name: str):
    """(canonical_name, fn) for a registered partitioner name, supporting
    the parameterized `<base>_c<chunk>` form (e.g. chunked_cyclic_c16)."""
    if name in PARTITIONER_REGISTRY:
        return name, get_partitioner(name).fn
    m = re.match(r"^(.+)_c(\d+)$", name)
    if m and m.group(1) in PARTITIONER_REGISTRY:
        return name, functools.partial(get_partitioner(m.group(1)).fn,
                                       chunk=int(m.group(2)))
    raise KeyError(f"unknown partitioner {name!r}; known: "
                   f"{sorted(PARTITIONER_REGISTRY)} "
                   f"(+ parameterized <name>_c<chunk>)")


def auto_partitioners() -> list:
    """Names a sharded plan's partition='auto' searches."""
    return [s.name for s in PARTITIONER_REGISTRY.values() if s.auto_candidate]


def pad_panels_to_uniform(mat: CSRMatrix, panel_starts: np.ndarray):
    """Pad each panel's rows to the max panel height (device-side SPMD needs
    uniform shapes). Returns (row_index[P, H], valid[P, H]) where
    row_index[p, i] is the matrix row handled by slot i of panel p (padding
    slots repeat row 0 and are masked by valid)."""
    p = len(panel_starts) - 1
    heights = np.diff(panel_starts)
    h = int(heights.max()) if p else 0
    idx = np.zeros((p, h), dtype=np.int32)
    valid = np.zeros((p, h), dtype=bool)
    for k in range(p):
        n = heights[k]
        idx[k, :n] = np.arange(panel_starts[k], panel_starts[k + 1])
        valid[k, :n] = True
    return idx, valid
