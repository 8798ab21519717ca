"""Incremental structure deltas — the amortization tier between
`Plan.rebuild` (values only) and a full replan (new structure).

The paper's plan-reuse economics (OSKI-style tuning pays off only when a
decision is reused) break down the moment a workload mutates its sparsity
pattern: `WorkloadSession` and the serving layer both fall back to a full
`plan()` — reorder + feature scan + tuner scoring — even when the change
is a handful of nonzeros. `StructureDelta` names that change explicitly:

    delta = StructureDelta(add_rows=[3], add_cols=[7], add_vals=[1.0],
                           del_rows=[0], del_cols=[2])
    pl2 = pl.apply_delta(delta)        # frozen scheme/engine/perm reused

`Plan.apply_delta` (plan.py, delegating here) keeps the frozen tuning
decision and permutation when the delta is SMALL — bounded nnz churn and
bounded bandwidth growth, the two axes along which a stale decision goes
wrong (churn moves the row-nnz spread the engine grid was scored on;
bandwidth growth breaks halo-schedule legality and SELL locality) — and
refuses (`DeltaTooLarge`) past either threshold so the caller replans.
Every outcome is counted: `delta.applies` / `delta.fallbacks`, and each
apply runs under a `plan.delta` span.

Appended rows (`append_rows`) extend the permutation with identity tail
positions — a new row has no structural history, so placing it last is
the only choice consistent with the frozen perm. Sharded plans (not
ported yet) accept same-shape deltas only; the check reads the plan's
`topology`, which no plan of the port has.

`delta_between(old, new)` recovers a delta from two matrices — what
`WorkloadSession` uses when the caller hands it a whole new matrix
instead of an explicit delta.

The JAX package's module, in numpy: the same edits, keys and thresholds.
Its membership and duplicate tests sort instead of calling `np.isin` and
`np.unique`, which numpy 2.3 takes through a hash table: over a minute on
the 32.5 M keys of a Fig. 1 matrix, against seconds for a sort.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from ... import obs
from ..sparse.csr import CSRMatrix
from ..sparse.metrics import sorted_unique

# Refusal thresholds (module-level so tests and callers can reference the
# exact bounds): churn is (added + deleted) / old nnz, growth is
# new_bandwidth / max(old_bandwidth, 1).
MAX_CHURN = 0.15
MAX_BW_GROWTH = 1.5


class DeltaTooLarge(ValueError):
    """apply_delta refused: the delta exceeds the churn or bandwidth
    threshold, so the frozen tuning decision can no longer be trusted —
    replan instead. `delta.fallbacks` was already incremented."""


class BadDelta(ValueError):
    """Malformed delta: out-of-range indices, deleting an entry that does
    not exist, or adding an entry that already does."""


def _isin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """np.isin(a, b) by one sort of b and a binary search (the same
    booleans)."""
    s = np.sort(b)
    if s.size == 0:
        return np.zeros(a.shape, dtype=bool)
    i = np.minimum(np.searchsorted(s, a), s.size - 1)
    return s[i] == a


def _has_duplicates(a: np.ndarray) -> bool:
    return sorted_unique(a).size != a.size


def _as_idx(a) -> np.ndarray:
    return np.asarray([] if a is None else a, dtype=np.int64).ravel()


@dataclasses.dataclass(frozen=True)
class StructureDelta:
    """A sparse edit script against one CSR structure.

    append_rows — rows appended at the bottom (and, for square matrices,
                  columns appended at the right: the pipeline's sharded
                  and CG paths require square operands, so appending
                  grows both dimensions together).
    add_*       — entries to insert; add_rows may index appended rows.
    del_*       — (row, col) of existing entries to remove.
    """

    append_rows: int = 0
    add_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    add_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    add_vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.float64))
    del_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))
    del_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))

    def __post_init__(self):
        object.__setattr__(self, "add_rows", _as_idx(self.add_rows))
        object.__setattr__(self, "add_cols", _as_idx(self.add_cols))
        object.__setattr__(self, "add_vals",
                           np.asarray(self.add_vals).ravel())
        object.__setattr__(self, "del_rows", _as_idx(self.del_rows))
        object.__setattr__(self, "del_cols", _as_idx(self.del_cols))
        if not (self.add_rows.size == self.add_cols.size
                == self.add_vals.size):
            raise BadDelta("add_rows/add_cols/add_vals lengths differ")
        if self.del_rows.size != self.del_cols.size:
            raise BadDelta("del_rows/del_cols lengths differ")
        if self.append_rows < 0:
            raise BadDelta("append_rows must be >= 0")

    @property
    def is_empty(self) -> bool:
        return (self.append_rows == 0 and self.add_rows.size == 0
                and self.del_rows.size == 0)

    @property
    def churn_nnz(self) -> int:
        """Edited entries — what the churn threshold is measured on."""
        return int(self.add_rows.size + self.del_rows.size)

    def signature(self) -> str:
        """Content hash of the edit script (chains plan keys: the same
        base plan edited by the same delta addresses one store entry)."""
        h = hashlib.sha1()
        h.update(f"append:{self.append_rows}".encode())
        for a in (self.add_rows, self.add_cols, self.add_vals,
                  self.del_rows, self.del_cols):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:20]

    def rows_touched(self, m: Optional[int] = None) -> np.ndarray:
        """Sorted unique row indices the edit touches (rows appended past
        `m` excluded when given) — what a shard-scoped replan uses to
        find the affected panels."""
        touched = np.concatenate([self.add_rows, self.del_rows])
        if m is not None:
            touched = touched[touched < m]
        return np.unique(touched) if touched.size else touched

    # -- application -------------------------------------------------------
    def apply_to(self, mat: CSRMatrix) -> CSRMatrix:
        """The edited matrix (pure numpy splice; surviving entries keep
        their values). Validates every edit: deleting a missing entry or
        adding a present one raises BadDelta — a silent no-op there would
        desynchronize the caller's idea of the structure from ours."""
        m, n = mat.shape
        m2 = m + self.append_rows
        n2 = n + self.append_rows if m == n else n
        if self.add_rows.size and (self.add_rows.min() < 0
                                   or self.add_rows.max() >= m2):
            raise BadDelta(f"add_rows out of range for m={m2}")
        if self.add_cols.size and (self.add_cols.min() < 0
                                   or self.add_cols.max() >= n2):
            raise BadDelta(f"add_cols out of range for n={n2}")
        if self.del_rows.size and (self.del_rows.min() < 0
                                   or self.del_rows.max() >= m):
            raise BadDelta(f"del_rows out of range for m={m}")
        rows = np.repeat(np.arange(m, dtype=np.int64),
                         np.diff(mat.rowptr.astype(np.int64)))
        cols = mat.cols.astype(np.int64)
        vals = mat.vals
        key = rows * n2 + cols
        if self.del_rows.size:
            dkey = self.del_rows * n2 + self.del_cols
            if _has_duplicates(dkey):
                raise BadDelta("duplicate delete entries")
            hit = _isin(dkey, key)
            if not hit.all():
                miss = int(np.argmin(hit))
                raise BadDelta(
                    f"delete targets absent entry "
                    f"({int(self.del_rows[miss])}, "
                    f"{int(self.del_cols[miss])})")
            keep = ~_isin(key, dkey)
            rows, cols, vals, key = (rows[keep], cols[keep], vals[keep],
                                     key[keep])
        if self.add_rows.size:
            akey = self.add_rows * n2 + self.add_cols
            if _has_duplicates(akey):
                raise BadDelta("duplicate add entries")
            clashes = _isin(akey, key)
            if clashes.any():
                clash = int(np.argmax(clashes))
                raise BadDelta(
                    f"add collides with existing entry "
                    f"({int(self.add_rows[clash])}, "
                    f"{int(self.add_cols[clash])})")
            rows = np.concatenate([rows, self.add_rows])
            cols = np.concatenate([cols, self.add_cols])
            vals = np.concatenate(
                [vals, self.add_vals.astype(vals.dtype, copy=False)])
        return CSRMatrix.from_coo(rows, cols, vals, (m2, n2))

    def churn(self, mat: CSRMatrix) -> float:
        """Fraction of the OLD matrix's nonzeros this delta edits."""
        return self.churn_nnz / max(mat.nnz, 1)


def delta_between(old: CSRMatrix, new: CSRMatrix
                  ) -> Optional[StructureDelta]:
    """Recover the StructureDelta turning `old`'s structure into `new`'s,
    or None when no delta can express it (shrunk shape, or column growth
    without matching row growth). Surviving entries keep NEW values only
    if they are unchanged — a value change on a surviving entry is left
    to `Plan.rebuild` (the caller applies the delta, then rebuilds with
    the new value array; see WorkloadSession)."""
    mo, no = old.shape
    mn, nn = new.shape
    append = mn - mo
    if append < 0 or nn < no:
        return None
    if mo == no and (mn != nn or nn - no != append):
        return None                  # square must stay square, grown alike
    if mo != no and nn != no:
        return None
    rows_o = np.repeat(np.arange(mo, dtype=np.int64),
                       np.diff(old.rowptr.astype(np.int64)))
    rows_n = np.repeat(np.arange(mn, dtype=np.int64),
                       np.diff(new.rowptr.astype(np.int64)))
    ko = rows_o * nn + old.cols.astype(np.int64)
    kn = rows_n * nn + new.cols.astype(np.int64)
    add = ~_isin(kn, ko)
    dele = ~_isin(ko, kn)
    return StructureDelta(
        append_rows=append,
        add_rows=rows_n[add], add_cols=new.cols.astype(np.int64)[add],
        add_vals=new.vals[add],
        del_rows=rows_o[dele], del_cols=old.cols.astype(np.int64)[dele])


def _bandwidth(mat: CSRMatrix) -> int:
    from ..sparse.metrics import bandwidth

    return int(bandwidth(mat))


def apply_delta(plan, delta: StructureDelta, *,
                max_churn: float = MAX_CHURN,
                max_bw_growth: float = MAX_BW_GROWTH):
    """The engine behind `Plan.apply_delta` — see plan.py for the public
    contract. Returns a NEW Plan (the input plan is never mutated);
    returns the input plan unchanged for an empty delta (no counters
    move); raises DeltaTooLarge (counting `delta.fallbacks`) past a
    threshold and BadDelta/ValueError on malformed input."""
    import dataclasses as _dc

    if delta.is_empty:
        return plan
    mat = plan._mat
    if mat is None:
        raise ValueError("plan has no attached matrix; pass mat= to "
                         "Plan.load before apply_delta")
    if getattr(plan, "topology", None) is not None and delta.append_rows:
        obs.counter("delta.fallbacks").inc()
        raise DeltaTooLarge(
            "sharded plans accept same-shape deltas only (the panel "
            "split indexes a fixed row count); replan instead")
    churn = delta.churn(mat)
    if churn > max_churn:
        obs.counter("delta.fallbacks").inc()
        raise DeltaTooLarge(
            f"delta edits {churn:.1%} of nnz (> {max_churn:.0%}); the "
            f"frozen tuning decision is stale — replan instead")
    with obs.span("plan.delta", key=plan.key, scheme=plan.scheme,
                  appended=int(delta.append_rows),
                  edited=delta.churn_nnz) as sp:
        import time

        t0 = time.perf_counter()
        new_mat = delta.apply_to(mat)
        bw_old = max(_bandwidth(mat), 1)
        bw_new = _bandwidth(new_mat)
        growth = bw_new / bw_old
        if growth > max_bw_growth:
            obs.counter("delta.fallbacks").inc()
            sp.set(fallback=True)
            raise DeltaTooLarge(
                f"bandwidth grew {growth:.2f}x (> {max_bw_growth:.2f}x); "
                f"the frozen permutation no longer localizes the "
                f"structure — replan instead")
        perm = plan.perm
        if perm is not None and delta.append_rows:
            tail = np.arange(mat.shape[0], new_mat.shape[0], dtype=np.int64)
            perm = np.concatenate([np.asarray(perm, np.int64), tail])
        key = hashlib.sha1(
            f"{plan.key}:delta:{delta.signature()}".encode()
        ).hexdigest()[:20]
        new_plan = _dc.replace(
            plan, key=key, mat_shape=tuple(new_mat.shape),
            mat_nnz=new_mat.nnz, perm=perm, cache_hit=False,
            reorder_ms=0.0, tune_ms=0.0,
            plan_ms=(time.perf_counter() - t0) * 1e3,
            _mat=new_mat, _rmat=None, _op_state=None)
        obs.counter("delta.applies").inc()
        sp.set(churn=round(churn, 4), bw_growth=round(growth, 3),
               key_out=key)
        return new_plan
