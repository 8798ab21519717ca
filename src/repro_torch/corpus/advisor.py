"""TuneAdvisor — the learned tuner (`plan(probe="learned")`).

The ResultStore holds measured cells: each records the tuner's feature
vector, the decision that was probed, and the throughput it achieved. The
advisor mines them:

    embed(features)  — normalize the structural metrics into a feature
                       space: log-scale size/density, row-nnz CV,
                       relative bandwidth + profile, block fill, distinct
                       col blocks per block row
    knowledge base   — mined lazily from prior ResultStore cells
                       (spmv cells carrying "features"+"tuner_decision")
    shortlist()      — nearest-neighbor match (z-normalized euclidean,
                       k=3 neighbors), map the neighbors' decisions onto
                       the current candidate grid, return a top-k ranked
                       shortlist + a confidence in (0, 1]

`tune(probe="learned")` then times only the shortlist instead of the
model's top-3 or the exhaustive grid, and records agreement as obs
counters: `advisor.hits` (the prediction won the probe), `advisor.misses`
(a probed alternative won), `advisor.fallbacks` (empty knowledge base →
model ranking). The chosen plan carries `advisor_confidence`.

The port's own copy of the JAX package's advisor; it mines the port's
ResultStore (REPRO_TORCH_RESULT_STORE), never the JAX package's.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import numpy as np

from ..experiments.store import ResultStore
from ..core.spmv.tune import PROBE_TOP_K, _label

# feature-space axes, in order
FEATURE_AXES = (
    "log_m",            # problem size decade
    "log_nnz",
    "row_nnz_mean",
    "row_nnz_cv",       # skew — the SELL-vs-ELL axis
    "rel_bandwidth",    # avg row bandwidth / n — RCM's objective, normalized
    "rel_profile",      # envelope per row / n
    "block_fill",       # 8x128 block density
    "blocks_per_row",   # distinct col blocks per block row (x-tile traffic)
    "log_density",      # density bucket (log10 nnz/(m*n))
)

_EPS = 1e-9


def embed(feat: dict) -> np.ndarray:
    """Project a tuner feature dict (tune.matrix_features) onto FEATURE_AXES.
    Missing keys (records from older schemas) default to 0."""
    m = max(int(feat.get("m", 1)), 1)
    n = max(int(feat.get("n", 1)), 1)
    nnz = max(int(feat.get("nnz", 1)), 1)
    nbr = max(int(feat.get("num_block_rows", 1)), 1)
    return np.array([
        math.log10(m),
        math.log10(nnz),
        nnz / m,
        float(feat.get("row_nnz_cv", 0.0)),
        float(feat.get("avg_row_bandwidth", 0.0)) / n,
        float(feat.get("profile_per_row", 0.0)) / n,
        float(feat.get("block_fill", 0.0)),
        float(feat.get("nonempty_blocks", 0)) / nbr,
        math.log10(max(nnz / (float(m) * float(n)), _EPS)),
    ], dtype=np.float64)


def _mine_record(record: dict) -> Optional[dict]:
    """One KB row from one stored cell record, or None if the record
    predates the learned-tuner schema."""
    feat = record.get("features")
    dec = record.get("tuner_decision")
    if not isinstance(feat, dict) or not isinstance(dec, dict):
        return None
    gflops = record.get("seq_ios_gflops") or record.get("gflops") or 0.0
    return {
        "vec": embed(feat),
        "decision": dec,
        "gflops": float(gflops),
        "matrix": record.get("matrix", "?"),
    }


class TuneAdvisor:
    """Feature-space nearest-neighbor over prior campaign decisions."""

    def __init__(self, store: Optional[ResultStore] = None,
                 k_neighbors: int = 3, top_k: int = 2):
        self.store = store or ResultStore()
        self.k_neighbors = max(int(k_neighbors), 1)
        # top_k < PROBE_TOP_K by design: the learned mode must probe
        # strictly fewer candidates than both probe modes
        self.top_k = max(int(top_k), 1)
        self._lock = threading.Lock()
        self._kb = None          # list of KB rows
        self._mat = None         # stacked feature matrix
        self._mean = None
        self._std = None

    # -- knowledge base ----------------------------------------------------
    def refresh(self) -> int:
        """(Re-)mine the ResultStore; returns the knowledge-base size."""
        rows = []
        for _key, entry in self.store.entries():
            row = _mine_record(entry.get("record", {}))
            if row is not None:
                rows.append(row)
        with self._lock:
            self._kb = rows
            if rows:
                self._mat = np.stack([r["vec"] for r in rows])
                self._mean = self._mat.mean(axis=0)
                std = self._mat.std(axis=0)
                self._std = np.where(std > _EPS, std, 1.0)
            else:
                self._mat = self._mean = self._std = None
        return len(rows)

    def knowledge_size(self) -> int:
        if self._kb is None:
            self.refresh()
        return len(self._kb)

    # -- matching ----------------------------------------------------------
    def _match(self, decision: dict, cands: list) -> Optional[dict]:
        """Map a mined decision onto the current candidate grid: exact
        (engine, block_shape, sigma) first, then (engine, block_shape),
        then cheapest same-engine candidate; None if the engine is gone."""
        eng = decision.get("engine")
        shape = tuple(decision.get("block_shape") or ())
        sigma = decision.get("sell_sigma")
        same_eng = [cd for cd in cands if cd["engine"] == eng]
        if not same_eng:
            return None
        for cd in same_eng:
            if tuple(cd["block_shape"]) == shape and cd["sigma"] == sigma:
                return cd
        for cd in same_eng:
            if tuple(cd["block_shape"]) == shape:
                return cd
        return same_eng[0]  # cands arrive model-ranked: cheapest first

    def shortlist(self, feat: dict, ranked_cands: list):
        """(shortlist, confidence, predicted_label) for a feature dict and
        a model-ranked candidate list. Empty shortlist = no usable
        knowledge (caller falls back to the model ranking)."""
        if self._kb is None:
            self.refresh()
        if not self._kb:
            return [], 0.0, None
        q = (embed(feat) - self._mean) / self._std
        d = np.linalg.norm((self._mat - self._mean) / self._std - q, axis=1)
        order = np.argsort(d, kind="stable")[:self.k_neighbors]
        picks, seen = [], set()
        for i in order:
            cd = self._match(self._kb[int(i)]["decision"], ranked_cands)
            if cd is None:
                continue
            lab = _label(cd["engine"], cd["block_shape"], cd["sigma"])
            if lab not in seen:
                seen.add(lab)
                picks.append(cd)
        if not picks:
            return [], 0.0, None
        predicted = _label(picks[0]["engine"], picks[0]["block_shape"],
                           picks[0]["sigma"])
        # pad with the model ranking so a lone neighbor still gets a
        # sanity-check competitor (but never reach PROBE_TOP_K width)
        for cd in ranked_cands:
            if len(picks) >= self.top_k:
                break
            lab = _label(cd["engine"], cd["block_shape"], cd["sigma"])
            if lab not in seen:
                seen.add(lab)
                picks.append(cd)
        confidence = float(1.0 / (1.0 + float(d[order[0]])))
        return picks[:self.top_k], confidence, predicted


# -- default advisor (what tune() reaches for) -----------------------------
# One advisor per store root: the KB is mined lazily on first use and
# shared across plans in the process; call refresh() (or advisor_reset())
# after seeding new measurements mid-process.
_DEFAULTS = {}
_DEFAULTS_LOCK = threading.Lock()


def default_advisor() -> TuneAdvisor:
    store = ResultStore()
    with _DEFAULTS_LOCK:
        adv = _DEFAULTS.get(store.root)
        if adv is None:
            adv = TuneAdvisor(store=store)
            _DEFAULTS[store.root] = adv
        return adv


def advisor_reset() -> None:
    """Drop memoized advisors (tests / after reseeding a store)."""
    with _DEFAULTS_LOCK:
        _DEFAULTS.clear()
