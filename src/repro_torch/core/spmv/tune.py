"""OSKI-style per-matrix engine autotuning (Akbudak et al.; Schubert et al.).

The same features, cost model and candidate grid as the JAX package's
tuner, so a matrix gets the same plan from both packages. SpMV is
bandwidth-bound, so the model scores each candidate (engine, shape) by the
bytes it streams per multiply: stored values + index metadata + an
x-gather term scaled by a locality penalty from the paper's structural
metrics (bandwidth, row-nnz CV, block fill). The model is k-aware: matrix
bytes stream once per multiply while x/y traffic scales with the RHS width.

The cost functions and candidate grids ride on the engine registry
(core/registry.py) as `cost_fn` / `candidates_fn`.

Tuning modes (the `probe` argument):
  * False        — rank candidates by modelled bytes, build the argmin.
  * True         — additionally time the top PROBE_TOP_K candidates and
                   build the measured winner.
  * "learned"    — ask the corpus TuneAdvisor (repro_torch.corpus.advisor)
                   for a nearest-neighbor shortlist mined from the port's
                   prior ResultStore cells and time only that (strictly
                   fewer candidates than either probe mode); an empty
                   knowledge base falls back to the model's top
                   PROBE_TOP_K and bumps `advisor.fallbacks`.
  * "exhaustive" — time every candidate.
Probes time with CUDA events on the card (core/measure/ios.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ... import obs
from ...device import resolve_device, torch_dtype
from .. import registry
from ..sparse import metrics
from ..sparse.csr import CSRMatrix
from ..sparse.sell import pick_chunk_width, sell_padded_nnz

# dense fallback threshold: below this many logical entries the dense
# engine's simplicity beats any sparse format's index traffic
_DENSE_MAX_ENTRIES = 64 * 64
PROBE_TOP_K = 3
PROBE_ITERS = 3

# the values `probe` accepts, here and up through plan()/MeasurePolicy
PROBE_MODES = (False, True, "learned", "exhaustive")

_VAL = 4          # float32 bytes
_IDX = 4          # int32 bytes


@dataclasses.dataclass(frozen=True)
class TunePlan:
    engine: str                       # chosen engine name
    block_shape: tuple                # (bm, bn) bell/bcsr; (C, W) sell
    sell_sigma: Optional[int]         # σ window (sell only)
    cost_bytes: float                 # modelled bytes/SpMM of the choice
    costs: dict                       # candidate label -> modelled bytes
    features: dict                    # structural features the model used
    source: str                       # "model" | "probe" | "learned" | "fixed"
    probe_ms: Optional[dict] = None   # candidate label -> measured ms
    tune_ms: float = 0.0              # wall time spent deciding
    k: int = 1                        # RHS batch width the plan was tuned for
    advisor: Optional[dict] = None    # learned mode: {confidence, predicted,
    #                                   hit, shortlist} (None otherwise)

    def label(self) -> str:
        base = _label(self.engine, self.block_shape, self.sell_sigma)
        return base if self.k == 1 else f"{base}@k{self.k}"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["block_shape"] = list(self.block_shape)
        return d

    @staticmethod
    def from_json(d: dict) -> "TunePlan":
        """From this class's or the JAX package's to_json() (fields the
        port does not keep are dropped)."""
        names = {f.name for f in dataclasses.fields(TunePlan)}
        d = {k: v for k, v in d.items() if k in names}
        d["block_shape"] = tuple(d["block_shape"])
        return TunePlan(**d)


def fixed_plan(engine: str, block_shape: tuple = (8, 128),
               sell_sigma: Optional[int] = None, k: int = 1) -> TunePlan:
    """A TunePlan for an explicitly requested engine (no search)."""
    if engine == "sell" and sell_sigma is None:
        sell_sigma = 8 * block_shape[0]
    return TunePlan(engine=engine, block_shape=tuple(block_shape),
                    sell_sigma=sell_sigma, cost_bytes=0.0, costs={},
                    features={}, source="fixed", k=max(int(k), 1))


def _label(engine: str, block_shape: tuple, sigma: Optional[int]) -> str:
    if engine in ("csr", "ell", "dense"):
        return engine
    if engine == "sell":
        return f"sell_c{block_shape[0]}w{block_shape[1]}s{sigma}"
    return f"{engine}_{block_shape[0]}x{block_shape[1]}"


def matrix_features(mat: CSRMatrix, bm: int = 8, bn: int = 128) -> dict:
    """The structural quantities the cost model conditions on."""
    counts = mat.row_nnz()
    mean = float(counts.mean()) if mat.m else 0.0
    cv = float(counts.std() / mean) if mean > 0 else 0.0
    r = np.repeat(np.arange(mat.m, dtype=np.int64), counts)
    c = mat.cols.astype(np.int64)
    nbc = (mat.n + bn - 1) // bn
    bkeys = (r // bm) * nbc + (c // bn)
    ub = metrics.sorted_unique(bkeys) if mat.nnz else np.empty(0, np.int64)
    nblocks = int(ub.size)
    br_counts = np.bincount((ub // nbc).astype(np.int64),
                            minlength=(mat.m + bm - 1) // bm) if nblocks else \
        np.zeros((mat.m + bm - 1) // max(bm, 1), dtype=np.int64)
    return {
        "m": int(mat.m),
        "n": int(mat.n),
        "nnz": int(mat.nnz),
        "row_nnz_max": int(counts.max()) if mat.m else 0,
        "row_nnz_cv": cv,
        "avg_row_bandwidth": metrics.avg_row_bandwidth(mat),
        "bandwidth": metrics.bandwidth(mat),
        "profile_per_row": float(metrics.profile(mat)) / max(mat.m, 1),
        "block_fill": float(mat.nnz / max(nblocks * bm * bn, 1)),
        "nonempty_blocks": nblocks,
        "block_row_max": int(br_counts.max()) if br_counts.size else 0,
        "num_block_rows": int(br_counts.shape[0]),
    }


def _gather_penalty(feat: dict, line: int = 128) -> float:
    """Model of x re-read traffic for element-gather engines: interpolate
    from one read of x (small bandwidth) to a line fetch per nonzero on the
    avg row bandwidth measured in lines — the quantity RCM minimizes."""
    spread = feat["avg_row_bandwidth"] / line
    return 1.0 + min(spread, 8.0)


def _gather(feat: dict, k: int) -> float:
    """k-amortized gather penalty: the k values of a gathered x row are
    contiguous in the [n, k] layout."""
    return 1.0 + (_gather_penalty(feat) - 1.0) / min(k, 32)


# -- per-engine cost models (attached to the registry as cost_fn) ----------
# Signature: (feat, block_shape, sigma, sell_pad, k) -> modelled bytes.
# cost(k) = matrix_bytes + k * per_vector_bytes.

def cost_dense(feat, block_shape, sigma, sell_pad, k):
    m, n = feat["m"], feat["n"]
    return float(m * n * _VAL + k * (n * _VAL + m * _VAL))


def cost_csr(feat, block_shape, sigma, sell_pad, k):
    m, nnz = feat["m"], feat["nnz"]
    return float(nnz * (_VAL + 2 * _IDX)
                 + k * (nnz * _VAL * _gather(feat, k) * 0.25 + m * _VAL))


def cost_ell(feat, block_shape, sigma, sell_pad, k):
    m = feat["m"]
    pad = m * max(feat["row_nnz_max"], 1)
    return float(pad * (_VAL + _IDX)
                 + k * (pad * _VAL * _gather(feat, k) * 0.25 + m * _VAL))


def cost_sell(feat, block_shape, sigma, sell_pad, k):
    pad = sell_pad if sell_pad is not None else feat["nnz"]
    return float(pad * (_VAL + _IDX)
                 + k * (pad * _VAL * _gather(feat, k) * 0.25
                        + feat["m"] * _VAL))


def cost_bell(feat, block_shape, sigma, sell_pad, k):
    bm, bn = block_shape
    pad_blocks = feat["num_block_rows"] * max(feat["block_row_max"], 1)
    return float(pad_blocks * (bm * bn * _VAL + _IDX)
                 + k * (pad_blocks * bn * _VAL + feat["m"] * _VAL))


def cost_bcsr(feat, block_shape, sigma, sell_pad, k):
    bm, bn = block_shape
    blocks = max(feat["nonempty_blocks"], 1)
    return float(blocks * (bm * bn * _VAL + 2 * _IDX)
                 + k * (blocks * bn * _VAL + feat["m"] * _VAL))


# -- per-engine candidate grids (attached as candidates_fn) ----------------
# Signature: (mat, feat) -> [{"block_shape": ..., "sigma": ..., ...}].
# The reference's grid, kept so both packages plan alike.

def cands_default(mat, feat):
    return [dict(block_shape=(8, 128), sigma=None)]


def cands_sell(mat, feat):
    c = 8
    w_fit = pick_chunk_width(mat)
    out = []
    for w in {w_fit, 128}:
        # σ = whole-matrix sort packs similar-degree rows best; the small
        # window keeps rows near their reordered position (cache locality)
        for sigma in (8 * c, max(int(feat["m"]), 1)):
            out.append(dict(block_shape=(c, w), sigma=sigma,
                            sell_pad=sell_padded_nnz(mat, c, sigma, w)))
    return out


def cands_dense(mat, feat):
    if feat["m"] * feat["n"] <= _DENSE_MAX_ENTRIES:
        return [dict(block_shape=(8, 128), sigma=None)]
    return []


def candidate_cost(feat: dict, engine: str, block_shape: tuple = (8, 128),
                   sigma: Optional[int] = None,
                   sell_pad: Optional[int] = None, k: int = 1) -> float:
    """Modelled bytes streamed per SpMM with k right-hand sides."""
    from . import ops  # noqa: F401 — ensure built-in engines are registered

    spec = registry.get_engine(engine)
    if spec.cost_fn is None:
        raise KeyError(f"engine {engine!r} registered without a cost_fn")
    return spec.cost_fn(feat, block_shape, sigma, sell_pad, max(int(k), 1))


def enumerate_candidates(mat: CSRMatrix, feat: dict) -> list[dict]:
    """The (engine, shape) grid: every registered engine with a cost model
    contributes its candidates_fn grid, in registration order."""
    from . import ops  # noqa: F401 — ensure built-in engines are registered

    cands = []
    for spec in registry.ENGINE_REGISTRY.values():
        if spec.cost_fn is None or spec.candidates_fn is None:
            continue
        for shape in spec.candidates_fn(mat, feat):
            cands.append(dict({"engine": spec.name}, **shape))
    return cands


def tune(mat: CSRMatrix, probe=False, dtype=None, use_kernel: str = "auto",
         k: int = 1, device=None, advisor=None) -> TunePlan:
    """Pick (engine, shape) for `mat` at RHS batch width k. Probing builds
    and times candidates on `device` (None = the card). `advisor`
    optionally injects a corpus TuneAdvisor for probe="learned"; by default
    the process-wide advisor over the default ResultStore is used."""
    if probe not in PROBE_MODES:
        raise ValueError(f"probe must be one of {PROBE_MODES}, got {probe!r}")
    with obs.span("plan.tune", shape=str(tuple(mat.shape)),
                  nnz=int(mat.nnz), probe=str(probe), k=int(k),
                  backend="torch") as sp:
        t0 = time.perf_counter()
        k = max(int(k), 1)
        feat = matrix_features(mat)
        cands = enumerate_candidates(mat, feat)
        costs = {}
        for cd in cands:
            costs[_label(cd["engine"], cd["block_shape"], cd["sigma"])] = \
                candidate_cost(feat, cd["engine"], cd["block_shape"],
                               cd["sigma"], cd.get("sell_pad"), k=k)
        ranked = sorted(cands, key=lambda cd: costs[
            _label(cd["engine"], cd["block_shape"], cd["sigma"])])
        best, probe_ms, source, adv_info = ranked[0], None, "model", None
        if probe:
            to_probe, adv_info = _probe_set(probe, ranked, feat, advisor)
            best, probe_ms = _probe(mat, to_probe, dtype, use_kernel, k,
                                    device)
            source = "probe"
            if adv_info is not None and adv_info["predicted"] is not None:
                # predicted-vs-probed agreement: the advisor's learning signal
                hit = adv_info["predicted"] == _label(
                    best["engine"], best["block_shape"], best["sigma"])
                adv_info["hit"] = hit
                obs.counter("advisor.hits" if hit else "advisor.misses").inc()
                source = "learned"
        lab = _label(best["engine"], best["block_shape"], best["sigma"])
        sp.set(engine=best["engine"], source=source)
        return TunePlan(engine=best["engine"],
                        block_shape=best["block_shape"],
                        sell_sigma=best["sigma"], cost_bytes=costs[lab],
                        costs=costs, features=feat, source=source,
                        probe_ms=probe_ms,
                        tune_ms=(time.perf_counter() - t0) * 1e3, k=k,
                        advisor=adv_info)


def _probe_set(probe, ranked, feat, advisor):
    """The candidates to time, plus the advisor record for learned mode."""
    if probe == "exhaustive":
        return ranked, None
    if probe != "learned":
        return ranked[:PROBE_TOP_K], None
    if advisor is None:
        from ...corpus.advisor import default_advisor
        advisor = default_advisor()
    shortlist, confidence, predicted = advisor.shortlist(feat, ranked)
    if not shortlist:
        obs.counter("advisor.fallbacks").inc()
        return ranked[:PROBE_TOP_K], {"confidence": 0.0, "predicted": None,
                                      "hit": None, "shortlist": 0}
    return shortlist, {"confidence": confidence, "predicted": predicted,
                       "hit": None, "shortlist": len(shortlist)}


# (device, dtype) pairs whose IOS timing path this process has warmed
_WARMED: set = set()


def _probe(mat, to_probe, dtype, use_kernel, k, device):
    """Time each candidate (IOS, CUDA events on the card); return the
    fastest and the label -> ms map. The first probe of a process on a
    (device, dtype) first runs one untimed IOS pass on its first candidate
    (counted by `probe.warmups`): the process's first timed calls carry
    start-up cost that the one warm-up call of each timing does not
    absorb, and would read the first candidate slow."""
    from ..measure import ios
    from .ops import make_engine

    warm_key = (str(resolve_device(device)), torch_dtype(dtype))
    probe_ms, best, best_ms = {}, to_probe[0], np.inf
    for cd in to_probe:
        lab = _label(cd["engine"], cd["block_shape"], cd["sigma"])
        with obs.span("plan.probe", candidate=lab, engine=cd["engine"],
                      k=int(k), backend="torch") as psp:
            op = make_engine(mat, cd["engine"], dtype=dtype,
                             block_shape=cd["block_shape"],
                             sell_sigma=cd["sigma"], use_kernel=use_kernel,
                             device=device)
            if warm_key not in _WARMED:
                ios.run_ios_batched(op, mat.n, k, iters=PROBE_ITERS,
                                    warmup=1, dtype=dtype, device=device)
                _WARMED.add(warm_key)
                obs.counter("probe.warmups").inc()
            ms = float(np.median(ios.run_ios_batched(
                op, mat.n, k, iters=PROBE_ITERS, warmup=1, dtype=dtype,
                device=device)))
            psp.set(ms=ms)
        probe_ms[lab] = ms
        if ms < best_ms:
            best_ms, best = ms, cd
    return best, probe_ms


def build_from_plan(mat: CSRMatrix, plan: TunePlan, dtype=None,
                    use_kernel: str = "auto", device=None):
    """Materialize the operator a plan describes on `device`. The plan's k
    only steered the engine choice; the format is k-agnostic."""
    from .ops import make_engine

    op = make_engine(mat, plan.engine, dtype=dtype,
                     block_shape=plan.block_shape,
                     sell_sigma=plan.sell_sigma, use_kernel=use_kernel,
                     device=device)
    op.plan = plan
    return op


def build_tuned(mat: CSRMatrix, dtype=None, probe=False,
                use_kernel: str = "auto", k: int = 1, device=None):
    """engine="auto" entry point: tune, build, attach the plan."""
    plan = tune(mat, probe=probe, dtype=dtype, use_kernel=use_kernel, k=k,
                device=device)
    return build_from_plan(mat, plan, dtype=dtype, use_kernel=use_kernel,
                           device=device)
