"""Workload streams — model-layer sparsity as per-step CSR matrices.

Each workload kind lowers one model-shaped sparse computation to a
per-step stream of `WorkloadStep`s whose operands are plain `CSRMatrix`
problems, so the Problem → Plan → Operator pipeline (and its plan store,
tuner, obs spans) measures workload-shaped sparsity with the same
machinery it uses for static SuiteSparse-style matrices:

  moe   — token→expert routing (models/layers/moe.py `route`): the
          sorted dispatch is a slot×token gather matrix D (one nonzero
          per slot row — the reordering), the combine a token×slot
          matrix C whose values are the router gates. Capacity clipping
          is the paper's nnz-balanced schedule; the routing LI (§6.1)
          rides on every step.
  attn  — block-sparse attention masks as BCSR-shaped CSR: causal
          block-banded window plus a few global column blocks, dense
          inside each (b × b) block (what the bcsr engine, K3, stores).
  gnn   — graph-NN neighborhood aggregation X' = A @ X: a synthetic
          adjacency (matrices/generators) with per-step edge weights,
          the SpMM path at feature width f.

Names are `workload://<kind>-<tag><int>-...` (hyphen-separated,
letter-tagged integers — CSV-safe), e.g.
`workload://moe-e8-k2-t512-d32-n6`. The *scenario* — how the stream
evolves step to step — is deliberately NOT part of the name; it is the
experiment spec's variants axis:

  static — the sparsity STRUCTURE is frozen; only values change per step
           (router gates / attention scores / edge weights). The
           amortization best case: one plan, value-only rebuilds.
  drift  — the structure changes every step (tokens drift, global
           attention blocks resample, edges rewire). The paper's
           break-even question at its least favorable: plan cost must
           amortize within a single step.
  shift1 — the structure changes exactly once, mid-stream (regime
           change); everything else is reuse.

The JAX package's module, in numpy: the same name, scenario and seed
give the same steps, bit for bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.sparse.csr import CSRMatrix
from ..matrices import generators as G

SCENARIOS = ("static", "drift", "shift1")
PREFIX = "workload://"

# canonical presets (the suite's "workload tier"; any parameterization of
# the grammar resolves, these are just the named entry points)
WORKLOAD_PRESETS = (
    "workload://moe-e8-k2-t512-d32-n6",
    "workload://moe-e16-k2-t2048-d128-n4",
    "workload://attn-s256-b32-w2-g1-d16-n6",
    "workload://gnn-m512-deg4-f16-n6",
)

_DEFAULTS = {
    "moe": {"e": 8, "k": 2, "t": 512, "d": 32, "n": 6, "cf": 1.25},
    "attn": {"s": 256, "b": 32, "w": 2, "g": 1, "d": 16, "n": 6},
    # rw — drift rewire fraction: 0 resamples the WHOLE adjacency each
    # drift step (legacy full-churn drift); rw>0 rewires only that edge
    # fraction per step (delete rw*nnz edges, add as many new ones) —
    # the incremental drift a StructureDelta amortizes (core/spmv/delta)
    "gnn": {"m": 512, "deg": 4, "f": 16, "n": 6, "rw": 0},
}
_TOKEN_RE = re.compile(r"^([a-z]+)(\d+(?:\.\d+)?)$")


@dataclasses.dataclass(frozen=True)
class WorkloadDef:
    """A parsed workload name: the kind plus its integer/float params."""

    name: str
    kind: str
    params: dict

    @property
    def steps(self) -> int:
        return int(self.params["n"])

    @property
    def width(self) -> int:
        """Feature width — the SpMM k the stream's operands carry."""
        return int(self.params["d" if self.kind != "gnn" else "f"])


@dataclasses.dataclass(frozen=True)
class Operand:
    """One sparse stage of a step: `x` is the [n, width] input block;
    x=None chains the previous stage's output (moe combine)."""

    role: str
    mat: CSRMatrix
    x: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class WorkloadStep:
    """One step of the stream: the operand chain plus per-step metadata
    (routing LI, drop fraction, and whatever the kind's reference path
    needs — see adapters.py)."""

    index: int
    operands: Tuple[Operand, ...]
    meta: dict


def parse_workload(name: str) -> WorkloadDef:
    """`workload://moe-e8-k2-t512-d32-n6` → WorkloadDef. Unknown kinds or
    tags raise with the known grammar."""
    if not name.startswith(PREFIX):
        raise ValueError(f"workload names start with {PREFIX!r}: {name!r}")
    toks = name[len(PREFIX):].split("-")
    kind = toks[0]
    if kind not in _DEFAULTS:
        raise ValueError(f"unknown workload kind {kind!r} in {name!r}; "
                         f"known: {sorted(_DEFAULTS)}")
    params = dict(_DEFAULTS[kind])
    for t in toks[1:]:
        m = _TOKEN_RE.match(t)
        if not m or m.group(1) not in params:
            raise ValueError(
                f"bad workload token {t!r} in {name!r}; known tags for "
                f"{kind!r}: {sorted(_DEFAULTS[kind])}")
        tag, val = m.group(1), m.group(2)
        params[tag] = float(val) if "." in val else int(val)
    return WorkloadDef(name=name, kind=kind, params=params)


def preset_names() -> list:
    return list(WORKLOAD_PRESETS)


def representative(name: str) -> CSRMatrix:
    """The step-0 primary matrix — what `suite.get("workload://...")`
    returns, so non-workload consumers (spmv cells, spmv_bench) can treat
    a workload name as a static matrix."""
    step = next(steps(parse_workload(name), "static", seed=0))
    return step.operands[0].mat


def steps(wdef: WorkloadDef, scenario: str = "drift",
          seed: int = 0) -> Iterator[WorkloadStep]:
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"known: {SCENARIOS}")
    gen = {"moe": _moe_steps, "attn": _attn_steps, "gnn": _gnn_steps}
    return gen[wdef.kind](wdef.params, scenario, int(seed))


# --------------------------------------------------------------------------
# MoE routing (numpy mirror of models/layers/moe.py `route`)
# --------------------------------------------------------------------------
def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=-1, keepdims=True)
    ez = np.exp(z)
    return ez / ez.sum(axis=-1, keepdims=True)


def moe_route_np(x: np.ndarray, w_router: np.ndarray, top_k: int):
    """Numpy mirror of moe.route: (gates [n,k], experts [n,k]). Stable
    argsort ties match jax.lax.top_k (lower index wins)."""
    probs = _softmax(x.astype(np.float32) @ w_router)
    experts = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
    gates = np.take_along_axis(probs, experts, axis=-1)
    gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    return gates.astype(np.float32), experts.astype(np.int32)


def moe_capacity(n_tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """The nnz-balanced slot count (paper Listing 5 analogue; the
    models/layers/moe.py formula, 8-aligned)."""
    return int(np.ceil(n_tokens * top_k * capacity_factor
                       / num_experts / 8)) * 8


def routing_matrices(experts: np.ndarray, gates: np.ndarray,
                     num_experts: int, cap: int):
    """Lower one routing decision to the (dispatch, combine) matrix pair.

    Dispatch D [E*cap, n]: D[e*cap + rank, tok] = 1 for each kept
    (token, expert) assignment, rank computed in SORTED (expert-major)
    order — one nonzero per slot row, so D @ x is exactly the sorted
    dispatch gather. Combine C [n, E*cap]: C[tok, slot] = gate. Returns
    (D, C, meta) with the per-step routing LI (paper §6.1) and the
    capacity drop fraction.
    """
    n, k = experts.shape
    ef = experts.reshape(-1).astype(np.int64)
    tok = np.repeat(np.arange(n, dtype=np.int64), k)
    gf = gates.reshape(-1)
    order = np.argsort(ef, kind="stable")
    ef_s, tok_s, gf_s = ef[order], tok[order], gf[order]
    seg_start = np.searchsorted(ef_s, ef_s, side="left")
    rank = np.arange(n * k, dtype=np.int64) - seg_start
    keep = rank < cap
    slot = ef_s[keep] * cap + rank[keep]
    disp = CSRMatrix.from_coo(slot, tok_s[keep],
                              np.ones(slot.size, np.float32),
                              (num_experts * cap, n))
    comb = CSRMatrix.from_coo(tok_s[keep], slot,
                              gf_s[keep].astype(np.float32),
                              (n, num_experts * cap))
    counts = np.bincount(ef, minlength=num_experts).astype(np.float64)
    meta = {
        "li": float(counts.max() / max(counts.mean(), 1e-9)),
        "drop_frac": float(1.0 - keep.mean()),
    }
    return disp, comb, meta


def _moe_steps(p: dict, scenario: str, seed: int) -> Iterator[WorkloadStep]:
    e, k, n, d = int(p["e"]), int(p["k"]), int(p["t"]), int(p["d"])
    nsteps, cf = int(p["n"]), float(p["cf"])
    rng = np.random.default_rng(seed)
    w_router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    x0 = rng.standard_normal((n, d)).astype(np.float32)
    x_shift = None
    cap = moe_capacity(n, k, e, cf)
    for t in range(nsteps):
        srng = np.random.default_rng(seed + 1000 + t)
        if scenario == "static":
            # positive per-step rescale: softmax sharpens, so the GATE
            # VALUES change every step while the top-k set (and order,
            # hence the dispatch/combine STRUCTURE) is invariant
            x = x0 * np.float32(1.0 + 0.25 * t)
        elif scenario == "drift":
            x = (x0 + 0.5 * srng.standard_normal((n, d))).astype(np.float32)
        else:  # shift1: regime change at the midpoint
            if t < nsteps // 2:
                x = x0
            else:
                if x_shift is None:
                    x_shift = np.random.default_rng(seed + 7) \
                        .standard_normal((n, d)).astype(np.float32)
                x = x_shift
        gates, experts = moe_route_np(x, w_router, k)
        disp, comb, meta = routing_matrices(experts, gates, e, cap)
        meta.update(experts=experts, gates=gates, num_experts=e, cap=cap,
                    top_k=k)
        yield WorkloadStep(index=t, operands=(
            Operand("dispatch", disp, x),
            Operand("combine", comb, None),      # chains the dispatch buf
        ), meta=meta)


# --------------------------------------------------------------------------
# block-sparse attention masks (BCSR-shaped)
# --------------------------------------------------------------------------
def attn_block_pattern(nb: int, window: int, n_global: int,
                       rng: np.random.Generator):
    """Block coordinates of a causal banded-window mask plus n_global
    randomly chosen global column blocks (kept causal)."""
    bi, bj = [], []
    gcols = (rng.choice(nb, size=min(n_global, nb), replace=False)
             if n_global else np.empty(0, np.int64))
    for i in range(nb):
        js = set(range(max(0, i - window + 1), i + 1))
        js.update(int(g) for g in gcols if g <= i)
        for j in sorted(js):
            bi.append(i)
            bj.append(j)
    return np.asarray(bi, np.int64), np.asarray(bj, np.int64)


def _attn_steps(p: dict, scenario: str, seed: int) -> Iterator[WorkloadStep]:
    s, b, w = int(p["s"]), int(p["b"]), int(p["w"])
    g, d, nsteps = int(p["g"]), int(p["d"]), int(p["n"])
    if s % b:
        raise ValueError(f"attn workload needs block|seq: s={s}, b={b}")
    nb = s // b
    rng = np.random.default_rng(seed)
    bi0, bj0 = attn_block_pattern(nb, w, g, rng)
    bi1 = bj1 = None
    x = rng.standard_normal((s, d)).astype(np.float32)
    di, dj = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    for t in range(nsteps):
        srng = np.random.default_rng(seed + 2000 + t)
        if scenario == "static":
            bi, bj = bi0, bj0
        elif scenario == "drift":
            bi, bj = attn_block_pattern(nb, w, g, srng)
        else:  # shift1
            if t < nsteps // 2:
                bi, bj = bi0, bj0
            else:
                if bi1 is None:
                    bi1, bj1 = attn_block_pattern(
                        nb, w, g, np.random.default_rng(seed + 9))
                bi, bj = bi1, bj1
        rows = (bi[:, None, None] * b + di[None]).reshape(-1)
        cols = (bj[:, None, None] * b + dj[None]).reshape(-1)
        # per-step scores: a value-only change whenever the pattern holds
        vals = (srng.standard_normal(rows.size) / np.sqrt(b)) \
            .astype(np.float32)
        mask = CSRMatrix.from_coo(rows, cols, vals, (s, s))
        bcounts = np.bincount(bi, minlength=nb).astype(np.float64)
        meta = {"li": float(bcounts.max() / max(bcounts.mean(), 1e-9)),
                "block": b, "nblocks": int(bi.size)}
        yield WorkloadStep(index=t, operands=(
            Operand("mask", mask, x),), meta=meta)


# --------------------------------------------------------------------------
# graph-NN aggregation (SpMM over a synthetic adjacency)
# --------------------------------------------------------------------------
def _rewire_graph(mat: CSRMatrix, frac: float, seed: int) -> CSRMatrix:
    """Rewire `frac` of the edges: delete that many uniformly chosen
    entries and add as many fresh (row, col) pairs that don't collide
    with the survivors. Shape and nnz are preserved — the incremental
    counterpart of a full adjacency resample."""
    rng = np.random.default_rng(seed)
    m, n = mat.shape
    rows = np.repeat(np.arange(m, dtype=np.int64),
                     np.diff(mat.rowptr.astype(np.int64)))
    cols = mat.cols.astype(np.int64)
    vals = mat.vals
    k = max(1, int(round(frac * mat.nnz)))
    drop = rng.choice(mat.nnz, size=k, replace=False)
    keep = np.ones(mat.nnz, dtype=bool)
    keep[drop] = False
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    taken = set((rows * n + cols).tolist())
    new = []
    while len(new) < k:
        r = int(rng.integers(m)) * n + int(rng.integers(n))
        if r not in taken:
            taken.add(r)
            new.append(r)
    new = np.asarray(new, dtype=np.int64)
    rows = np.concatenate([rows, new // n])
    cols = np.concatenate([cols, new % n])
    vals = np.concatenate(
        [vals, rng.standard_normal(k).astype(vals.dtype)])
    return CSRMatrix.from_coo(rows, cols, vals, (m, n))


def _gnn_steps(p: dict, scenario: str, seed: int) -> Iterator[WorkloadStep]:
    m, deg, f, nsteps = (int(p["m"]), int(p["deg"]), int(p["f"]),
                         int(p["n"]))
    rw = float(p.get("rw", 0))
    rng = np.random.default_rng(seed)
    base = G.random_uniform(m, deg, seed=seed)
    cur = base
    shifted = None
    x = rng.standard_normal((m, f)).astype(np.float32)
    for t in range(nsteps):
        srng = np.random.default_rng(seed + 3000 + t)
        if scenario == "drift" and rw > 0 and t > 0:
            cur = _rewire_graph(cur, rw, seed=seed + 100 + t)
            adj = cur
        elif scenario == "drift" and rw > 0:
            adj = cur
        elif scenario == "drift":
            adj = G.random_uniform(m, deg, seed=seed + 100 + t)
        elif scenario == "shift1" and t >= nsteps // 2:
            if shifted is None:
                shifted = G.random_uniform(m, deg, seed=seed + 11)
            adj = shifted
        else:
            adj = base
        # per-step edge weights (message weights): value-only when the
        # adjacency is held
        adj = dataclasses.replace(
            adj, vals=srng.standard_normal(adj.nnz).astype(np.float32))
        counts = adj.row_nnz().astype(np.float64)
        meta = {"li": float(counts.max() / max(counts.mean(), 1e-9))}
        yield WorkloadStep(index=t, operands=(
            Operand("aggregate", adj, x),), meta=meta)
