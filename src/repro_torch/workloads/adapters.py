"""Model-layer adapters: moe/attention/gnn rewired through the pipeline.

Two jobs. First, the workload-facing forward paths: the sorted MoE
dispatch and a block-sparse attention score-matmul expressed as
*registry operators* — same engines, same plan store, same obs spans as
every static benchmark, so workload-shaped sparsity is measured by
exactly the machinery the paper's static matrices go through (under a
sell plan a product is K2, under bcsr K3). Second, the reference paths
`run_stream` verifies and races against: the GShard-style onehot scatter
dispatch (the unreordered baseline) and plain products for attention
masks / GNN adjacencies.

Equality contract: the sparse dispatch D @ x and the onehot scatter
place each kept token's row exactly once (one nonzero of value 1.0 per
slot row — multiplying by 1.0 and adding 0.0 are exact in f32), so the
dispatch buffers must be BITWISE equal; the combine sums k gate-weighted
contributions per token in different orders (`index_add_` on CUDA adds
atomically), so it is compared at rel err < 1e-3.

The JAX package's module in torch, on one device (`device=None` is the
card). Its attention/GNN reference is a dense matmul; here it is too,
while the dense operand holds at most DENSE_MAX_ELEMS elements. Past that
(a GNN adjacency of 1,048,576 rows would be 4 TiB dense) the reference is
the plain gather/`index_add_` product of the same CSR, which computes the
same function.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core.spmv.plan import SpmvProblem, plan as plan_fn
from ..device import resolve_device
from . import sources

DENSE_MAX_ELEMS = 1 << 28        # 1 GiB of float32


def to_device(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def block_until_ready(y):
    if isinstance(y, torch.Tensor) and y.is_cuda:
        torch.cuda.synchronize(y.device)
    return y


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _plan_op(mat, k, *, reorder="baseline", engine="auto", hints=None,
             device=None):
    return plan_fn(SpmvProblem(mat=mat, k=k, hints=dict(hints or {})),
                   reorder=reorder, engine=engine,
                   device=device).build(device=device)


# --------------------------------------------------------------------------
# pipeline-rewired forward paths
# --------------------------------------------------------------------------
def moe_sorted_dispatch(x, w_router, top_k: int, num_experts: int,
                        capacity_factor: float = 1.25, *, session=None,
                        reorder: str = "baseline", engine: str = "auto",
                        device=None):
    """The sorted MoE dispatch as pipeline operators.

    route (sources.moe_route_np) → (dispatch D, combine C) → registry
    operators → buf = D @ x, y = C @ buf. With a `WorkloadSession`, plans
    amortize across calls (value-only routing changes rebuild, identical
    routing reuses) and the session's device is used. Returns
    (buf [E*cap, d], y [n, d], info) as numpy — info carries
    li/drop_frac/cap and the session events when one is used.
    """
    x = np.asarray(x, np.float32)
    gates, experts = sources.moe_route_np(x, np.asarray(w_router, np.float32),
                                          top_k)
    cap = sources.moe_capacity(x.shape[0], top_k, num_experts,
                               capacity_factor)
    disp, comb, info = sources.routing_matrices(experts, gates,
                                                num_experts, cap)
    info.update(cap=cap, num_experts=num_experts)
    if session is not None:
        device = session.device
        d_op, ev_d = session.operator(disp, role="dispatch")
        c_op, ev_c = session.operator(comb, role="combine")
        info["events"] = (ev_d, ev_c)
    else:
        d = x.shape[1]
        d_op = _plan_op(disp, d, reorder=reorder, engine=engine,
                        device=device)
        c_op = _plan_op(comb, d, reorder=reorder, engine=engine,
                        device=device)
    xd = to_device(x, device)
    buf = d_op.matmul(xd)
    y = block_until_ready(c_op.matmul(buf))
    return buf.cpu().numpy(), y.cpu().numpy(), info


def block_sparse_attention(scores, v, *, session=None,
                           reorder: str = "baseline", engine: str = "auto",
                           block: int = 0, device=None):
    """Block-sparse attention score application y = scores @ v through a
    registry operator. `scores` is the masked (already-normalized) score
    matrix as CSRMatrix — dense inside each (b × b) block — lowered with
    the `block_shape` hint so BCSR-shaped engines are on the menu."""
    hints = {"block_shape": (block, block)} if block else None
    if session is not None:
        device = session.device
        op, _ = session.operator(scores, role="mask")
    else:
        op = _plan_op(scores, np.asarray(v).shape[1], reorder=reorder,
                      engine=engine, hints=hints, device=device)
    return block_until_ready(op.matmul(to_device(v, device))).cpu().numpy()


def gnn_aggregate(adj, x, *, session=None, reorder: str = "baseline",
                  engine: str = "auto", device=None):
    """GNN neighborhood aggregation X' = A @ X (SpMM at feature width)."""
    if session is not None:
        device = session.device
        op, _ = session.operator(adj, role="aggregate")
    else:
        op = _plan_op(adj, np.asarray(x).shape[1], reorder=reorder,
                      engine=engine, device=device)
    return block_until_ready(op.matmul(to_device(x, device))).cpu().numpy()


# --------------------------------------------------------------------------
# reference paths (what run_stream verifies against and races)
# --------------------------------------------------------------------------
def _onehot_dispatch_combine(x_flat, experts, gates, num_experts, cap):
    """The GShard onehot dispatch and combine, minus the expert FFN: rank
    via cumsum over UNSORTED assignments, scatter to the slot buffer
    (row E*cap takes the dropped assignments and is cut off), gather, and
    the gate-weighted combine through `index_add_`."""
    n, d = x_flat.shape
    k = experts.shape[1]
    dev = x_flat.device
    ef = experts.reshape(-1).long()
    tok = torch.arange(n, device=dev).repeat_interleave(k)
    gf = gates.reshape(-1)
    onehot_full = torch.nn.functional.one_hot(ef, num_experts)
    rank = (onehot_full.cumsum(0) - 1)[torch.arange(n * k, device=dev), ef]
    keep = rank < cap
    slot = torch.where(keep, ef * cap + rank,
                       torch.full_like(ef, num_experts * cap))
    buf = torch.zeros((num_experts * cap + 1, d), dtype=x_flat.dtype,
                      device=dev)
    buf[slot] = x_flat[tok]
    buf = buf[:-1]
    y_flat = torch.cat([buf, buf.new_zeros((1, d))])
    contrib = y_flat[slot] * (gf * keep)[:, None]
    y = torch.zeros((n, d), dtype=x_flat.dtype,
                    device=dev).index_add_(0, tok, contrib)
    return buf, y


def _dense_matmul(a, x):
    return a @ x


def _scatter_matmul(m, rows, cols, vals, x):
    """y = A @ x from A's m and coordinates: gather, scale, `index_add_`."""
    return x.new_zeros((m, x.shape[1])).index_add_(0, rows,
                                                    vals[:, None] * x[cols])


def _plain_product(mat, x, dev):
    """(fn, args) of the reference product A @ x: dense while the dense
    operand holds at most DENSE_MAX_ELEMS elements, else the scatter
    product over A's coordinates."""
    m, n = mat.shape
    if m * n <= DENSE_MAX_ELEMS:
        return _dense_matmul, (to_device(mat.to_dense(), dev), x)
    rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_nnz())
    return (functools.partial(_scatter_matmul, m),
            (to_device(rows, dev), to_device(mat.cols.astype(np.int64), dev),
             to_device(mat.vals, dev), x))


def reference(kind: str, step: sources.WorkloadStep, iters: int = 3,
              device=None) -> dict:
    """Run the kind's reference path on one step; returns {"ms", "y"}
    (+ "buf" for moe) as numpy. ms is the median of `iters` timed runs
    after a warmup call, same protocol as run_stream's sparse chain."""
    dev = resolve_device(device)
    if kind == "moe":
        x = to_device(step.operands[0].x, dev)
        experts = to_device(step.meta["experts"], dev)
        gates = to_device(step.meta["gates"], dev)
        args = (x, experts, gates)
        fn = functools.partial(_onehot_dispatch_combine,
                               num_experts=step.meta["num_experts"],
                               cap=step.meta["cap"])
    else:
        fn, args = _plain_product(step.operands[0].mat,
                                  to_device(step.operands[0].x, dev), dev)
    out = fn(*args)
    block_until_ready(out[-1] if isinstance(out, tuple) else out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        o = fn(*args)
        block_until_ready(o[-1] if isinstance(o, tuple) else o)
        times.append((time.perf_counter() - t0) * 1e3)
    rec = {"ms": float(np.median(times))}
    if kind == "moe":
        rec["buf"], rec["y"] = (t.cpu().numpy() for t in out)
    else:
        rec["y"] = out.cpu().numpy()
    return rec
