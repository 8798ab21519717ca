"""Conjugate Gradient — the paper's "real application" yardstick (Listing 3).

Four forms:
  * cg_solve       — standard CG as a torch loop.
  * block_cg_solve — k right-hand sides at once; one SpMM (operator.matmul)
                     per iteration instead of k SpMVs.
  * cg_measured    — open-coded iteration that times the SpMV separately
                     from the vector updates, like the paper's instrumented
                     Listing 3 (per-iteration SpMV time; CUDA events on the
                     card, see ios.time_call).
  * solve_problem  — plan, build and solve through the pipeline facade, in
                     the original index space.

The loops read the residual norm on the host every iteration to decide
whether to stop (one device sync per iteration), where the JAX package
runs `lax.while_loop` on the device. The corpus generators make matrices
strictly diagonally dominant (diagonal = m), hence SPD, so CG converges.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .ios import time_call


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor


def cg_solve(matvec: Callable, b: torch.Tensor, max_iter: int = 100,
             tol: float = 1e-8) -> CGResult:
    """Standard CG from x0 = 0; stops at max_iter or ||r|| <= tol."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    rs = torch.dot(r, r)
    k = 0
    while k < max_iter and float(rs) > tol * tol:
        ap = matvec(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    return CGResult(x=x, iters=k, residual=torch.sqrt(rs))


def block_cg_solve(matmul: Callable, b: torch.Tensor, max_iter: int = 100,
                   tol: float = 1e-8) -> CGResult:
    """Batched CG over k right-hand sides: solve A X = B, B of shape [n, k].

    Per-column α/β ('diagonal' block CG), one SpMM `A @ P[n, k]` per
    iteration. Converged columns freeze (α = β = 0), so the loop runs until
    the slowest column meets tol or max_iter.
    """
    x = torch.zeros_like(b)
    r = b - matmul(x)
    p = r
    rs = (r * r).sum(0)                            # [k] per-column ||r||^2
    k = 0
    while k < max_iter and bool((rs > tol * tol).any()):
        ap = matmul(p)                             # one SpMM for all k RHS
        pap = (p * ap).sum(0)
        live = rs > tol * tol
        zero = torch.zeros_like(rs)
        alpha = torch.where(live, rs / torch.where(pap == 0, 1.0, pap), zero)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rs_new = (r * r).sum(0)
        beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), zero)
        p = torch.where(live[None, :], r + beta[None, :] * p, p)
        rs = torch.where(live, rs_new, rs)
        k += 1
    return CGResult(x=x, iters=k, residual=torch.sqrt(rs))


def solve_problem(problem, b: torch.Tensor, reorder: str = "auto",
                  engine: str = "auto", max_iter: int = 100,
                  tol: float = 1e-8, probe: bool = False,
                  cache: bool = True, topology=None, partition="auto",
                  device=None):
    """Plan, build, and CG-solve A x = b through the pipeline facade.

    `problem` is an SpmvProblem or a bare CSRMatrix. b of shape [n] runs
    cg_solve; [n, k] runs block_cg_solve (one SpMM per iteration). Both b
    and the returned solution live in the ORIGINAL index space — the
    reordering the planner picks (e.g. reorder="auto" choosing rcm for
    locality) happens inside the permutation-carrying operator, so there
    is no hand-carried permutation between caller and solver.

    topology/partition (core/spmv/topology.py) run the same solve on a
    sharded plan: every per-iteration SpMV is the ShardedOperator's
    collective step, b and x still in the original index space.

    The operator is built on `device` (None: the card, which raises
    without one; "cpu" on request) and b is moved there in the operator's
    dtype. Returns (CGResult, Operator); the operator's `.plan` records
    what the pipeline decided (scheme, engine, partition, costs).
    """
    from ...device import resolve_device, torch_dtype
    from ..spmv.plan import SpmvProblem, plan as make_plan

    dev = resolve_device(device)
    b = torch.as_tensor(b)
    k = int(b.shape[1]) if b.ndim == 2 else 1
    if not isinstance(problem, SpmvProblem):
        problem = SpmvProblem(problem, k=k)
    pl = make_plan(problem, reorder=reorder, engine=engine, probe=probe,
                   cache=cache, topology=topology, partition=partition,
                   device=dev)
    op = pl.build(device=dev, cache=cache)
    b = b.to(dev, torch_dtype(problem.dtype))
    if k > 1:
        res = block_cg_solve(op.matmul, b, max_iter=max_iter, tol=tol)
    else:
        res = cg_solve(op, b, max_iter=max_iter, tol=tol)
    return res, op


def cg_measured(matvec: Callable, b: torch.Tensor, iters: int = 20,
                warmup: int = 2) -> np.ndarray:
    """Instrumented CG (paper Listing 3): per-iteration SpMV ms.

    The vector updates (dot, axpy) run between timed SpMVs and perturb the
    cache state as in the real application — the behaviour IOS
    approximates and YAX misses.
    """
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.dot(r, r)
    times = []
    for i in range(iters + warmup):
        dt, ap = time_call(matvec, p)
        if i >= warmup:
            times.append(dt)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return np.asarray(times)
