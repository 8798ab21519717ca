"""Measurement methodology (paper §3.1): YAX vs IOS harnesses.

YAX (paper Listing 1): time `y = A @ x` repeatedly with the SAME x — the
common-but-misleading protocol (unnaturally warm caches for x).

IOS (paper Listing 2): swap input and output between iterations
(`x, y = y, x`) so the input vector moves like it does inside a real
application (CG writes its direction vector every iteration).

Both return per-iteration milliseconds. On the card each iteration is
bracketed by CUDA events recorded on the current stream and read after the
end event has synchronized (device time of the whole operator call). A CPU
tensor, which a caller gets only by asking for device="cpu", is timed with
the host clock. Symmetric square matrices make the swap well-typed.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ...device import resolve_device, torch_dtype


def time_call(fn: Callable, x: torch.Tensor) -> tuple[float, torch.Tensor]:
    """(milliseconds, fn(x)): CUDA events for CUDA tensors, the host clock
    (after the call returns) for CPU tensors."""
    if not x.is_cuda:
        t0 = time.perf_counter()
        out = fn(x)
        return (time.perf_counter() - t0) * 1e3, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_yax(op: Callable, x0: torch.Tensor, iters: int = 20,
            warmup: int = 3) -> np.ndarray:
    """Paper Listing 1. Returns ms[iters]."""
    for _ in range(warmup):
        _sync(op(x0))
    times = np.empty(iters)
    for i in range(iters):
        times[i], _ = time_call(op, x0)   # x unchanged — the YAX flaw
    return times


def run_ios(op: Callable, x0: torch.Tensor, iters: int = 20,
            warmup: int = 3) -> np.ndarray:
    """Paper Listing 2. Returns ms[iters]."""
    x = x0
    for _ in range(warmup):
        x = op(x)
    _sync(x)
    times = np.empty(iters)
    for i in range(iters):
        times[i], x = time_call(op, x)    # output becomes input
    return times


def run_ios_batched(op, n: int, k: int, iters: int = 20, warmup: int = 3,
                    dtype=None, seed: int = 0, device=None) -> np.ndarray:
    """IOS-time the k-RHS path of an operator on `device` (None = the
    card). k == 1 times the SpMV `__call__`, k > 1 times `op.matmul` on an
    [n, k] block. Returns ms[iters]."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    rng = np.random.default_rng(seed)
    if k <= 1:
        x0 = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
        return run_ios(op, x0, iters=iters, warmup=warmup)
    x0 = torch.as_tensor(rng.standard_normal((n, k))).to(dev, dt)
    return run_ios(op.matmul, x0, iters=iters, warmup=warmup)


def gflops(nnz: int, ms: np.ndarray) -> np.ndarray:
    """2 flops per nonzero (mul + add), paper's convention."""
    return 2.0 * nnz / (ms * 1e-3) / 1e9
