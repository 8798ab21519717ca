"""Hand-written CUDA kernels for the SpMV engines (sm_90a), one package each.

  sell_spmv  — K1, SELL-C-σ SpMV            (SellOperator.__call__)
  sell_spmm  — K2, k-tiled SELL-C-σ SpMM    (SellOperator.matmul)
  bcsr_spmv  — K3, BCSR SpMV/SpMM           (BcsrOperator)
  bell_spmv  — K4, Block-ELL SpMV/SpMM      (BellOperator)

The sources are `repro_torch/csrc/*.cu`, compiled with nvcc at first use
(_build.py). Each kernel module holds the wrapper that launches the kernel
on CUDA tensors, and the plain torch version that the wrapper uses for CPU
tensors and that the tests and chip_smoke.py hold the kernel against.

LAUNCHES counts, per kernel, the launches its wrapper made: a plain
integer, bumped only where the kernel is launched, so a run can show which
kernels it went through. `reset_launches()` sets every count to 0.
"""
from __future__ import annotations

LAUNCHES = {"sell_spmv": 0, "sell_spmm": 0, "bcsr_spmv": 0, "bell_spmv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
