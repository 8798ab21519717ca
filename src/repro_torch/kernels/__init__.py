"""Hand-written CUDA kernels (sm_90a), one package each.

  sell_spmv  — K1, SELL-C-σ SpMV            (SellOperator.__call__)
  sell_spmm  — K2, k-tiled SELL-C-σ SpMM    (SellOperator.matmul)
  bcsr_spmv  — K3, BCSR SpMV/SpMM           (BcsrOperator)
  bell_spmv  — K4, Block-ELL SpMV/SpMM      (BellOperator)
  ssd_chunk  — K5, the fused Mamba2 SSD over a sequence, one launch per
               layer (ssd_scan, the Zamba2 prefill)

The sources are `repro_torch/csrc/*.cu`, compiled with nvcc at first use
(_build.py). Each kernel module holds the wrapper that launches the kernel
on CUDA tensors, and the plain torch version that the wrapper uses for CPU
tensors and that the tests and chip_smoke.py hold the kernel against.

LAUNCHES counts, per kernel, the launches its wrapper made: a plain
integer, bumped only where the kernel is launched, so a run can show which
kernels it went through. `reset_launches()` sets every count to 0;
`launches_since(before)` gives the launches since a copy of LAUNCHES.
"""
from __future__ import annotations

LAUNCHES = {"sell_spmv": 0, "sell_spmm": 0, "bcsr_spmv": 0, "bell_spmv": 0,
            "ssd_chunk": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches_since(before: dict) -> dict:
    """Launches per kernel since `before`, a copy of LAUNCHES."""
    return {name: n - before[name] for name, n in LAUNCHES.items()}
