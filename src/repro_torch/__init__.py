"""repro_torch — the SpMV reordering study on PyTorch and CUDA.

The same Problem → Plan → Operator pipeline as the JAX package `repro`,
which stays the reference:

    from repro_torch import SpmvProblem, plan
    from repro_torch.matrices import suite

    mat = suite.get("fig1_shuffled")
    pl = plan(SpmvProblem(mat), reorder="rcm")   # scheme x engine x shape
    op = pl.build()                               # on the card (device=None)
    y = op(x)                                     # x in the ORIGINAL space

Every entry point takes `device=None`, meaning "cuda", and raises when no
card is present unless the caller passes `device="cpu"`. The sell, bcsr
and bell engines run hand-written CUDA kernels (repro_torch/csrc,
repro_torch/kernels) on CUDA tensors and their plain torch versions on
CPU tensors. This package imports neither jax nor `repro`.
"""
from .core.spmv.plan import Operator, Plan, SpmvProblem, plan  # noqa: F401

__all__ = ["SpmvProblem", "plan", "Plan", "Operator"]
