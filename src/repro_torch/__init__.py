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
CPU tensors. `plan(..., topology=Topology(devices=8), partition="auto")`
plans for a device mesh and builds a ShardedOperator. The package exports
what `repro_torch.api` does; it imports neither jax nor `repro`.
"""
from .api import *  # noqa: F401,F403
from .api import __all__  # noqa: F401
