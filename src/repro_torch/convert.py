"""Carry operator state and plan decisions across from the JAX package.

Both packages' operators speak the same state protocol: `state()` returns
(meta, arrays) with numpy arrays, under the same array and meta names
(`chunk_vals`, `chunk_cols`, `chunk_slice`, `inv_perm`, `n_pad`, ...). So
what the reference's `state()` returns, handed here as plain numpy and
dicts, gives the port's operator computing the same thing, and a
reference `Plan.to_json()` plus its permutation gives the port's Plan
holding the same decision. Nothing here imports the reference package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .core.sparse.csr import CSRMatrix
from .core.spmv.plan import Plan


def _operator_classes() -> dict:
    from .core.spmv.ops import DeviceCSR, DeviceDense, DeviceELL
    from .kernels.bcsr_spmv.ops import BcsrOperator
    from .kernels.bell_spmv.ops import BellOperator
    from .kernels.sell_spmv.ops import SellOperator

    return {c.__name__: c for c in (DeviceCSR, DeviceELL, DeviceDense,
                                    SellOperator, BcsrOperator,
                                    BellOperator)}


def operator_from_reference(cls_name: str, meta: dict, arrays: dict,
                            device=None, dtype=None):
    """The port's operator for a reference operator's `state()`.

    cls_name is the reference class name (`type(op).__name__`); the value
    dtype is the stored arrays' unless `dtype` is given; `device=None` is
    the card. The reference's kernel choice ("pallas", "interpret", or
    "ref", which is what "auto" resolves to off a TPU) is an execution
    setting of its own backend and becomes "auto" here.
    """
    classes = _operator_classes()
    if cls_name not in classes:
        raise KeyError(f"no port of operator class {cls_name!r}; known: "
                       f"{sorted(classes)}")
    meta = dict(meta, use_kernel="auto") if "use_kernel" in meta else meta
    return classes[cls_name].from_state(meta, arrays, dtype=dtype,
                                        device=device)


def plan_from_reference(plan_json: dict, perm: Optional[np.ndarray],
                        mat: Optional[CSRMatrix] = None) -> Plan:
    """The port's Plan for a reference `Plan.to_json()` and its `perm`
    (None = identity). Attach `mat` (the problem matrix in the original
    index space) to build it. Sharded plans are not ported and raise."""
    if plan_json.get("topology") is not None:
        raise NotImplementedError("topology-aware (sharded) plans are not "
                                  "ported yet")
    d = dict(plan_json)
    if d.get("use_kernel") not in ("auto", "cuda", "ref"):
        d["use_kernel"] = "auto"
    return Plan.from_json(d, perm=None if perm is None
                          else np.asarray(perm, np.int64), mat=mat)
