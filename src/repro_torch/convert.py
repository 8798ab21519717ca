"""Carry operator state, plan decisions and model parameters across from
the JAX package.

Both packages' operators speak the same state protocol: `state()` returns
(meta, arrays) with numpy arrays, under the same array and meta names
(`chunk_vals`, `chunk_cols`, `chunk_slice`, `inv_perm`, `n_pad`, ...). So
what the reference's `state()` returns, handed here as plain numpy and
dicts, gives the port's operator computing the same thing, and a
reference `Plan.to_json()` plus its permutation gives the port's Plan
holding the same decision (a sharded plan's topology, partitioner, panel
starts and comm model included); a reference model's parameter pytree, as
nested dicts of numpy arrays, gives the port's parameters, and a reference
train state the port's. Nothing here imports the reference package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .core.sparse.csr import CSRMatrix
from .core.spmv.plan import Plan


def _operator_classes() -> dict:
    from .core.spmv.distributed import ShardedOperator
    from .core.spmv.ops import DeviceCSR, DeviceDense, DeviceELL
    from .kernels.bcsr_spmv.ops import BcsrOperator
    from .kernels.bell_spmv.ops import BellOperator
    from .kernels.sell_spmv.ops import SellOperator

    return {c.__name__: c for c in (DeviceCSR, DeviceELL, DeviceDense,
                                    SellOperator, BcsrOperator,
                                    BellOperator, ShardedOperator)}


def operator_from_reference(cls_name: str, meta: dict, arrays: dict,
                            device=None, dtype=None, perm=None):
    """The port's operator for a reference operator's `state()`.

    cls_name is the reference class name (`type(op).__name__`); the value
    dtype is the stored arrays' unless `dtype` is given; `device=None` is
    the card. The reference's kernel choice ("pallas", "interpret", or
    "ref", which is what "auto" resolves to off a TPU) is an execution
    setting of its own backend and becomes "auto" here. A ShardedOperator
    also takes the plan's `perm` (its state holds the layout, not the
    permutation), as the reference's `from_state` does.
    """
    classes = _operator_classes()
    if cls_name not in classes:
        raise KeyError(f"no port of operator class {cls_name!r}; known: "
                       f"{sorted(classes)}")
    meta = dict(meta, use_kernel="auto") if "use_kernel" in meta else meta
    if cls_name == "ShardedOperator":
        return classes[cls_name].from_state(
            meta, arrays, dtype=dtype, device=device,
            perm=None if perm is None else np.asarray(perm, np.int64))
    if perm is not None:
        raise ValueError(f"{cls_name} carries no permutation; perm= is for "
                         f"a ShardedOperator")
    return classes[cls_name].from_state(meta, arrays, dtype=dtype,
                                        device=device)


def plan_from_reference(plan_json: dict, perm: Optional[np.ndarray],
                        mat: Optional[CSRMatrix] = None,
                        panel_starts: Optional[np.ndarray] = None) -> Plan:
    """The port's Plan for a reference `Plan.to_json()` and its `perm`
    (None = identity). Attach `mat` (the problem matrix in the original
    index space) to build it. A sharded plan (its json names a topology)
    also needs the reference plan's `panel_starts`, which its json does
    not hold; its topology, partitioner, comm model and partition costs
    come from the json."""
    if plan_json.get("topology") is not None and panel_starts is None:
        raise ValueError("a sharded plan needs its panel_starts (the "
                         "reference Plan's array, kept beside its json)")
    d = dict(plan_json)
    if d.get("use_kernel") not in ("auto", "cuda", "ref"):
        d["use_kernel"] = "auto"
    return Plan.from_json(
        d, perm=None if perm is None else np.asarray(perm, np.int64),
        mat=mat, panel_starts=None if panel_starts is None
        else np.asarray(panel_starts, np.int64))


def params_from_reference(tree: dict, cfg, device=None, dtype=None) -> dict:
    """The port's model parameters for a reference parameter pytree, given
    as nested dicts of numpy arrays (`jax.device_get(params)`).

    The layout is the same in both packages (`w [d_in, d_out]`, layers
    stacked on a leading axis), so every leaf is a plain copy: the stacked
    axes are kept, and the port indexes them as the reference's scan does.
    Floating leaves take `dtype` when given, else their own type (bf16
    included); `device=None` is the card. The stacked layer counts must
    match `cfg`, else ValueError: dense, audio and moe `layers` [n_layers,
    ...] (moe's expert weights [n_layers, E, ...]), gemma2
    `layers.{local,global}` [n_layers // 2, ...], Zamba2 `layers` [groups *
    period, ...] and `tail_layers` [rem, ...], rwkv6 `layers` [n_layers,
    ...], the vlm `layers` [groups * (period - 1), ...] and `cross_layers`
    [groups, ...]; a config without tied embeddings needs its `head`.
    """
    import torch

    from .device import resolve_device
    from .models.model import _family

    family = _family(cfg)
    dev = resolve_device(device)
    for name, got, want in _stack_counts(tree, cfg, family):
        if got != want:
            raise ValueError(f"params_from_reference: {name} holds {got}, "
                             f"{cfg.name} needs {want}")

    def leaf(a):
        arr = np.asarray(a)
        want = dtype
        if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy cast to torch
            arr, want = arr.astype(np.float32), dtype or torch.bfloat16
        t = torch.from_numpy(np.array(arr, order="C"))
        if want is not None and t.is_floating_point():
            t = t.to(want)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def state_from_reference(state: dict, cfg, device=None) -> dict:
    """The port's train state for a reference train state {"params", "opt":
    {"step", "mu", "nu"}}, given as nested dicts of numpy arrays
    (`jax.device_get(state)`). params, mu and nu go through
    params_from_reference, with its stack checks (ValueError), keeping
    their types; step stays an int32 scalar. `device=None` is the card."""
    import torch

    from .device import resolve_device

    opt = state["opt"]
    step = np.asarray(opt["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"state_from_reference: opt.step must be an int32 "
                         f"scalar, got {step.dtype} {step.shape}")
    return {
        "params": params_from_reference(state["params"], cfg, device),
        "opt": {"step": torch.from_numpy(step.copy()).to(
                    resolve_device(device)),
                "mu": params_from_reference(opt["mu"], cfg, device),
                "nu": params_from_reference(opt["nu"], cfg, device)},
    }


def _stack_counts(tree: dict, cfg, family: str):
    """(what, its leading shape in `tree`, the shape `cfg` needs) for each
    stacked part of a reference parameter tree."""
    def lead(node, *path, axes=1):
        for key in path:
            node = node[key]
        return tuple(np.shape(node)[:axes])

    n = cfg.n_layers
    out = []
    if not cfg.tie_embeddings:
        out.append(("head", lead(tree, "head", "w", axes=2) if "head" in tree
                    else (), (cfg.d_model, cfg.padded_vocab)))
    if family == "rwkv6":
        return out + [("layers", lead(tree, "layers", "wr", "w"), (n,))]
    if family == "vlm":
        groups = n // cfg.cross_attn_period
        return out + [
            ("layers", lead(tree, "layers", "attn", "wq", "w"),
             (groups * (cfg.cross_attn_period - 1),)),
            ("cross_layers", lead(tree, "cross_layers", "gate"), (groups,))]
    if family == "hybrid":
        groups, rem = divmod(n, cfg.hybrid_attn_period)
        tail = (lead(tree, "tail_layers", "in_proj", "w")
                if "tail_layers" in tree else (0,))
        return out + [("layers", lead(tree, "layers", "in_proj", "w"),
                       (groups * cfg.hybrid_attn_period,)),
                      ("tail_layers", tail, (rem,))]
    if family == "gemma2":
        return out + [(f"layers.{part}",
                       lead(tree, "layers", part, "attn", "wq", "w"),
                       (n // 2,)) for part in ("local", "global")]
    out.append(("layers", lead(tree, "layers", "attn", "wq", "w"), (n,)))
    if family == "moe":
        e = cfg.moe.num_experts
        out += [(f"layers.moe.{w}", lead(tree, "layers", "moe", w, axes=2),
                 (n, e)) for w in ("w_gate", "w_up", "w_down")]
        out.append(("layers.moe.router", lead(tree, "layers", "moe",
                                              "router", "w", axes=3),
                    (n, cfg.d_model, e)))
    return out
