"""Persistent tuned-operator cache (the port's own).

Repeated benchmark runs over the same (matrix, scheme) grid pay the host
format conversion and autotuning every time; this cache makes the second
run free. Entries are content-addressed as in the JAX package — a sha1
over the CSR structure AND values (operators embed values) plus the build
request — so a reordered matrix, another dtype or another engine request
each get their own entry, and a stale hit is impossible. `content_key`
hashes the same bytes as the reference's and gives the same hex string.

Layout (one entry = two files under $REPRO_TORCH_OPERATOR_CACHE, default
`repro_torch_opcache` under the system temp directory):
    <key>.npz    the operator's state() arrays (a bf16 array as its raw
                 uint16 bits: numpy has no bf16)
    <key>.json   {"backend": "torch", "cls", "meta", "dtypes", "plan"}

The JAX package's cache lives under its own variable and directory, and
an entry without the "torch" backend tag is never read here. Entries hold
host arrays only: a reload builds the operator on the device its caller
asks for (None = the card).

`build_cached` returns (operator, info), where info separates plan time
(tune_ms, build_ms, load_ms, cache_hit) from the run time the measurement
goes on to observe. REPRO_TORCH_OPERATOR_CACHE=off (or cache=False)
disables the cache.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ... import obs
from ...device import resolve_device, torch_dtype
from ..sparse.csr import CSRMatrix
from .tune import TunePlan, tune

OFF = ("off", "0", "none", "")
BACKEND = "torch"


def _cache_dir() -> str:
    return os.environ.get(
        "REPRO_TORCH_OPERATOR_CACHE",
        os.path.join(tempfile.gettempdir(), "repro_torch_opcache"))


def cache_enabled() -> bool:
    return _cache_dir().lower() not in OFF


def operator_registry() -> dict:
    """Operator classes that speak the state()/from_state() protocol."""
    from ...kernels.bcsr_spmv.ops import BcsrOperator
    from ...kernels.bell_spmv.ops import BellOperator
    from ...kernels.sell_spmv.ops import SellOperator
    from .ops import DeviceCSR, DeviceDense, DeviceELL

    return {c.__name__: c for c in
            (DeviceCSR, DeviceELL, DeviceDense, SellOperator, BellOperator,
             BcsrOperator)}


def operator_nbytes(op) -> int:
    """Device-tensor footprint of an operator, in bytes.

    Walks the torch.Tensor leaves reachable from the operator through the
    port's own objects and plain containers (lists, tuples, dicts), each
    tensor counted once. Host numpy mirrors (a Plan's stored perm) are not
    counted: a memory budget bounds what lives on the device.
    """
    seen: set = set()
    total = 0
    stack = [op]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif type(o).__module__.startswith("repro_torch.") \
                and hasattr(o, "__dict__"):
            stack.extend(vars(o).values())
    return total


def operator_nbytes_per_device(op) -> list:
    """Per-device footprint, in bytes: a list of topology.devices entries
    (a non-sharded operator is the single-device list
    `[operator_nbytes(op)]`).

    `operator_nbytes` counts a ShardedOperator as ONE blob, so a
    service-global budget can be met while one device is over — the
    per-device budget of a multi-shard router needs the split. As in the
    JAX package, each device is charged its slice of the engine arrays
    (the leading mesh axes of layout.arrays, floats priced at the plan's
    compute dtype) PLUS the replicated gather/scatter index maps, which
    every device holds a copy of (int32, as in the JAX package). The
    engine arrays are priced from the host layout."""
    lay = getattr(op, "layout", None)
    if lay is None:
        return [operator_nbytes(op)]
    topo = lay.topology
    ndev = int(topo.devices)
    dtype_name = getattr(getattr(op, "plan", None), "dtype_name", None)
    value_size = (torch.empty((), dtype=torch_dtype(dtype_name))
                  .element_size() if dtype_name else None)
    per = np.zeros(ndev, dtype=np.int64)
    for a in lay.arrays.values():
        a = np.asarray(a)
        flat = a.reshape((ndev,) + a.shape[2 if topo.col_devices > 1
                                           else 1:])
        itemsize = (value_size if value_size is not None
                    and np.issubdtype(a.dtype, np.floating)
                    else a.dtype.itemsize)
        per += np.asarray([flat[i].size * itemsize for i in range(ndev)],
                          dtype=np.int64)
    replicated = 0
    for name in ("_in_idx", "_in_idx_r", "_out_idx", "_out_idx_r"):
        t = getattr(op, name, None)
        if t is not None:
            replicated += t.numel() * t.element_size()
    per += replicated
    return [int(b) for b in per]


def content_key(mat: CSRMatrix, engine: str, dtype_name: str,
                block_shape=(8, 128), sell_sigma=None, probe=False,
                k: int = 1) -> str:
    """sha1 over matrix content + build request, the reference's bytes.

    k (the batch width the tuner planned for) is part of the request for
    engine="auto"; a fixed engine's stored format does not depend on k, so
    k is normalized out of its key.
    """
    if engine != "auto":
        k = 1
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mat.rowptr).tobytes())
    h.update(np.ascontiguousarray(mat.cols).tobytes())
    h.update(np.ascontiguousarray(mat.vals).tobytes())
    h.update(f"{tuple(mat.shape)}:{engine}:{dtype_name}:"
             f"{tuple(block_shape)}:{sell_sigma}:{probe}:{int(k)}".encode())
    return h.hexdigest()[:20]


def array_dtypes(arrays: dict, value_dtype: str) -> dict:
    """The dtype name of each state array as the operator holds it: a
    uint16 host array of a bf16 operator is bf16 bits."""
    return {k: (value_dtype if v.dtype == np.uint16 else v.dtype.name)
            for k, v in arrays.items()}


def check_dtypes(arrays: dict, dtypes: dict) -> None:
    """Raise unless every stored array has the type its record names (a
    bf16 array as uint16 bits); the caller reads a mismatch as a miss."""
    for k, v in arrays.items():
        want = dtypes.get(k)
        host = "uint16" if want == "bfloat16" else want
        if v.dtype.name != host:
            raise ValueError(f"stored array {k!r} is {v.dtype}, the record "
                             f"names {want}")


def write_entry(base: str, rec: dict, arrays: dict) -> None:
    """tmp+rename, the .npz first and the .json LAST (it gates the read);
    tmp names carry pid AND thread id, so concurrent writers never share a
    tmp file."""
    tag = f"{os.getpid()}.{threading.get_ident()}"
    ztmp = f"{base}.{tag}.npz.tmp"
    with open(ztmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(ztmp, base + ".npz")
    jtmp = f"{base}.{tag}.json.tmp"
    with open(jtmp, "w") as f:
        json.dump(rec, f)
    os.replace(jtmp, base + ".json")


def _store(key: str, op, plan: TunePlan | None, dtype_name: str) -> None:
    d = _cache_dir()
    os.makedirs(d, exist_ok=True)
    meta, arrays = op.state()
    rec = {"backend": BACKEND, "cls": type(op).__name__, "meta": meta,
           "dtypes": array_dtypes(arrays, dtype_name),
           "plan": plan.to_json() if plan is not None else None}
    write_entry(os.path.join(d, key), rec, arrays)


def _load(key: str, dtype, device):
    d = _cache_dir()
    jpath = os.path.join(d, key + ".json")
    zpath = os.path.join(d, key + ".npz")
    if not (os.path.exists(jpath) and os.path.exists(zpath)):
        return None, None
    try:
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("backend") != BACKEND:
            return None, None
        z = np.load(zpath)
        arrays = {k: z[k] for k in z.files}
        check_dtypes(arrays, rec["dtypes"])
        cls = operator_registry().get(rec["cls"])
        if cls is None:
            return None, None
        op = cls.from_state(rec["meta"], arrays, dtype=dtype, device=device)
        plan = TunePlan.from_json(rec["plan"]) if rec.get("plan") else None
    except Exception:
        # corrupt, truncated or schema-incompatible entry (the cache
        # persists across code versions): a miss, and the caller rebuilds
        return None, None
    if plan is not None:
        op.plan = plan
    return op, plan


def build_cached(mat: CSRMatrix, engine: str = "auto", dtype=None,
                 block_shape=(8, 128), sell_sigma=None, probe: bool = False,
                 use_kernel: str = "auto", cache: bool = True, k: int = 1,
                 device=None):
    """Build (or reload) an operator on `device` (None = the card).
    Returns (op, info).

    info: {"cache_hit", "key", "tune_ms", "build_ms", "load_ms",
           "engine", "plan"} — plan-time accounting for the benchmarks.
    """
    from .ops import make_engine
    from .tune import build_from_plan

    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    dtype_name = str(dt).replace("torch.", "")
    use_cache = cache and cache_enabled()
    key = content_key(mat, engine, dtype_name, block_shape, sell_sigma,
                      probe, k=k) if use_cache else None
    info = {"cache_hit": False, "key": key, "tune_ms": 0.0, "build_ms": 0.0,
            "load_ms": 0.0, "engine": engine, "plan": None}

    if use_cache:
        t0 = time.perf_counter()
        op, plan = _load(key, dt, dev)
        if op is not None:
            if getattr(op, "use_kernel", None) is not None:
                op.use_kernel = use_kernel
            info.update(cache_hit=True,
                        load_ms=(time.perf_counter() - t0) * 1e3,
                        engine=plan.engine if plan else engine,
                        plan=plan.to_json() if plan else None)
            obs.counter("opcache.hits").inc()
            return op, info
        obs.counter("opcache.misses").inc()

    plan = None
    t0 = time.perf_counter()
    if engine == "auto":
        plan = tune(mat, probe=probe, dtype=dt, use_kernel=use_kernel, k=k,
                    device=dev)
        info["tune_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        op = build_from_plan(mat, plan, dtype=dt, use_kernel=use_kernel,
                             device=dev)
    else:
        op = make_engine(mat, engine, dtype=dt, block_shape=block_shape,
                         use_kernel=use_kernel, sell_sigma=sell_sigma,
                         device=dev)
    info["build_ms"] = (time.perf_counter() - t0) * 1e3
    info["engine"] = plan.engine if plan else engine
    info["plan"] = plan.to_json() if plan else None
    if use_cache:
        _store(key, op, plan, dtype_name)
        obs.counter("opcache.writes").inc()
    return op, info
