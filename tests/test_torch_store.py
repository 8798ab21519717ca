"""The port's plan store and operator cache (core/spmv/plan.py, opcache.py)
on the CPU, against the JAX package's where they must agree:

- structure_key, values_key, the matrix key and opcache.content_key hash
  the reference's bytes (the same hex strings); plan_key is stable, moves
  with every part of the request, and never equals the reference's;
- save / load / rebuild round-trip a plan and its operator in float32,
  float64 and bf16 bit for bit (bf16 as raw uint16 bits), with zero
  re-tune and a cache hit reported;
- a corrupt or truncated entry reads as a miss and is rebuilt; "off"
  disables the store; writes are tmp+rename with the .json last;
- the port's store and the reference's never read each other's entries.

Every test points the port's variables (and, where it uses it, the
reference's) at its own temporary directory.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spmv import opcache as ref_opcache
from repro.core.spmv import plan as rplan
from repro.matrices import generators as RG
from repro_torch import obs
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv import opcache
from repro_torch.core.spmv import plan as tplan
from repro_torch.device import host_array, to_device

torch.set_num_threads(1)

CPU = torch.device("cpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_PLAN_CACHE", "ref_plans"),
                     ("REPRO_OPERATOR_CACHE", "ref_opcache"),
                     ("REPRO_REORDER_CACHE", "ref_reorder")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    return tmp_path


def _pair(kind="power_law"):
    rm = (RG.power_law(300, alpha=1.9, seed=3) if kind == "power_law"
          else RG.shuffle(RG.banded(256, 4, seed=1), seed=2))
    return rm, CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                         shape=rm.shape)


def _tensors(op) -> dict:
    return {k: v for k, v in vars(op).items() if isinstance(v, torch.Tensor)}


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].view(-1).view(torch.uint8)
                           if a[k].dtype == torch.bfloat16 else a[k],
                           b[k].view(-1).view(torch.uint8)
                           if b[k].dtype == torch.bfloat16 else b[k]), k


# -- keys --------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["power_law", "banded"])
def test_keys_hash_the_references_bytes(kind):
    rm, pm = _pair(kind)
    assert tplan.structure_key(pm) == rplan.structure_key(rm)
    assert tplan.values_key(pm) == rplan.values_key(rm)
    assert tplan._mat_key(pm) == rplan._mat_key(rm)
    for engine, dtype_name, k in (("auto", "float32", 8), ("sell", "bfloat16",
                                                           1)):
        assert opcache.content_key(pm, engine, dtype_name, k=k) == \
            ref_opcache.content_key(rm, engine, dtype_name, k=k)


def test_structure_and_values_keys_split_the_content():
    _, pm = _pair()
    other = CSRMatrix(rowptr=pm.rowptr, cols=pm.cols, vals=pm.vals * 2.0,
                      shape=pm.shape)
    assert tplan.structure_key(other) == tplan.structure_key(pm)
    assert tplan.values_key(other) != tplan.values_key(pm)


def test_plan_key_is_stable_and_moves_with_the_request():
    rm, pm = _pair()
    key = lambda m=pm, **kw: tplan.plan_key(  # noqa: E731
        tplan.SpmvProblem(m, k=kw.pop("k", 1), dtype=kw.pop("dtype", None)),
        kw.pop("reorder", "rcm"), kw.pop("engine", "auto"), False, 0)
    assert key() == key()
    variants = {key(), key(k=8), key(dtype="bfloat16"), key(reorder="baseline"),
                key(engine="sell")}
    assert len(variants) == 5
    want = rplan.plan_key(rplan.SpmvProblem(rm), "rcm", "auto", False, 0)
    assert key() != want                 # the "torch" token


# -- round trips -------------------------------------------------------------
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("engine", ["auto", "sell", "bell", "bcsr", "ell",
                                    "csr"])
def test_save_load_rebuild_round_trip_bit_for_bit(dtype_name, engine):
    _, pm = _pair()
    dt = DTYPES[dtype_name]
    problem = tplan.SpmvProblem(pm, k=1, dtype=dtype_name,
                                hints={"block_shape": (8, 16)})
    first = tplan.plan(problem, reorder="rcm", engine=engine)
    assert not first.cache_hit
    op = first.build(device=CPU)
    assert not op.build_info["cache_hit"] and op.build_info["build_ms"] > 0
    hit = tplan.plan(problem, reorder="rcm", engine=engine)
    assert hit.cache_hit and hit.tune_ms == hit.reorder_ms == 0.0
    np.testing.assert_array_equal(hit.perm, first.perm)
    assert hit.tune.to_json() == first.tune.to_json()
    again = hit.build(device=CPU)
    assert again.build_info["cache_hit"] and again.build_info["build_ms"] == 0
    _assert_bitwise(_tensors(again.inner), _tensors(op.inner))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(pm.n)).to(dt)
    assert torch.equal(again(x).view(torch.uint8) if dt == torch.bfloat16
                       else again(x),
                       op(x).view(torch.uint8) if dt == torch.bfloat16
                       else op(x))
    # rebuild: new values under the frozen decision, no store write
    vals = np.random.default_rng(2).uniform(-1, 1, pm.nnz)
    twin = CSRMatrix(rowptr=pm.rowptr, cols=pm.cols, vals=vals,
                     shape=pm.shape)
    writes = obs.REGISTRY.total("plan_store.writes")
    rebuilt = hit.rebuild(twin, device=CPU)
    assert obs.REGISTRY.total("plan_store.writes") == writes
    assert rebuilt.build_info["value_swap"] and \
        rebuilt.build_info["tune_ms"] == 0.0
    fresh = first.build(device=CPU, values=vals)
    _assert_bitwise(_tensors(rebuilt.inner), _tensors(fresh.inner))


def test_save_and_load_by_explicit_path(tmp_path):
    _, pm = _pair()
    pl = tplan.plan(tplan.SpmvProblem(pm, dtype="bfloat16"), reorder="rcm",
                    cache=False)
    op = pl.build(device=CPU, cache=False)
    path = pl.save(op=op.inner, path=str(tmp_path / "mine.json"))
    entry = json.loads(open(path).read())
    assert entry["backend"] == "torch"
    dtypes = entry["op"]["dtypes"]
    assert "bfloat16" in dtypes.values()
    loaded = tplan.Plan.load(path, mat=pm)
    assert loaded.cache_hit and loaded._op_state is not None
    restored = loaded._restore_operator(torch.bfloat16, CPU)
    _assert_bitwise(_tensors(restored), _tensors(op.inner))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_host_array_round_trips_every_value_type(dtype_name):
    dt = DTYPES[dtype_name]
    t = torch.as_tensor(np.random.default_rng(3).standard_normal(57)).to(dt)
    arr = host_array(t)
    assert arr.dtype == (np.uint16 if dt == torch.bfloat16 else
                         np.dtype(dtype_name))
    back = to_device(arr, dt, CPU)
    _assert_bitwise({"t": back}, {"t": t})


# -- robustness --------------------------------------------------------------
DAMAGE = ["npz_garbage", "npz_truncated", "json_garbage", "json_bad_schema",
          "npz_missing", "json_not_torch"]


def _damage(npz, js, damage):
    if damage == "npz_garbage":
        npz.write_bytes(b"not an npz at all")
    elif damage == "npz_truncated":
        npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])
    elif damage == "json_garbage":
        js.write_text("{this is not json")
    elif damage == "json_bad_schema":
        rec = json.loads(js.read_text())
        rec["op"] = {"cls": "NoSuchOperator", "meta": {}, "dtypes": {}}
        rec["plan"].pop("tune")
        js.write_text(json.dumps(rec))
    elif damage == "npz_missing":
        npz.unlink()
    elif damage == "json_not_torch":
        rec = json.loads(js.read_text())
        rec.pop("backend")
        js.write_text(json.dumps(rec))


@pytest.mark.parametrize("damage", DAMAGE)
def test_corrupt_plan_entry_rebuilds(stores, damage):
    rm, pm = _pair()
    problem = tplan.SpmvProblem(pm, dtype="bfloat16")
    pl = tplan.plan(problem, reorder="rcm")
    op = pl.build(device=CPU)
    npz = stores / "plans" / f"{pl.key}.npz"
    js = stores / "plans" / f"{pl.key}.json"
    assert npz.exists() and js.exists()
    _damage(npz, js, damage)
    again = tplan.plan(problem, reorder="rcm")
    assert not again.cache_hit, "a damaged entry must be a miss"
    op2 = again.build(device=CPU)
    _assert_bitwise(_tensors(op2.inner), _tensors(op.inner))
    # the rebuild repaired the entry
    third = tplan.plan(problem, reorder="rcm")
    assert third.cache_hit and third.build(device=CPU).build_info["cache_hit"]


@pytest.mark.parametrize("damage", DAMAGE[:5])
def test_corrupt_operator_cache_entry_rebuilds(stores, damage):
    _, pm = _pair()
    op, info = opcache.build_cached(pm, "auto", dtype=torch.bfloat16,
                                    device=CPU)
    assert not info["cache_hit"]
    d = stores / "opcache"
    npz, js = d / f"{info['key']}.npz", d / f"{info['key']}.json"
    if damage == "json_bad_schema":
        js.write_text(json.dumps({"backend": "torch", "cls": "NoSuch",
                                  "meta": {}, "dtypes": {}, "plan": None}))
    else:
        _damage(npz, js, damage)
    op2, info2 = opcache.build_cached(pm, "auto", dtype=torch.bfloat16,
                                      device=CPU)
    assert not info2["cache_hit"]
    _assert_bitwise(_tensors(op2), _tensors(op))
    op3, info3 = opcache.build_cached(pm, "auto", dtype=torch.bfloat16,
                                      device=CPU)
    assert info3["cache_hit"] and info3["tune_ms"] == 0.0
    assert op3.plan.to_json() == op2.plan.to_json()
    _assert_bitwise(_tensors(op3), _tensors(op))


def test_writes_are_tmp_then_rename_json_last(monkeypatch):
    events = []
    real = os.replace

    def spy(src, dst):
        events.append((os.path.basename(src), os.path.basename(dst)))
        return real(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    _, pm = _pair()
    pl = tplan.plan(tplan.SpmvProblem(pm), reorder="baseline")
    pl.build(device=CPU)
    mine = [e for e in events if e[1].startswith(pl.key)]
    assert [d for _, d in mine] == [f"{pl.key}.npz", f"{pl.key}.json"] * 2
    assert all(".tmp" in s for s, _ in mine)


@pytest.mark.parametrize("var", ["REPRO_TORCH_PLAN_CACHE",
                                 "REPRO_TORCH_OPERATOR_CACHE"])
def test_off_disables_the_store(stores, monkeypatch, var):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE")
    monkeypatch.setenv(var, "off")
    assert not tplan.store_enabled()
    _, pm = _pair()
    problem = tplan.SpmvProblem(pm)
    first = tplan.plan(problem, reorder="rcm")
    first.build(device=CPU)
    again = tplan.plan(problem, reorder="rcm")
    assert not again.cache_hit
    assert not (stores / "plans").exists()
    monkeypatch.setenv("REPRO_TORCH_OPERATOR_CACHE", "off")
    _, info = opcache.build_cached(pm, "csr", device=CPU)
    _, info = opcache.build_cached(pm, "csr", device=CPU)
    assert not info["cache_hit"] and info["key"] is None


def test_operator_cache_dir_keeps_a_plans_sibling(stores, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE")
    assert tplan._store_dir() == str(stores / "opcache" / "plans")


def test_the_two_stores_never_read_each_others_entries(stores,
                                                       monkeypatch):
    """Both packages pointed at ONE directory: each misses on what the
    other wrote (the port's keys carry a "torch" token, its records a
    "torch" backend tag, and the reference's records lack it)."""
    shared = str(stores / "shared")
    monkeypatch.setenv("REPRO_PLAN_CACHE", shared)
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", shared)
    rm, pm = _pair()
    ref_pl = rplan.plan(rplan.SpmvProblem(rm), reorder="rcm")
    ref_pl.build()
    assert not tplan.plan(tplan.SpmvProblem(pm), reorder="rcm").cache_hit
    assert tplan.Plan.load(os.path.join(shared, ref_pl.key + ".json"),
                           mat=pm) is None
    port_pl = tplan.plan(tplan.SpmvProblem(pm), reorder="rcm")
    assert port_pl.cache_hit               # the port's own entry
    assert rplan.Plan.load(os.path.join(shared, port_pl.key + ".json"),
                           mat=rm) is None
    assert rplan.plan(rplan.SpmvProblem(rm), reorder="rcm").cache_hit
    np.testing.assert_array_equal(port_pl.perm, ref_pl.perm)


def test_operator_nbytes_counts_device_tensors_once():
    _, pm = _pair()
    op = tplan.plan(tplan.SpmvProblem(pm), reorder="rcm",
                    engine="sell").build(device=CPU)
    inner = op.unwrap()
    want = sum(t.numel() * t.element_size()
               for t in _tensors(inner).values())
    assert opcache.operator_nbytes(inner) == want
    # the Operator adds its perm and iperm tensors, not the host perm
    assert opcache.operator_nbytes(op) == want + sum(
        t.numel() * t.element_size() for t in (op._perm, op._iperm))
    assert opcache.operator_nbytes(jnp.zeros(3)) == 0
