"""The port's pipeline (plan → build → Operator, CG, state transfer) against
the JAX package on the CPU.

- plan() decides the same (scheme, engine, block_shape, σ) and the same
  permutation as `repro.api.plan(..., cache=False)` on the five smoke
  matrices and one bench matrix, for reorder ∈ {baseline, rcm, auto} and
  k ∈ {1, 8};
- the built Operator's `op(x)` / `op.matmul(X)` match the reference's in
  the original index space (float32, rel 1e-5: same terms, another
  summation order), for the tuned engine and every forced engine;
- cg_solve / block_cg_solve reach the reference's iterate within 1e-5;
- convert.operator_from_reference / plan_from_reference carry every
  engine's state() and a plan across, computing the same thing;
- a plan built with other values (the structure twin that verification
  uses) matches the reference's plan on that matrix, and verification on
  the twin catches a dropped chunk;
- plan() consults the port's plan store by default, as the reference does.

Every test runs with its own plan store and reorder cache (a temporary
directory), so no test reads another's entries.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.core.measure import cg as rcg
from repro.core.spmv.ops import make_engine as ref_make_engine
from repro.matrices import suite as rsuite
from repro_torch import convert
from repro_torch.core.measure import cg as tcg
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv import plan as tplan
from repro_torch.core.spmv.ops import make_engine
from repro_torch.launch import spmv_bench

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _hermetic_stores(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.setenv("REPRO_TORCH_REORDER_CACHE", str(tmp_path / "reorder"))

PLAN_MATRICES = rsuite.smoke_names() + ["stencil2d_shuf_128"]
ENGINES = ("csr", "ell", "bell", "bcsr", "sell", "dense")


def _pair(name):
    rm = rsuite.get(name)
    return rm, CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                         shape=rm.shape)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _decision(pl):
    t = pl.tune
    return (pl.scheme, t.engine, tuple(t.block_shape), t.sell_sigma)


@pytest.mark.parametrize("name", PLAN_MATRICES)
@pytest.mark.parametrize("reorder", ["baseline", "rcm", "auto"])
@pytest.mark.parametrize("k", [1, 8])
def test_plan_matches_reference(name, reorder, k):
    rm, pm = _pair(name)
    want = rapi.plan(rapi.SpmvProblem(rm, k=k), reorder=reorder, cache=False)
    got = tplan.plan(tplan.SpmvProblem(pm, k=k), reorder=reorder)
    assert _decision(got) == _decision(want)
    assert got.tune.label() == want.tune.label()
    if want.perm is None:
        assert got.perm is None
    else:
        np.testing.assert_array_equal(got.perm, want.perm)
    assert got.scheme_costs == pytest.approx(want.scheme_costs, rel=1e-12)


@pytest.mark.parametrize("name", ["smoke_sbm", "smoke_powerlaw",
                                  "smoke_stencil"])
@pytest.mark.parametrize("engine", ("auto",) + ENGINES)
def test_operator_matches_reference_in_original_space(name, engine):
    rm, pm = _pair(name)
    want_op = rapi.plan(rapi.SpmvProblem(rm, k=8), reorder="rcm",
                        engine=engine, cache=False).build(cache=False)
    got_op = tplan.plan(tplan.SpmvProblem(pm, k=8), reorder="rcm",
                        engine=engine).build(device="cpu")
    assert got_op.perm is not None
    np.testing.assert_array_equal(got_op.perm, want_op.perm)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(rm.n)
    xs = rng.standard_normal((rm.n, 8))
    y = got_op(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y, want_op(jnp.asarray(x, jnp.float32))) < 1e-5
    assert _rel(y, rm.spmv(x)) < 1e-5
    ys = got_op.matmul(torch.as_tensor(xs, dtype=torch.float32))
    assert ys.shape == (rm.m, 8)
    assert _rel(ys, want_op.matmul(jnp.asarray(xs, jnp.float32))) < 1e-5
    # permuted=True runs in the reordered space
    rmat = got_op.plan.reordered_matrix()
    xr = torch.as_tensor(x, dtype=torch.float32)
    assert _rel(got_op(xr, permuted=True), rmat.spmv(x)) < 1e-5


@pytest.mark.parametrize("name", ["smoke_banded", "smoke_stencil"])
def test_cg_solve_matches_reference(name):
    rm, pm = _pair(name)
    b = np.random.default_rng(1).standard_normal(rm.n)
    want_op = ref_make_engine(rm, "csr")
    got_op = make_engine(pm, "csr", device="cpu")
    want = rcg.cg_solve(want_op, jnp.asarray(b, jnp.float32), max_iter=40,
                        tol=1e-6)
    got = tcg.cg_solve(got_op, torch.as_tensor(b, dtype=torch.float32),
                       max_iter=40, tol=1e-6)
    assert got.iters == int(want.iters)
    assert _rel(got.x, want.x) < 1e-5
    assert _rel(pm.spmv(got.x.double().numpy()), b) < 1e-5


@pytest.mark.parametrize("k", [1, 4])
def test_block_cg_solve_matches_reference(k):
    rm, pm = _pair("smoke_stencil")
    b = np.random.default_rng(2).standard_normal((rm.n, k))
    want_op = ref_make_engine(rm, "ell")
    got_op = make_engine(pm, "ell", device="cpu")
    want = rcg.block_cg_solve(want_op.matmul, jnp.asarray(b, jnp.float32),
                              max_iter=40, tol=1e-6)
    got = tcg.block_cg_solve(got_op.matmul,
                             torch.as_tensor(b, dtype=torch.float32),
                             max_iter=40, tol=1e-6)
    assert got.iters == int(want.iters)
    assert _rel(got.x, want.x) < 1e-5


def test_cg_measured_times_every_iteration_on_the_cpu():
    _, pm = _pair("smoke_banded")
    op = make_engine(pm, "ell", device="cpu")
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(pm.n),
                        dtype=torch.float32)
    ms = tcg.cg_measured(op, b, iters=5, warmup=1)
    assert ms.shape == (5,) and (ms >= 0).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_operator_from_reference_round_trips_state(engine):
    rm, pm = _pair("smoke_banded")
    ref_op = ref_make_engine(rm, engine, block_shape=(8, 32)
                             if engine == "sell" else (8, 16))
    meta, arrays = ref_op.state()
    op = convert.operator_from_reference(type(ref_op).__name__, meta, arrays,
                                         device="cpu")
    x = np.random.default_rng(4).standard_normal(rm.n)
    got = op(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(got, ref_op(jnp.asarray(x, jnp.float32))) < 1e-5
    assert _rel(got, rm.spmv(x)) < 1e-5
    # the port's state() keeps the reference's names and arrays exactly
    pmeta, parrays = op.state()
    assert sorted(parrays) == sorted(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(parrays[key], np.asarray(arr))
    assert {key: pmeta[key] for key in meta if key != "use_kernel"} == \
        {key: meta[key] for key in meta if key != "use_kernel"}
    # and the port's own state() round-trips through from_state
    again = type(op).from_state(pmeta, parrays, device="cpu")
    assert _rel(again(torch.as_tensor(x, dtype=torch.float32)), got) == 0.0


def test_operator_from_reference_rejects_unknown_classes():
    with pytest.raises(KeyError, match="no port"):
        convert.operator_from_reference("ShardedOperator", {}, {},
                                        device="cpu")


@pytest.mark.parametrize("name", ["smoke_sbm", "smoke_powerlaw"])
def test_plan_from_reference_holds_the_decision(name):
    rm, pm = _pair(name)
    want = rapi.plan(rapi.SpmvProblem(rm, k=8), reorder="auto", cache=False)
    got = convert.plan_from_reference(want.to_json(), want.perm, mat=pm)
    assert _decision(got) == _decision(want)
    assert got.key == want.key
    op = got.build(device="cpu")
    x = np.random.default_rng(5).standard_normal(rm.n)
    want_y = want.build(cache=False)(jnp.asarray(x, jnp.float32))
    assert _rel(op(torch.as_tensor(x, dtype=torch.float32)), want_y) < 1e-5


@pytest.mark.parametrize("engine", ("auto",) + ENGINES)
def test_build_with_values_matches_the_reference_on_the_twin(engine):
    rm, pm = _pair("smoke_sbm")
    twin = spmv_bench.structure_twin(pm, seed=3)
    op = tplan.plan(tplan.SpmvProblem(pm), reorder="rcm",
                    engine=engine).build(device="cpu", values=twin.vals)
    want_op = rapi.plan(rapi.SpmvProblem(dataclasses.replace(
        rm, vals=twin.vals)), reorder="rcm", engine=engine,
        cache=False).build(cache=False)
    x = np.random.default_rng(8).standard_normal(rm.n)
    y = op(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y, want_op(jnp.asarray(x, jnp.float32))) < 1e-5
    assert _rel(y, twin.spmv(x)) < 1e-5
    with pytest.raises(ValueError, match="values must be"):
        op.plan.build(device="cpu", values=twin.vals[1:])


def test_verify_on_the_twin_catches_a_dropped_chunk():
    _, pm = _pair("smoke_banded")
    twin = spmv_bench.structure_twin(pm, seed=0)
    op = make_engine(twin, "sell", block_shape=(8, 32), device="cpu")
    assert spmv_bench.verify(op, twin, device="cpu") < 1e-6
    op.chunk_vals[0].zero_()
    with pytest.raises(AssertionError, match="verify failed"):
        spmv_bench.verify(op, twin, device="cpu")


def test_plan_cache_is_not_ported_yet():
    """The plan store is ported now (the name is kept): plan() consults it
    by default, as the reference does, and a second request is a hit that
    paid no plan time."""
    _, pm = _pair("smoke_banded")
    first = tplan.plan(tplan.SpmvProblem(pm), reorder="rcm")
    again = tplan.plan(tplan.SpmvProblem(pm), reorder="rcm")
    assert not first.cache_hit and first.tune_ms > 0
    assert again.cache_hit and again.tune_ms == again.reorder_ms == 0.0
    assert _decision(again) == _decision(first)
    np.testing.assert_array_equal(again.perm, first.perm)


def test_spans_keep_the_reference_names_with_backend_torch():
    from repro import obs as robs
    from repro_torch import obs

    rm, pm = _pair("smoke_sbm")
    x = np.random.default_rng(6).standard_normal((rm.n, 3))
    with obs.tracing() as buf:
        op = tplan.plan(tplan.SpmvProblem(pm, k=3), reorder="rcm",
                        probe=True, device="cpu").build(device="cpu")
        op(torch.as_tensor(x[:, 0], dtype=torch.float32))
        op.matmul(torch.as_tensor(x, dtype=torch.float32))
    events = buf.flush()
    with robs.tracing() as rbuf:
        rop = rapi.plan(rapi.SpmvProblem(rm, k=3), reorder="rcm", probe=True,
                        cache=False).build(cache=False)
        rop(jnp.asarray(x[:, 0], jnp.float32))
        rop.matmul(jnp.asarray(x, jnp.float32))
    names = {e["name"] for e in events}
    assert names == {"plan", "plan.reorder", "plan.tune", "plan.probe",
                     "plan.build", "kernel.spmv", "kernel.spmm"}
    assert names <= {e["name"] for e in rbuf.flush()}
    assert all(e["args"]["backend"] == "torch" for e in events)
    probes = [e for e in events if e["name"] == "plan.probe"]
    assert len(probes) == 3 and all(e["args"]["ms"] >= 0 for e in probes)


def test_reorder_cache_writes_then_reads(tmp_path, monkeypatch):
    from repro.core.reorder.api import reorder as ref_reorder
    from repro_torch import obs
    from repro_torch.core.reorder.api import reorder

    monkeypatch.setenv("REPRO_TORCH_REORDER_CACHE", str(tmp_path))
    rm, pm = _pair("smoke_powerlaw")
    hits = obs.REGISTRY.total("reorder_cache.hits")
    misses = obs.REGISTRY.total("reorder_cache.misses")
    first = reorder(pm, "rcm", seed=3)
    again = reorder(pm, "rcm", seed=3)
    assert obs.REGISTRY.total("reorder_cache.misses") == misses + 1
    assert obs.REGISTRY.total("reorder_cache.hits") == hits + 1
    assert [p.suffix for p in tmp_path.iterdir()] == [".npy"]
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(
        first, ref_reorder(rm, "rcm", seed=3, cache=False))
    assert "counters" in obs.snapshot()
