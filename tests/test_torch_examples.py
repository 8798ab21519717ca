"""The last functions of modules the port had already ported, against the
JAX package's on the CPU, and the port's examples run small:

- cg.solve_problem: plan, build and CG-solve in the original index space,
  for a [n] and a [n, 4] right-hand side and on a sharded plan of 4
  (simulated) devices; the solution within 1e-5 of the reference's,
  relative to its largest entry (both solve to ||r|| <= 1e-7·||b|| in
  float32 on a diagonally dominant matrix, so each lies within ~1e-7 of
  the exact solution);
- sell_to_dense and bell_to_dense bit for bit the reference's on every
  smoke matrix, and both the matrix itself;
- ios.summarize the reference's;
- obs.enabled() follows tracing on and off, as the reference's does;
- python -m repro_torch.examples.{quickstart,cg_solver,moe_reordering} at
  a small size on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core.measure import cg as rcg
from repro.core.measure import ios as rios
from repro.core.sparse import bell as rbell
from repro.core.sparse import sell as rsell
from repro.core.spmv.topology import Topology as RTopology
from repro.matrices import suite as rsuite
from repro_torch import obs
from repro_torch.core.measure import cg, ios
from repro_torch.core.sparse import bell, sell
from repro_torch.core.spmv.distributed import ShardedOperator
from repro_torch.core.spmv.topology import Topology
from repro_torch.matrices import suite

torch.set_num_threads(1)

SMOKE = suite.smoke_names()
SOLVE_TOL = 1e-5


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    for var in ("REPRO_TORCH_PLAN_CACHE", "REPRO_TORCH_REORDER_CACHE",
                "REPRO_TORCH_OPERATOR_CACHE", "REPRO_TORCH_RESULT_STORE",
                "REPRO_PLAN_CACHE", "REPRO_REORDER_CACHE",
                "REPRO_OPERATOR_CACHE", "REPRO_RESULT_STORE"):
        monkeypatch.setenv(var, str(tmp_path / var.lower()))
    return tmp_path


def _rhs(mat, k):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(mat.n if k == 1 else (mat.n, k))
    if k == 1:
        return mat.spmv(x).astype(np.float32)
    return np.stack([mat.spmv(x[:, j]) for j in range(k)],
                    axis=1).astype(np.float32)


def _solve_both(name, k, sharded):
    mat = suite.get(name)
    b = _rhs(mat, k)
    kw = dict(reorder="rcm", engine="csr", max_iter=300, tol=1e-7)
    ref_kw = dict(kw)
    if sharded:
        kw.update(topology=Topology(devices=4), partition="nnz_balanced")
        ref_kw.update(topology=RTopology(devices=4),
                      partition="nnz_balanced")
    res, op = cg.solve_problem(mat, torch.as_tensor(b), device="cpu", **kw)
    rres, _ = rcg.solve_problem(rsuite.get(name), jnp.asarray(b), **ref_kw)
    return mat, b, res, op, np.asarray(rres.x, np.float64)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["smoke_banded", "smoke_stencil"])
def test_solve_problem_matches_the_reference(name, k):
    mat, b, res, op, want = _solve_both(name, k, sharded=False)
    got = res.x.double().numpy()
    assert got.shape == want.shape == b.shape
    assert np.abs(got - want).max() <= SOLVE_TOL * np.abs(want).max()
    # the solution is in the original index space: A x = b directly
    ax = mat.spmv(got) if k == 1 else np.stack(
        [mat.spmv(got[:, j]) for j in range(k)], axis=1)
    assert np.abs(ax - b).max() <= 1e-4 * np.abs(b).max()
    assert op.plan.scheme == "rcm" and op.build_info["engine"] == "csr"


@pytest.mark.parametrize("k", [1, 4])
def test_solve_problem_on_a_sharded_plan(k):
    _, _, res, op, want = _solve_both("smoke_banded", k, sharded=True)
    assert isinstance(op, ShardedOperator)
    got = res.x.double().numpy()
    assert np.abs(got - want).max() <= SOLVE_TOL * np.abs(want).max()


def test_solve_problem_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mat = suite.get("smoke_banded")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cg.solve_problem(mat, torch.as_tensor(_rhs(mat, 1)))


@pytest.mark.parametrize("name", SMOKE)
def test_sell_to_dense_is_the_references(name):
    mat, rmat = suite.get(name), rsuite.get(name)
    got = sell.sell_to_dense(sell.to_sell(mat, c=8, sigma=64, w=32))
    want = rsell.sell_to_dense(rsell.to_sell(rmat, c=8, sigma=64, w=32))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mat.to_dense().astype(got.dtype))


@pytest.mark.parametrize("name", SMOKE)
def test_bell_to_dense_is_the_references(name):
    mat, rmat = suite.get(name), rsuite.get(name)
    got = bell.bell_to_dense(bell.to_block_ell(mat, 8, 16))
    want = rbell.bell_to_dense(rbell.to_block_ell(rmat, 8, 16))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mat.to_dense().astype(got.dtype))


@pytest.mark.parametrize("ms", [[1.0], [0.5, 0.25, 2.0, 1.0],
                                list(np.linspace(0.1, 3.0, 17))])
def test_summarize_is_the_references(ms):
    ms = np.asarray(ms)
    assert ios.summarize(ms) == rios.summarize(ms)


def test_spans_enabled_follows_tracing():
    assert obs.enabled() is robs.enabled() is False
    with obs.tracing():
        assert obs.enabled() is True
        with obs.span("x"):
            assert obs.enabled()
    assert obs.enabled() is False
    with robs.tracing():
        assert robs.enabled() is True
    assert obs.enabled() is robs.enabled() is False


# -- the examples ------------------------------------------------------------
def test_quickstart_small():
    from repro_torch.examples import quickstart

    out = quickstart.main(["--rows", "2000", "--device", "cpu"])
    assert [r["scheme"] for r in out] == quickstart.SCHEMES
    assert all(r["err"] < 1e-4 and r["ios_ms"] > 0 for r in out)


def test_cg_solver_small():
    from repro_torch.examples import cg_solver

    out = cg_solver.main(["--grid", "24", "--device", "cpu"])
    for scheme in ("baseline", "rcm"):
        assert 0 < out[scheme]["iters"] < 300
        assert out[scheme]["check"] < 1e-2
    assert out["bell_vs_csr"] < 1e-5


def test_moe_reordering_small():
    from repro_torch.examples import moe_reordering

    out = moe_reordering.main(["--tokens", "256", "--stream-tokens", "128",
                               "--device", "cpu"])
    for key in ("e16_k2", "e64_k8"):
        assert out[key]["li"] >= 1.0 and 0 <= out[key]["drop_frac"] < 1
    assert out["stream"]["replans"] == 0


@pytest.mark.parametrize("name", ["quickstart", "cg_solver",
                                  "moe_reordering"])
def test_examples_raise_without_a_card(name, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
