"""The port's workload streams (repro_torch.workloads) against the JAX
package's on the CPU:

- for every preset x {static, drift, shift1} the steps are bit-identical:
  each operand's CSR arrays and x, and the step metadata;
- the MoE dispatch buffer equals the reference's bit for bit (and the
  one-hot reference's); combine, attention and GNN outputs are within
  1e-5 of the reference's;
- WorkloadSession gives the reference's event sequence (plan / replan /
  reuse / rebuild / delta) on every kind and scenario, deltas included;
- the reference's own workload cases, run on the port: agreement with the
  onehot and dense references, the amortization pins, the name grammar,
  workload:// in the suite, the GNN drift stream that deltas replace
  every replan of, and the "workload" cell kind through the Runner,
  resumed from the store.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads as RW
from repro.workloads import adapters as radapters
from repro_torch import obs
from repro_torch import workloads as W
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv.plan import structure_key, values_key
from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                     ResultStore, Runner)
from repro_torch.matrices import suite
from repro_torch.workloads import adapters

torch.set_num_threads(1)

MOE = "workload://moe-e8-k2-t128-d16-n3"
ATTN = "workload://attn-s128-b32-w2-g1-d8-n3"
GNN = "workload://gnn-m128-deg4-f8-n3"
GNN_RW = "workload://gnn-m128-deg6-n5-rw0.02"


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_TORCH_RESULT_STORE", "results"),
                     ("REPRO_PLAN_CACHE", "ref_plans"),
                     ("REPRO_OPERATOR_CACHE", "ref_opcache"),
                     ("REPRO_REORDER_CACHE", "ref_reorder"),
                     ("REPRO_RESULT_STORE", "ref_results")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    return tmp_path


def _port(rm):
    return CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                     shape=rm.shape)


def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("rowptr", "cols", "vals"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _delta(before, after, name):
    return after["counters"].get(name, 0) - before["counters"].get(name, 0)


# -- bit-identical streams ---------------------------------------------------
@pytest.mark.parametrize("scenario", W.SCENARIOS)
@pytest.mark.parametrize("name", W.preset_names())
def test_steps_match_reference(name, scenario):
    wd, rwd = W.parse_workload(name), RW.parse_workload(name)
    assert wd.params == rwd.params and wd.kind == rwd.kind
    n = 0
    for st, rst in zip(W.steps(wd, scenario, seed=3),
                       RW.steps(rwd, scenario, seed=3)):
        n += 1
        assert st.index == rst.index
        assert len(st.operands) == len(rst.operands)
        for o, ro in zip(st.operands, rst.operands):
            assert o.role == ro.role
            _same_csr(o.mat, ro.mat)
            assert (o.x is None) == (ro.x is None)
            if o.x is not None:
                assert o.x.dtype == ro.x.dtype and np.array_equal(o.x, ro.x)
        assert st.meta.keys() == rst.meta.keys()
        for k, v in st.meta.items():
            assert np.array_equal(np.asarray(v), np.asarray(rst.meta[k])), k
    assert n == wd.steps


def test_rewired_graph_matches_reference():
    from repro.matrices import generators as RG
    from repro.workloads import sources as rsources
    from repro_torch.workloads import sources

    rm = RG.random_uniform(300, 6, seed=2)
    for frac, seed in ((0.01, 0), (0.1, 5)):
        _same_csr(sources._rewire_graph(_port(rm), frac, seed),
                  rsources._rewire_graph(rm, frac, seed))


# -- adapters against the reference -----------------------------------------
def test_moe_dispatch_matches_reference_bitwise():
    rng = np.random.default_rng(0)
    n, d, e, k = 96, 8, 4, 2
    x = rng.standard_normal((n, d)).astype(np.float32)
    wr = rng.standard_normal((d, e)).astype(np.float32)
    for engine in ("sell", "csr"):
        buf, y, info = W.moe_sorted_dispatch(x, wr, k, e, engine=engine,
                                             device="cpu")
        rbuf, ry, rinfo = RW.moe_sorted_dispatch(x, wr, k, e,
                                                 engine=engine)
        assert info["cap"] == rinfo["cap"]
        assert np.array_equal(buf, np.asarray(rbuf))
        assert np.abs(y - np.asarray(ry)).max() <= 1e-5 * np.abs(ry).max()
    gates, experts = W.moe_route_np(x, wr, k)
    ref_buf, ref_y = radapters._onehot_dispatch_combine(
        jnp.asarray(x), jnp.asarray(experts), jnp.asarray(gates),
        num_experts=e, cap=info["cap"])
    pbuf, py = adapters._onehot_dispatch_combine(
        torch.as_tensor(x), torch.as_tensor(experts),
        torch.as_tensor(gates), num_experts=e, cap=info["cap"])
    assert np.array_equal(pbuf.numpy(), np.asarray(ref_buf))
    assert np.array_equal(buf, pbuf.numpy())
    assert np.abs(py.numpy() - np.asarray(ref_y)).max() <= \
        1e-5 * np.abs(np.asarray(ref_y)).max()


@pytest.mark.parametrize("name", [ATTN, GNN])
def test_attn_and_gnn_adapters_match_reference(name):
    step = next(W.DynamicSparseProblem(name).steps())
    mat, x = step.operands[0].mat, step.operands[0].x
    if name == ATTN:
        got = W.block_sparse_attention(mat, x, block=step.meta["block"],
                                       device="cpu")
        want = RW.block_sparse_attention(mat, x, block=step.meta["block"])
    else:
        got = W.gnn_aggregate(mat, x, device="cpu")
        want = RW.gnn_aggregate(mat, x)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", [ATTN, GNN])
def test_plain_references_agree(name, monkeypatch):
    """The dense reference and the scatter product past DENSE_MAX_ELEMS
    compute the same product as the JAX package's dense reference."""
    step = next(W.DynamicSparseProblem(name).steps())
    kind = W.parse_workload(name).kind
    want = np.asarray(radapters.reference(kind, step, iters=1)["y"])
    dense = adapters.reference(kind, step, iters=1, device="cpu")["y"]
    monkeypatch.setattr(adapters, "DENSE_MAX_ELEMS", 0)
    scatter = adapters.reference(kind, step, iters=1, device="cpu")["y"]
    for got in (dense, scatter):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -- session events against the reference ---------------------------------
@pytest.mark.parametrize("scenario", W.SCENARIOS)
@pytest.mark.parametrize("name,engine,deltas",
                         [(MOE, "sell", False), (ATTN, "bcsr", False),
                          (GNN, "auto", False), (GNN_RW, "sell", True)])
def test_session_events_match_reference(name, engine, deltas, scenario):
    prob = W.DynamicSparseProblem(name, scenario=scenario)
    rprob = RW.DynamicSparseProblem(name, scenario=scenario)
    sess = W.WorkloadSession(prob, engine=engine, use_deltas=deltas,
                             device="cpu")
    rsess = RW.WorkloadSession(rprob, engine=engine, use_deltas=deltas)
    events, revents = [], []
    for st, rst in zip(prob.steps(), rprob.steps()):
        for o, ro in zip(st.operands, rst.operands):
            events.append(sess.operator(o.mat, role=o.role)[1])
            revents.append(rsess.operator(ro.mat, role=ro.role)[1])
    assert events == revents
    assert sess.counts == rsess.counts


def test_run_stream_matches_reference_record():
    prob = W.DynamicSparseProblem(MOE, scenario="drift")
    rec = W.run_stream(prob, iters=1, device="cpu")
    rrec = RW.run_stream(RW.DynamicSparseProblem(MOE, scenario="drift"),
                         iters=1)
    for key in ("steps", "width", "m", "n", "nnz", "plans", "replans",
                "reuses", "rebuilds", "deltas", "reuse_rate", "li_mean",
                "li_max", "drop_frac", "dispatch_bitwise_equal",
                "verify_ok"):
        assert rec[key] == rrec[key], key
    assert [r["events"] for r in rec["per_step"]] == \
        [r["events"] for r in rrec["per_step"]]


# -- the reference's cases, on the port -------------------------------------
def test_stream_agrees_with_onehot_oracle():
    rec = W.run_stream(W.DynamicSparseProblem(MOE, scenario="drift"),
                       iters=2, device="cpu")
    assert rec["verify_ok"] and rec["max_rel_err"] < 1e-3
    assert rec["dispatch_bitwise_equal"]


def test_attn_and_gnn_adapters_match_dense_oracle():
    for name in (ATTN, GNN):
        step = next(W.DynamicSparseProblem(name).steps())
        mat, x = step.operands[0].mat, step.operands[0].x
        if name == ATTN:
            got = W.block_sparse_attention(mat, x, block=step.meta["block"],
                                           device="cpu")
        else:
            got = W.gnn_aggregate(mat, x, device="cpu")
        want = mat.to_dense() @ x
        assert np.abs(got - want).max() < 1e-4 * \
            (np.abs(want).max() + 1.0), name


def test_value_only_stream_never_replans():
    before = obs.snapshot()
    rec = W.run_stream(W.DynamicSparseProblem(MOE, scenario="static"),
                       iters=1, compare_dense=False, device="cpu")
    after = obs.snapshot()
    assert rec["replans"] == 0
    assert _delta(before, after, "workload.replans") == 0
    assert _delta(before, after, "workload.reuses") \
        + _delta(before, after, "workload.rebuilds") == rec["reuses"] \
        + rec["rebuilds"] > 0
    assert rec["reuse_rate"] > 0


def test_one_structure_change_replans_exactly_once():
    before = obs.snapshot()
    rec = W.run_stream(W.DynamicSparseProblem(GNN, scenario="shift1"),
                       iters=1, compare_dense=False, device="cpu")
    after = obs.snapshot()
    assert rec["replans"] == 1
    assert _delta(before, after, "workload.replans") == 1
    assert _delta(before, after, "workload.plans") == 1


def test_structure_and_values_keys_split_content():
    mat = next(W.DynamicSparseProblem(GNN).steps()).operands[0].mat
    same_structure = dataclasses.replace(
        mat, vals=(mat.vals * 2.0).astype(np.float32))
    assert structure_key(mat) == structure_key(same_structure)
    assert values_key(mat) != values_key(same_structure)


def test_session_events_reuse_vs_rebuild():
    prob = W.DynamicSparseProblem(GNN, scenario="static")
    sess = W.WorkloadSession(prob, device="cpu")
    steps = list(prob.steps())
    _, e0 = sess.operator(steps[0].operands[0].mat, role="aggregate")
    _, e1 = sess.operator(steps[1].operands[0].mat, role="aggregate")
    assert (e0, e1) == ("plans", "rebuilds")
    assert sess.operator(steps[1].operands[0].mat,
                         role="aggregate")[1] == "reuses"


def test_gnn_drift_with_deltas_pins_zero_replans():
    prob = W.DynamicSparseProblem(GNN_RW, scenario="drift", seed=0)
    session = W.WorkloadSession(prob, use_deltas=True, device="cpu")
    applies0 = obs.counter("delta.applies").value
    out = W.run_stream(prob, session, iters=1, compare_dense=True)
    assert out["replans"] == 0
    assert out["plans"] == 1
    assert out["deltas"] == out["steps"] - 1 > 0
    assert obs.counter("delta.applies").value >= applies0 + out["deltas"]
    assert out["verify_ok"]
    base = W.run_stream(prob, W.WorkloadSession(prob, device="cpu"),
                        iters=1, compare_dense=False)
    assert base["replans"] == out["steps"] - 1 and base["deltas"] == 0


def test_name_grammar():
    wd = W.parse_workload("workload://moe-e16-k4-t512")
    assert wd.params["e"] == 16 and wd.params["k"] == 4
    assert wd.params["d"] == 32
    for bad in ("workload://nope-e2", "workload://moe-z9", "moe-e2"):
        with pytest.raises(ValueError):
            W.parse_workload(bad)


def test_suite_resolves_representative():
    mat = suite.get(MOE)
    assert mat.shape[1] == 128           # dispatch: [E*cap, tokens]
    assert set(suite.workload_names()) == set(W.preset_names())
    assert "workload" in suite.TIERS


def test_moe_cell_rejects_reordering_schemes():
    from repro_torch.experiments.cells import measure_workload_cell
    from repro_torch.experiments.spec import Cell

    pol = MeasurePolicy(iters=1, warmup=0)
    cell = Cell(kind="workload", matrix=MOE, scheme="rcm", engine="auto",
                dtype="float32", p=1, k=1, variant="",
                policy=tuple(sorted(pol.resolve("*").items())))
    with pytest.raises(ValueError, match="rectangular"):
        measure_workload_cell(cell, None, torch.device("cpu"))


def test_workload_cells_resume_from_store(tmp_path):
    spec = ExperimentSpec(
        name="t_workloads", matrices=(GNN,), schemes=("baseline",),
        engines=("sell",), kind="workload", variants=("static", "shift1"),
        policy=MeasurePolicy(iters=1, warmup=0, verify=True))
    store = ResultStore(str(tmp_path / "cells"))
    rep = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert rep.measured == 2 and not rep.failures
    by_scen = {r["variant"]: r for r in rep.records}
    assert by_scen["static"]["replans"] == 0
    assert by_scen["shift1"]["replans"] == 1
    for r in rep.records:
        assert r["verify_ok"]
        assert 0.0 <= r["plan_cost_share"] <= 1.0
        assert r["steps"] == 3 and len(r["per_step"]) == 3
        assert set(r["launches"]) >= {"sell_spmv", "sell_spmm"}
    rep2 = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert rep2.measured == 0 and rep2.reused == 2
