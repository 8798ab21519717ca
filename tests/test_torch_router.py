"""The port's multi-shard router (src/repro_torch/router) against the JAX
package's (src/repro/router), on the CPU.

The same matrices, built by the JAX package's generators from seeds and
handed to both packages as the same arrays, go through both routers:

- estimate_nbytes, every built-in placement policy (bin_pack, nnz_balance,
  comm_aware) over fleets of 1-, 2- and 4-device meshes with bounded and
  unbounded budgets, and the RoutingTable ledger after the same assign and
  remove sequence are the reference's, exactly;
- per_device_bytes of the same registered sharded keys are the
  reference's, byte for byte; routed answers agree with the reference's
  within the tolerance tests/test_torch_sharded.py holds ShardedOperator
  to (1e-5 relative in f32);
- route_variant gives the reference's strings and _parse_route_variant
  reads them back;
- the reference's own router cases (tests/test_router.py), run on the
  port with device="cpu": per-device budgets with eviction and reload,
  background replans with the sibling serving, a routed delta applied
  without a full replan, an unrouted key, the registry errors, a pinned
  mesh=; beside them what the reference never ran: a sharded value swap
  through the router, and RoutedSpmvService() raising without a card.
"""
import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

from repro.core.spmv import topology as rtopo
from repro.experiments import cells as rcells
from repro.matrices import generators as RG
from repro import router as rrouter
from repro_torch import obs
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv.delta import StructureDelta
from repro_torch.core.spmv.topology import Topology
from repro_torch.experiments import cells
from repro_torch.router import (PLACEMENT_REGISTRY, MeshSpec,
                                RoutedSpmvService, RoutingTable,
                                estimate_nbytes, get_placement,
                                register_placement)
from repro_torch.serving.errors import (BadRequest, ServiceClosed,
                                        UnregisteredKey)

torch.set_num_threads(1)

F32_TOL = 1e-5          # tests/test_torch_sharded.py's ShardedOperator tol
KW = dict(window_ms=1.0, max_batch=4, device="cpu")


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_TORCH_RESULT_STORE", "results"),
                     ("REPRO_PLAN_CACHE", "ref_plans"),
                     ("REPRO_OPERATOR_CACHE", "ref_opcache"),
                     ("REPRO_REORDER_CACHE", "ref_reorder"),
                     ("REPRO_RESULT_STORE", "ref_results"),
                     ("REPRO_TORCH_RESULTS_DIR", "bench_results")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    return tmp_path


_BUILDERS = {
    "banded": lambda: RG.shuffle(RG.banded(1024, 6, seed=0), seed=1),
    "uniform": lambda: RG.random_uniform(512, 8, seed=2),
    "powerlaw": lambda: RG.power_law(512, alpha=1.9, seed=6),
}
MATRICES = tuple(_BUILDERS)
_MATS = {}


def pair(name):
    """(reference matrix, the same arrays as the port's CSRMatrix)."""
    if name not in _MATS:
        rm = _BUILDERS[name]()
        _MATS[name] = (rm, port_mat(rm))
    return _MATS[name]


def port_mat(rm):
    return CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                     shape=rm.shape)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-300)


def _close(got, mat, x):
    want = mat.to_dense() @ x
    return np.abs(np.asarray(got, np.float64) - want).max() \
        <= 1e-3 * max(np.abs(want).max(), 1.0)


# (name, devices, layout, budget_per_device in units of the banded
# matrix's estimate) — bounded, unbounded and mixed fleets of 1-, 2- and
# 4-device meshes
FLEETS = {
    "unbounded": (("a", 1, "1d_rows", None), ("b", 2, "1d_rows", None),
                  ("c", 4, "1d_rows", None)),
    "bounded": (("a", 1, "1d_rows", 1.5), ("b", 2, "1d_rows", 0.8),
                ("c", 4, "2d_panels", 0.3)),
    "mixed": (("a", 2, "1d_rows", 0.6), ("b", 4, "1d_rows", None),
              ("c", 1, "1d_rows", 3.0)),
    "tight": (("a", 1, "1d_rows", 0.1), ("b", 2, "1d_rows", 0.05)),
}


def _fleets(fleet):
    unit = estimate_nbytes(pair("banded")[1])
    mine, ref = [], []
    for name, d, layout, frac in FLEETS[fleet]:
        b = None if frac is None else max(int(frac * unit), 1)
        mine.append(MeshSpec(name, Topology(devices=d, layout=layout),
                             budget_per_device=b))
        ref.append(rrouter.MeshSpec(name, rtopo.Topology(devices=d,
                                                         layout=layout),
                                    budget_per_device=b))
    return mine, ref


def _loads(meshes):
    return {m.name: {"keys": 0, "nnz": 0, "est_bytes": 0} for m in meshes}


# -- the same answers as the reference --------------------------------------
@pytest.mark.parametrize("dtype_size", [2, 4, 8])
@pytest.mark.parametrize("name", MATRICES)
def test_estimate_nbytes_is_the_references(name, dtype_size):
    rm, pm = pair(name)
    assert estimate_nbytes(pm, dtype_size) == \
        rrouter.estimate_nbytes(rm, dtype_size)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("policy", ["bin_pack", "nnz_balance",
                                    "comm_aware"])
def test_policy_chooses_the_references_mesh(policy, fleet, name):
    """One policy call on an empty ledger, then five keys of the matrix
    through a RoutingTable (the ledger grows), then a remove and a
    re-assign: every choice and the final snapshot are the reference's."""
    rm, pm = pair(name)
    mine, ref = _fleets(fleet)
    assert get_placement(policy).fn("k", pm, mine, _loads(mine)) == \
        rrouter.get_placement(policy).fn("k", rm, ref, _loads(ref))
    table, rtable = RoutingTable(mine, policy), rrouter.RoutingTable(ref,
                                                                     policy)
    for i in range(5):
        assert table.assign(f"k{i}", pm).name == \
            rtable.assign(f"k{i}", rm).name
    table.remove("k1", pm)
    rtable.remove("k1", rm)
    table.remove("k3")                       # ledger keeps its nnz/bytes
    rtable.remove("k3")
    assert table.assign("k5", pm).name == rtable.assign("k5", rm).name
    assert table.snapshot() == rtable.snapshot()


def test_routing_table_snapshot_is_the_references_over_matrices():
    mine, ref = _fleets("mixed")
    table = RoutingTable(mine, "nnz_balance")
    rtable = rrouter.RoutingTable(ref, "nnz_balance")
    for i, name in enumerate(MATRICES * 2):
        rm, pm = pair(name)
        pin = "c" if i == 4 else None
        assert table.assign(f"{name}{i}", pm, mesh=pin).name == \
            rtable.assign(f"{name}{i}", rm, mesh=pin).name
    for i in (0, 4):
        rm, pm = pair(MATRICES[i % 3])
        table.remove(f"{MATRICES[i % 3]}{i}", pm)
        rtable.remove(f"{MATRICES[i % 3]}{i}", rm)
    assert table.snapshot() == rtable.snapshot()


def test_mesh_spec_is_the_references():
    for topo, rt in ((None, None), (Topology(devices=1), None),
                     (Topology(devices=4, layout="2d_panels"),
                      rtopo.Topology(devices=4, layout="2d_panels"))):
        spec = MeshSpec("m", topo, budget_per_device=1000)
        rspec = rrouter.MeshSpec("m", rt if rt is not None else (
            None if topo is None else rtopo.Topology(devices=1)),
            budget_per_device=1000)
        assert spec.topology.to_json() == rspec.topology.to_json()
        assert spec.budget_bytes == rspec.budget_bytes
    assert MeshSpec("m", Topology(devices=2)).budget_bytes is None
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive or None"):
            MeshSpec("m", Topology(devices=2), budget_per_device=bad)


def _ref_service(meshes, **kw):
    return rrouter.RoutedSpmvService(meshes, use_kernel="interpret",
                                     window_ms=1.0, max_batch=4, **kw)


@pytest.mark.parametrize("policy", ["bin_pack", "nnz_balance",
                                    "comm_aware"])
def test_per_device_bytes_and_answers_are_the_references(policy):
    """The same keys registered on both routers: the same assignments, the
    same per-device bytes on every mesh, and answers (lone and batched)
    within F32_TOL of the reference's."""
    mine, ref = _fleets("unbounded")
    with RoutedSpmvService(mine, policy=policy, **KW) as rt, \
            _ref_service(ref, policy=policy) as rrt:
        for name in MATRICES:
            rm, pm = pair(name)
            assert rt.register(name, pm).name == rrt.register(name, rm).name
        for name in MATRICES:
            rt.operator(name)
            rrt.operator(name)
        st, rst = rt.stats(), rrt.stats()
        assert st["routing"] == rst["routing"]
        for mesh in st["per_mesh"]:
            assert st["per_mesh"][mesh]["per_device_bytes"] == \
                rst["per_mesh"][mesh]["per_device_bytes"]
        for name in MATRICES:
            n = pair(name)[1].n
            xs = [_x(n, s) for s in range(3)]
            futs = [rt.submit(name, x) for x in xs]
            rfuts = [rrt.submit(name, x) for x in xs]
            for f, rf in zip(futs, rfuts):
                assert _rel(f.result(timeout=60),
                            rf.result(timeout=60)) <= F32_TOL
            y = rt.submit(name, xs[0]).result(timeout=60)
            assert _rel(y, pair(name)[1].spmv(xs[0])) <= F32_TOL


@pytest.mark.parametrize("kw", [
    {},
    {"rate_rps": 600, "requests": 120, "n_keys": 4, "update_frac": 0.1,
     "structure_frac": 0.08, "devices": 4, "meshes": 2,
     "policy": "bin_pack", "budget_mb": 4.0, "window_ms": 1.0},
    {"rate_rps": 600, "requests": 80, "n_keys": 3, "structure_frac": 0.05,
     "devices": 4, "policy": "comm_aware", "window_ms": 1.0},
    {"arrival": "bursty", "zipf_s": 0.0, "layout": "2d_panels",
     "meshes": 3, "policy": "nnz_balance", "budget_mb": 0.5},
    {"arrival": "uniform", "rate_rps": 300.0, "devices": 2, "meshes": 2},
])
def test_route_variant_is_the_references(kw):
    v = cells.route_variant(**kw)
    assert v == rcells.route_variant(**kw)
    cfg = cells._parse_route_variant(v)
    assert cfg == rcells._parse_route_variant(v)
    assert cells.route_variant(**cfg) == v           # round trip
    assert cells._parse_route_variant(cells.route_variant(**cfg)) == cfg


# -- the reference's router cases, on the port ------------------------------
def test_bin_pack_best_fit_prefers_tightest_budget():
    mat = port_mat(RG.banded(256, 4, seed=3))
    est = estimate_nbytes(mat)
    meshes = [MeshSpec("big", Topology(devices=2),
                       budget_per_device=16 << 20),
              MeshSpec("tight", Topology(devices=1),
                       budget_per_device=est + 1024)]
    table = RoutingTable(meshes, policy="bin_pack")
    assert table.assign("k0", mat).name == "tight"   # best (smallest) fit
    assert table.assign("k1", mat).name == "big"     # tight is now full


def test_bin_pack_falls_back_to_unbounded_mesh():
    mat = port_mat(RG.banded(256, 4, seed=3))
    meshes = [MeshSpec("full", Topology(devices=1), budget_per_device=1),
              MeshSpec("open", Topology(devices=1))]
    spec = get_placement("bin_pack")
    assert spec.fn("k", mat, meshes, _loads(meshes)) == "open"


def test_nnz_balance_spreads_equal_meshes():
    mat = port_mat(RG.banded(256, 4, seed=4))
    meshes = [MeshSpec("m0", Topology(devices=2)),
              MeshSpec("m1", Topology(devices=2))]
    table = RoutingTable(meshes, policy="nnz_balance")
    got = {table.assign(f"k{i}", mat).name for i in range(2)}
    assert got == {"m0", "m1"}


def test_comm_aware_scores_every_mesh():
    mat = port_mat(RG.power_law(256, alpha=1.8, seed=5))
    meshes = [MeshSpec("wide", Topology(devices=4)),
              MeshSpec("solo", Topology(devices=1))]
    spec = get_placement("comm_aware")
    loads = _loads(meshes)
    first = spec.fn("k", mat, meshes, loads)
    assert first in {"wide", "solo"}
    assert spec.fn("k", mat, meshes, loads) == first   # pure in the ledger


def test_register_placement_and_registry_errors():
    name = "always_first_TEST"
    try:
        @register_placement(name, "test-only")
        def always_first(key, mat, meshes, loads):
            return meshes[0].name

        mat = port_mat(RG.banded(64, 2, seed=6))
        table = RoutingTable([MeshSpec("a", Topology(devices=1)),
                              MeshSpec("b", Topology(devices=1))],
                             policy=name)
        assert table.assign("k", mat).name == "a"
        with pytest.raises(ValueError, match="already registered"):
            register_placement(name)(always_first)
        register_placement(name, override=True)(always_first)
        assert PLACEMENT_REGISTRY[name].description == always_first.__doc__ \
            or PLACEMENT_REGISTRY[name].description == ""
    finally:
        PLACEMENT_REGISTRY.pop(name, None)
    with pytest.raises(KeyError, match="unknown placement policy"):
        get_placement("no_such_policy")
    with pytest.raises(KeyError, match="unknown placement policy"):
        RoutingTable([MeshSpec("a", Topology(devices=1))], policy="nope")
    # a policy naming a mesh outside the fleet is a policy bug
    try:
        register_placement("nowhere_TEST")(lambda k, m, ms, ld: "zz")
        table = RoutingTable([MeshSpec("a", Topology(devices=1))],
                             policy="nowhere_TEST")
        with pytest.raises(KeyError, match="returned unknown mesh"):
            table.assign("k", port_mat(RG.banded(64, 2, seed=6)))
        assert table.snapshot()["assignments"] == {}
    finally:
        PLACEMENT_REGISTRY.pop("nowhere_TEST", None)


def test_routing_table_ledger():
    mat = port_mat(RG.banded(64, 2, seed=7))
    meshes = [MeshSpec("a", Topology(devices=1)),
              MeshSpec("b", Topology(devices=1))]
    table = RoutingTable(meshes, policy="nnz_balance")
    c0 = obs.counter("router.assigned", mesh="b").value
    spec = table.assign("k", mat, mesh="b")          # explicit pin
    assert spec.name == "b" and table.mesh_of("k").name == "b"
    assert obs.counter("router.assigned", mesh="b").value == c0 + 1
    assert obs.gauge("router.keys", mesh="b").value == 1
    with pytest.raises(ValueError):                  # no silent re-place
        table.assign("k", mat)
    with pytest.raises(KeyError):
        table.assign("k2", mat, mesh="nope")
    snap = table.snapshot()
    assert snap["assignments"] == {"k": "b"}
    assert snap["loads"]["b"]["nnz"] == mat.nnz
    table.remove("k", mat)
    assert snap["loads"]["b"]["keys"] == 1           # snapshot is a copy
    assert table.snapshot()["loads"]["b"] \
        == {"keys": 0, "nnz": 0, "est_bytes": 0}
    assert obs.gauge("router.keys", mesh="b").value == 0
    table.remove("ghost")                            # unknown: a no-op
    with pytest.raises(KeyError):
        table.mesh_of("k")
    with pytest.raises(ValueError):
        RoutingTable([], policy="bin_pack")
    with pytest.raises(ValueError):
        RoutingTable([meshes[0], meshes[0]])         # duplicate names


def test_assign_runs_under_its_span():
    mat = port_mat(RG.banded(64, 2, seed=7))
    table = RoutingTable([MeshSpec("a", Topology(devices=2))])
    with obs.tracing() as buf:
        table.assign("k", mat)
    ev = [e for e in buf.flush() if e["name"] == "router.assign"]
    assert len(ev) == 1
    assert ev[0]["args"]["mesh"] == "a"
    assert ev[0]["args"]["policy"] == "bin_pack"


def test_per_device_budget_bounds_every_device():
    mats = {"a": port_mat(RG.banded(256, 4, seed=8)),
            "b": port_mat(RG.banded(256, 4, seed=9))}
    with RoutedSpmvService([MeshSpec("m", Topology(devices=2))],
                           **KW) as rt:
        rt.register("a", mats["a"])
        rt.operator("a")
        need = max(rt.stats()["per_mesh"]["m"]["per_device_bytes"])
    budget = int(need * 1.5)                 # one operator fits, two don't
    mesh = MeshSpec("m", Topology(devices=2), budget_per_device=budget)
    with RoutedSpmvService([mesh], **KW) as rt:
        for k, m in mats.items():
            rt.register(k, m)
        for k in mats:
            assert _close(rt.submit(k, _x(256)).result(timeout=60),
                          mats[k], _x(256))
        st = rt.stats()
        assert st["evictions"] >= 1          # the LRU had to make room
        assert st["per_device_ok"]
        assert all(b <= budget for b
                   in st["per_mesh"]["m"]["per_device_bytes"])
        # the evicted key still serves (zero-re-tune reload)
        for k in mats:
            assert _close(rt.submit(k, _x(256, 1)).result(timeout=60),
                          mats[k], _x(256, 1))
        svc = rt.stats()["per_mesh"]["m"]["service"]
        assert svc["op_reloads"] >= 1
        # the transient bound: the high-water mark, not only the snapshot
        assert svc["resident_bytes_max"] <= svc["memory_budget_bytes"] \
            == budget * 2


def test_background_replan_keeps_siblings_serving():
    a = port_mat(RG.banded(128, 4, seed=10))
    b = port_mat(RG.banded(128, 4, seed=11))
    b2 = port_mat(RG.banded(128, 6, seed=12))   # new structure for b
    mesh = MeshSpec("m", Topology(devices=2))
    with RoutedSpmvService([mesh], **KW) as rt:
        rt.register("a", a, mesh="m")
        rt.register("b", b, mesh="m")
        rt.operator("a")
        rt.operator("b")
        fut = rt.update_structure("b", mat=b2)
        # the sibling keeps serving while b replans in the background
        assert _close(rt.submit("a", _x(128)).result(timeout=60),
                      a, _x(128))
        gen = fut.result(timeout=120)
        assert isinstance(gen, int)
        st = rt.stats()
        assert st["replans"] == 1 and st["replan_errors"] == 0
        # b now serves the NEW structure
        assert _close(rt.submit("b", _x(128, 2)).result(timeout=60),
                      b2, _x(128, 2))
        # and a was never touched
        assert _close(rt.submit("a", _x(128, 3)).result(timeout=60),
                      a, _x(128, 3))


def test_routed_delta_applies_without_full_replan():
    mat = port_mat(RG.banded(128, 4, seed=13))
    rows = np.repeat(np.arange(128, dtype=np.int64),
                     np.diff(mat.rowptr.astype(np.int64)))
    d = StructureDelta(del_rows=rows[:3],
                       del_cols=mat.cols.astype(np.int64)[:3])
    new_mat = d.apply_to(mat)
    mesh = MeshSpec("m", Topology(devices=2))
    with RoutedSpmvService([mesh], **KW) as rt:
        rt.register("k", mat)
        rt.operator("k")
        applies0 = obs.counter("delta.applies").value
        fallbacks0 = obs.counter("delta.fallbacks").value
        rt.update_structure("k", delta=d).result(timeout=120)
        assert obs.counter("delta.applies").value == applies0 + 1
        assert obs.counter("delta.fallbacks").value == fallbacks0
        assert rt.stats()["replans"] == 1
        assert _close(rt.submit("k", _x(128, 4)).result(timeout=60),
                      new_mat, _x(128, 4))
    with pytest.raises(BadRequest):          # exactly one of mat=/delta=
        rt2 = RoutedSpmvService([MeshSpec("m", Topology(devices=1))],
                                device="cpu")
        try:
            rt2.register("k", mat)
            rt2.update_structure("k")
        finally:
            rt2.close()


def test_routed_value_swap_on_a_sharded_key():
    """update_values on a sharded key: a sharded Plan.rebuild under the
    frozen split (no replan), answers follow the new values, the sibling
    keeps its own."""
    a = port_mat(RG.banded(256, 4, seed=14))
    b = port_mat(RG.banded(256, 4, seed=15))
    mesh = MeshSpec("m", Topology(devices=4))
    with RoutedSpmvService([mesh], reorder="rcm", **KW) as rt:
        rt.register("a", a)
        rt.register("b", b)
        op0 = rt.operator("a")
        rt.operator("b")
        vals = np.random.default_rng(16).uniform(-1.0, 1.0, a.nnz)
        rt.update_values("a", vals)
        new = CSRMatrix(rowptr=a.rowptr, cols=a.cols, vals=vals,
                        shape=a.shape)
        op1 = rt.operator("a")
        assert op1 is not op0 and op1.simulated
        assert op1.build_info.get("value_swap")
        np.testing.assert_array_equal(op1.plan.panel_starts,
                                      op0.plan.panel_starts)
        x = _x(256, 5)
        assert _rel(rt.submit("a", x).result(timeout=60),
                    new.spmv(x)) <= F32_TOL
        assert _rel(rt.submit("b", x).result(timeout=60),
                    b.spmv(x)) <= F32_TOL
        st = rt.stats()
        assert (st["value_swaps"], st["replans"]) == (1, 0)
        with pytest.raises(BadRequest):      # wrong length
            rt.update_values("a", vals[:-1])


def test_unrouted_key_raises():
    with RoutedSpmvService([MeshSpec("m", Topology(devices=1))],
                           device="cpu") as rt:
        with pytest.raises(UnregisteredKey):
            rt.operator("ghost")
        with pytest.raises(UnregisteredKey):
            rt.update_values("ghost", np.ones(3))
        with pytest.raises(KeyError):
            rt.submit("ghost", _x(8))
        with pytest.raises(KeyError):
            rt.mesh_of("ghost")


def test_pinned_mesh_and_refused_register_leave_the_ledger_clean():
    mat = port_mat(RG.banded(128, 4, seed=17))
    meshes = [MeshSpec("a", Topology(devices=2)),
              MeshSpec("b", Topology(devices=2))]
    rt = RoutedSpmvService(meshes, policy="nnz_balance", device="cpu",
                           max_batch=2, window_ms=1.0)
    try:
        assert rt.register("k", mat, mesh="b").name == "b"
        assert rt.mesh_of("k").name == "b"
        y = rt.submit("k", _x(128)).result(timeout=60)
        assert _close(y, mat, _x(128))
        with pytest.raises(KeyError):
            rt.register("k2", mat, mesh="nope")
        assert "k2" not in rt.stats()["routing"]["assignments"]
        # the owning mesh's service refuses: the key leaves the table
        rt._services["a"].close()
        with pytest.raises(ServiceClosed):
            rt.register("k3", mat, mesh="a")
        snap = rt.stats()["routing"]
        assert snap["assignments"] == {"k": "b"}
        assert snap["loads"]["a"] == {"keys": 0, "nnz": 0, "est_bytes": 0}
    finally:
        rt.close()
    rt.close()                               # idempotent


def test_router_stats_and_dispatch_counters():
    mat = port_mat(RG.banded(128, 4, seed=18))
    meshes = [MeshSpec("a", Topology(devices=2), budget_per_device=1 << 30),
              MeshSpec("b", Topology(devices=2))]
    with RoutedSpmvService(meshes, policy="nnz_balance", **KW) as rt:
        rt.register("k0", mat)
        rt.register("k1", mat)
        c0 = obs.counter("router.requests", mesh="a").value
        with obs.tracing() as buf:
            futs = [rt.submit("k0", _x(128, i)) for i in range(3)]
        for f in futs:
            f.result(timeout=60)
        rt.flush()
        st = rt.stats()
    spans = [e for e in buf.flush() if e["name"] == "router.dispatch"]
    assert len(spans) == 3 and spans[0]["args"]["mesh"] == "a"
    assert obs.counter("router.requests", mesh="a").value == c0 + 3
    assert st["routing"]["assignments"] == {"k0": "a", "k1": "b"}
    assert st["requests"] == st["results"] == 3 and st["pending"] == 0
    assert st["per_device_ok"]
    assert st["per_mesh"]["a"]["devices"] == 2
    assert st["per_mesh"]["a"]["budget_per_device"] == 1 << 30
    assert len(st["per_mesh"]["a"]["per_device_bytes"]) == 2
    assert st["per_mesh"]["b"]["per_device_bytes"] == [0]    # k1 unbuilt


def test_router_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meshes = [MeshSpec("m", Topology(devices=2))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoutedSpmvService(meshes)
    with RoutedSpmvService(meshes, device="cpu") as rt:
        assert rt.device.type == "cpu"
        assert all(s.device.type == "cpu" for s in rt._services.values())


# -- the route cell kind ----------------------------------------------------
def test_route_variant_roundtrips_and_elides_defaults():
    assert cells.route_variant() == "poisson"        # all defaults elided
    v = cells.route_variant(rate_rps=600, requests=120, n_keys=4,
                            structure_frac=0.08, devices=4,
                            policy="comm_aware", budget_mb=2.0,
                            window_ms=1.0)
    cfg = cells._parse_route_variant(v)
    assert cfg["rate_rps"] == 600 and cfg["requests"] == 120
    assert cfg["n_keys"] == 4 and cfg["structure_frac"] == 0.08
    assert cfg["devices"] == 4 and cfg["policy"] == "comm_aware"
    assert cfg["budget_mb"] == 2.0 and cfg["window_ms"] == 1.0
    assert cfg["meshes"] == 2 and cfg["layout"] == "1d_rows"  # defaults
    with pytest.raises(ValueError, match="unknown route-variant token"):
        cells._parse_route_variant("poisson,q17")


def test_route_cell_through_the_runner_and_its_store():
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)

    spec = ExperimentSpec(
        name="route_t", matrices=("smoke_banded",), schemes=("baseline",),
        ks=(4,), kind="route",
        variants=(cells.route_variant(rate_rps=2000, requests=40,
                                      n_keys=3, update_frac=0.1,
                                      structure_frac=0.1, devices=2,
                                      policy="nnz_balance"),),
        policy=MeasurePolicy(iters=1, warmup=0, with_yax=False,
                             with_parallel=False, with_metrics=False))
    store = ResultStore()
    rep = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert not rep.failures
    rec = rep.records[0]
    assert rec["placement"] == "nnz_balance" and rec["devices"] == 2
    assert len(set(rec["assignments"].values())) == 2
    assert rec["unresolved"] == rec["errors"] == 0
    assert rec["per_device_ok"] and rec["budget_ok"]
    assert rec["counters_balanced"]
    assert rec["replans_landed"] == rec["structure_updates"]
    assert set(rec["launches"]) >= {"sell_spmv", "sell_spmm"}
    from repro_torch.bench import run as bench_run
    assert bench_run.route_invariants(rec) == []
    # every key of the reference's record, beside the port's launches
    want = {"m", "n", "nnz", "offered", "submitted", "ok", "shed",
            "rejected", "errors", "unresolved", "updates",
            "update_conflicts", "structure_updates", "structure_conflicts",
            "replans_landed", "replan_errors", "replan_unresolved",
            "offered_rps", "achieved_rps", "wall_s", "devices", "meshes",
            "layout", "placement", "budget_per_device", "per_device_ok",
            "budget_ok", "replans", "value_swaps", "evictions",
            "assignments", "counters_balanced", "launches"}
    assert want <= set(rec)
    rep2 = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert rep2.measured == 0 and rep2.reused == 1


def test_route_invariants_catch_each_fault():
    from repro_torch.bench import run as bench_run

    good = {"unresolved": 0, "replan_unresolved": 0, "errors": 0,
            "replan_errors": 0, "per_device_ok": True, "budget_ok": True,
            "counters_balanced": True, "structure_updates": 2,
            "replans_landed": 2, "placement": "comm_aware",
            "assignments": {"a": "m0", "b": "m1"}}
    assert bench_run.route_invariants(good) == []
    for fault in ({"unresolved": 1}, {"replan_errors": 1},
                  {"per_device_ok": False}, {"budget_ok": False},
                  {"counters_balanced": False}, {"replans_landed": 1},
                  {"assignments": {"a": "m0", "b": "m0"}}):
        assert len(bench_run.route_invariants({**good, **fault})) == 1
    # bin_pack may pack one mesh
    assert bench_run.route_invariants(
        {**good, "placement": "bin_pack",
         "assignments": {"a": "m0", "b": "m0"}}) == []
    assert bench_run.sibling_p99_flat(10.0, 100.0)
    assert not bench_run.sibling_p99_flat(10.0, 100.5)
    assert bench_run.p99(list(range(100))) == 99
    assert bench_run.p99([3.0, 1.0, 2.0]) == 3.0


# -- the CLI ----------------------------------------------------------------
def _lines(out, tag):
    return [ln for ln in out.splitlines() if ln.startswith(tag)]


def test_cli_fresh_measures_again(capsys):
    from repro_torch.launch import spmv_bench

    par = ["--matrix", "smoke_banded", "--scheme", "rcm", "--devices", "2",
           "--iters", "2", "--device", "cpu"]
    for argv in (par, par, par + ["--fresh"]):
        spmv_bench.main(argv)
    lines = _lines(capsys.readouterr().out, "[spmv-parallel]")
    assert ["store_hit=True" in ln for ln in lines] == [False, True, False]
    # a single cell is a Runner cell: the repeat is a result-store hit,
    # --fresh deletes the record and measures again (the reference's
    # run_single contract)
    one = ["--matrix", "smoke_banded", "--scheme", "rcm", "--iters", "2",
           "--device", "cpu"]
    for argv in (one, one, one + ["--fresh"]):
        spmv_bench.main(argv)
    lines = _lines(capsys.readouterr().out, "[spmv-single]")
    assert ["store_hit=True" in ln for ln in lines] == [False, True, False]


def test_cli_probe_and_learned_reach_plan(capsys, monkeypatch):
    from repro_torch.core.spmv import plan as plan_mod
    from repro_torch.launch import spmv_bench

    seen = []
    real = plan_mod.plan

    def spy(*a, **kw):
        seen.append(kw.get("probe"))
        return real(*a, **kw)

    # the single cell plans inside the spmv cell kind, from plan_mod
    monkeypatch.setattr(plan_mod, "plan", spy)
    base = ["--matrix", "smoke_banded", "--iters", "2", "--device", "cpu"]
    spmv_bench.main(base + ["--probe"])
    spmv_bench.main(base + ["--learned"])
    spmv_bench.main(base)
    assert seen == [True, "learned", False]
    lines = _lines(capsys.readouterr().out, "[spmv-single]")
    assert "probe=True" in lines[0] and "probe=learned" in lines[1]
    for bad in (base + ["--probe", "--learned"],
                base + ["--devices", "2", "--probe"],
                ["--serve-traffic", "--learned", "--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            spmv_bench.main(bad)
        assert e.value.code == 2


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_cli_trace_writes_a_valid_trace(tmp_path, capsys, suffix):
    import json

    from repro_torch.launch import spmv_bench
    from repro_torch.obs.export import validate_chrome_trace

    path = str(tmp_path / f"trace{suffix}")
    spmv_bench.main(["--serve-traffic", "--matrix", "smoke_banded",
                     "--devices", "2", "--requests", "12", "--rate",
                     "2000", "--keys", "2", "--device", "cpu",
                     "--trace", path])
    assert f"-> {path}" in capsys.readouterr().out
    if suffix == ".jsonl":
        with open(path) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
    else:
        events = [e for e in validate_chrome_trace(path) if e["ph"] == "B"]
    names = {e["name"] for e in events}
    assert {"router.assign", "router.dispatch", "serve.dispatch"} <= names


def test_cli_campaign_route_passes_and_resumes(capsys):
    """bench.run --smoke-route (the router soak) passes and resumes, and
    writes the reference's CSV header and summary keys."""
    import csv
    import json
    import os

    from repro_torch.bench import run as bench_run

    with pytest.raises(SystemExit) as e:
        bench_run.main(["--smoke-route", "--device", "cpu"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert "ROUTE INVARIANT FAILED" not in out
    assert "# sibling p99:" in out and "# delta-vs-replan:" in out
    assert "# resume: 2/2 cells served from the store" in out
    res = os.environ["REPRO_TORCH_RESULTS_DIR"]
    with open(os.path.join(res, bench_run.SMOKE_ROUTE_CSV)) as f:
        rows = list(csv.reader(f))
    assert rows[0] == bench_run.SMOKE_ROUTE_HEADER and len(rows) == 3
    with open(os.path.join(res, bench_run.ROUTE_SUMMARY_NAME)) as f:
        summary = json.load(f)
    assert set(summary) == {"failures", "cells", "records"}
    assert summary["failures"] == 0 and summary["cells"] == 2


def test_campaign_route_counts_a_broken_invariant(monkeypatch, capsys):
    """A fleet that reports a device over its budget fails the soak
    (and stops it before the resume)."""
    from repro_torch.bench import run as bench_run
    from repro_torch.router import service

    real = service.RoutedSpmvService.stats

    def over(self):
        return {**real(self), "per_device_ok": False}

    monkeypatch.setattr(service.RoutedSpmvService, "stats", over)
    assert bench_run.smoke_route(device="cpu") == 2
    out = capsys.readouterr().out
    assert out.count("ROUTE INVARIANT FAILED") == 2
    assert "# resume" not in out


def test_concurrent_register_submit_keeps_the_ledger_whole():
    """More threads than cores register, serve, swap values on and remove
    keys of one fleet at once, under a short switch interval: every
    Future resolves, the counters balance and the ledger's loads are the
    sum of what stayed registered."""
    import sys
    import threading

    mats = [port_mat(RG.banded(64, 2 + (i % 3), seed=30 + i))
            for i in range(12)]
    meshes = [MeshSpec(f"m{i}", Topology(devices=1 + (i % 2)))
              for i in range(3)]
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with RoutedSpmvService(meshes, policy="nnz_balance",
                               **KW) as rt:
            def work(i):
                try:
                    key = f"k{i}"
                    rt.register(key, mats[i])
                    rt.operator(key)    # planned: the swap rebuilds it
                    futs = [rt.submit(key, _x(64, j)) for j in range(4)]
                    rt.update_values(key, mats[i].vals * 2.0)
                    for f in futs:
                        f.result(timeout=60)
                    y = rt.submit(key, _x(64, 9)).result(timeout=60)
                    assert _rel(y, 2.0 * mats[i].spmv(_x(64, 9))) <= F32_TOL
                except Exception as e:          # reported below
                    errors.append(e)

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(len(mats))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            rt.flush()
            st = rt.stats()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert st["requests"] == st["results"] == 5 * len(mats)
    assert st["pending"] == 0 and st["value_swaps"] == len(mats)
    loads = st["routing"]["loads"]
    assert sum(v["keys"] for v in loads.values()) == len(mats)
    assert sum(v["nnz"] for v in loads.values()) == \
        sum(m.nnz for m in mats)
    assert sum(v["est_bytes"] for v in loads.values()) == \
        sum(estimate_nbytes(m) for m in mats)
