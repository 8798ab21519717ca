"""The port's sharded plans (core/spmv/{topology,distributed}.py, the
sharded half of plan.py) against the JAX package's, on the CPU.

The same matrices (a shuffled band of 4096 rows, random_uniform 2048, a
power-law smoke matrix), built by the JAX package's generators and handed
to both packages as the same arrays, go through both planners at p = 4
and 8:

- Topology, comm_model dicts, panel_starts, the composed permutations,
  build_sharded_layout's arrays and maps, and the plan decisions (scheme,
  engine, partitioner, costs) are the reference's, bit for bit;
- ShardedOperator products for each layout x engine x schedule
  (all_gather, halo, psum) agree with the reference's simulated
  ShardedOperator within 1e-5 relative in f32 and with the f64 oracle
  (1e-5 in f32, 1e-12 in f64; the f64 reference within 1e-12 too);
- the mesh path, on [cpu] * p, equals the simulated path (bit for bit
  for csr, whose CPU index_add_ adds in the same order; within 1e-6
  relative for bell);
- the cases of the reference's tests/test_topology_plans.py and the
  facade/halo cases of tests/test_distributed_spmv.py: keys, the store,
  partitioners (a custom one too), bad requests, CG, the "parallel"
  campaign and its resume, a sharded service key, the same-shape delta
  rule, per-device bytes, conversion from the reference and the CLI.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.core.spmv import distributed as rdist
from repro.core.spmv import opcache as ropcache
from repro.core.spmv import topology as rtopo
from repro.matrices import generators as RG
from repro_torch import api
from repro_torch import convert
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv import distributed as dist
from repro_torch.core.spmv import opcache
from repro_torch.core.spmv import topology as topo_mod
from repro_torch.core.spmv.topology import Topology

torch.set_num_threads(1)

F32_TOL = 1e-5
F64_TOL = 1e-12
MESH_TOL = 1e-6


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


_MATS = {}
_BUILDERS = {
    "banded": lambda: RG.shuffle(RG.banded(4096, 6, seed=0), seed=1),
    "uniform": lambda: RG.random_uniform(2048, 8, seed=2),
    "powerlaw": lambda: RG.power_law(1024, alpha=1.9, seed=6),
}
MATRICES = tuple(_BUILDERS)


def pair(name):
    """(reference matrix, the same arrays as the port's CSRMatrix)."""
    if name not in _MATS:
        rm = _BUILDERS[name]()
        _MATS[name] = (rm, port_mat(rm))
    return _MATS[name]


def port_mat(rm):
    return CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                     shape=rm.shape)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-300)


def _x(n, k=0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, k) if k else n)


def _oracle(mat, x):
    if x.ndim == 1:
        return mat.spmv(x)
    return np.stack([mat.spmv(x[:, j]) for j in range(x.shape[1])], axis=1)


def _plans(name, scheme, engine, devices, layout, partition, dtype=None):
    """The reference's plan and the port's for the same request."""
    rm, pm = pair(name)
    want = rapi.plan(rapi.SpmvProblem(rm, dtype=dtype), reorder=scheme,
                     engine=engine,
                     topology=rapi.Topology(devices=devices, layout=layout),
                     partition=partition)
    got = api.plan(api.SpmvProblem(pm, dtype=dtype), reorder=scheme,
                   engine=engine,
                   topology=Topology(devices=devices, layout=layout),
                   partition=partition)
    return want, got


def _same_decision(want, got):
    assert got.scheme == want.scheme
    assert got.tune.engine == want.tune.engine
    assert got.tune.block_shape == tuple(want.tune.block_shape)
    assert got.partitioner == want.partitioner
    assert got.topology.to_json() == want.topology.to_json()
    assert got.comm == want.comm
    assert got.partition_costs == want.partition_costs
    assert got.scheme_costs == want.scheme_costs
    assert got.label() == want.label()
    assert got.k == want.k
    np.testing.assert_array_equal(got.panel_starts, want.panel_starts)
    assert got.panel_starts.dtype == np.int64
    if want.perm is None:
        assert got.perm is None
    else:
        np.testing.assert_array_equal(got.perm, want.perm)


# -- Topology and the comm model --------------------------------------------
def test_topology_validation():
    assert Topology(devices=1).trivial
    t = Topology(devices=8, layout="2d_panels")
    assert t.mesh_shape == (4, 2) and t.mesh_axes == ("data", "model")
    assert Topology(devices=6, layout="1d_rows").mesh_shape == (6,)
    for bad in (dict(devices=0), dict(devices=4, layout="3d_torus"),
                dict(devices=4, layout="2d_panels", mesh_shape=(3, 2)),
                dict(devices=4, layout="1d_rows", mesh_shape=(2, 2))):
        with pytest.raises(ValueError):
            Topology(**bad)
    assert Topology.from_json(t.to_json()) == t
    assert topo_mod.normalize(None) is None
    assert topo_mod.normalize(Topology(devices=1)) is None
    assert topo_mod.normalize(t.to_json()) == t
    with pytest.raises(TypeError):
        topo_mod.normalize(object())


@pytest.mark.parametrize("devices,layout,shape", [
    (1, "1d_rows", ()), (4, "1d_rows", ()), (8, "1d_rows", ()),
    (8, "2d_panels", ()), (12, "2d_panels", ()), (6, "2d_panels", (2, 3)),
    (7, "2d_panels", ())])
def test_topology_is_the_references(devices, layout, shape):
    got = Topology(devices=devices, layout=layout, mesh_shape=shape)
    want = rtopo.Topology(devices=devices, layout=layout, mesh_shape=shape)
    assert got.to_json() == want.to_json()
    assert got.key_dict() == want.key_dict()
    assert (got.row_devices, got.col_devices, got.trivial) == \
        (want.row_devices, want.col_devices, want.trivial)


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("layout", ["1d_rows", "2d_panels"])
@pytest.mark.parametrize("scheme", ["baseline", "rcm"])
@pytest.mark.parametrize("name", MATRICES)
def test_comm_model_is_the_references(name, scheme, layout, p):
    from repro.core.reorder import api as rreorder
    from repro.core.sparse import partition as rpartition
    from repro_torch.core.sparse import partition

    rm, pm = pair(name)
    if scheme != "baseline":
        perm = rreorder.reorder(rm, scheme, 0, cache=False)
        rm, pm = rm.permute(perm), pm.permute(perm)
    t, rt = (Topology(devices=p, layout=layout),
             rtopo.Topology(devices=p, layout=layout))
    for pname in ("static", "nnz_balanced"):
        starts = partition.resolve_partitioner(pname)[1](pm, t.row_devices)[1]
        np.testing.assert_array_equal(
            starts,
            rpartition.resolve_partitioner(pname)[1](rm, rt.row_devices)[1])
        for k in (1, 8):
            want = rtopo.comm_model(rm, starts, rt, 4, k, (8, 128))
            got = topo_mod.comm_model(pm, starts, t, 4, k, (8, 128))
            assert got == want
            assert topo_mod.padded_panel_rows(starts, 8, 128,
                                              t.col_devices) == \
                rtopo.padded_panel_rows(starts, 8, 128, rt.col_devices)


# -- content keys --------------------------------------------------------------
def test_one_device_topology_key_equals_plain_key():
    _, mat = pair("banded")
    p = api.SpmvProblem(mat)
    k_plain = api.plan_key(p, "rcm", "csr", False, 0)
    k_triv = api.plan_key(p, "rcm", "csr", False, 0,
                          topology=Topology(devices=1))
    assert k_plain == k_triv
    pl = api.plan(p, reorder="rcm", engine="csr",
                  topology=Topology(devices=1))
    assert pl.topology is None and pl.key == k_plain
    # and the stored entry is shared: a plain plan() re-request hits it
    pl2 = api.plan(p, reorder="rcm", engine="csr")
    assert pl2.cache_hit and pl2.key == pl.key


def test_sharded_key_normalizes_probe():
    _, mat = pair("banded")
    p = api.SpmvProblem(mat)
    topo = Topology(devices=4)
    kw = dict(topology=topo, partition="static", partitioners=["static"])
    assert api.plan_key(p, "rcm", "csr", False, 0, **kw) == \
        api.plan_key(p, "rcm", "csr", True, 0, **kw)
    assert api.plan_key(p, "rcm", "csr", True, 0) != \
        api.plan_key(p, "rcm", "csr", False, 0)
    # a probe=True request builds the identical plan: one entry
    a = api.plan(p, reorder="rcm", engine="csr", topology=topo,
                 partition="static")
    b = api.plan(p, reorder="rcm", engine="csr", topology=topo,
                 partition="static", probe=True)
    assert b.cache_hit and b.key == a.key and b.probe is False


def test_topology_and_partition_are_key_relevant():
    _, mat = pair("banded")
    p = api.SpmvProblem(mat)
    base = api.plan_key(p, "rcm", "csr", False, 0)
    keys = {
        api.plan_key(p, "rcm", "csr", False, 0, topology=Topology(devices=n,
                     layout=lay), partition=part, partitioners=[part])
        for n, lay, part in ((4, "1d_rows", "static"),
                             (8, "1d_rows", "static"),
                             (8, "2d_panels", "static"),
                             (8, "1d_rows", "nnz_balanced"))}
    assert len(keys) == 4 and base not in keys


# -- partitioners ------------------------------------------------------------
def test_partitioner_registry_builtins():
    reg = api.PARTITIONER_REGISTRY
    for name in ("static", "nnz_balanced", "chunked_cyclic", "metis_cut"):
        assert name in reg
    assert reg["static"].auto_candidate and reg["nnz_balanced"].auto_candidate
    assert not reg["chunked_cyclic"].auto_candidate
    assert reg["metis_cut"].reorders
    with pytest.raises(ValueError):
        @api.register_partitioner("static")
        def _dup(mat, p, seed=0):           # pragma: no cover
            return None, None


@pytest.fixture()
def reversed_static():
    """A plugin partitioner, registered for one test and removed after it
    (the registry is process-wide; other files compare it to repro's)."""
    name = "test_torch_reversed_static"

    @api.register_partitioner(name, description="test plugin")
    def _reversed_static(mat, p, seed=0):
        from repro_torch.core.sparse.partition import static_partition

        return (np.arange(mat.m - 1, -1, -1, dtype=np.int64),
                static_partition(mat, p))

    yield name
    del api.PARTITIONER_REGISTRY[name]


def test_custom_partitioner_participates_in_planning(reversed_static):
    name = reversed_static
    rm, mat = pair("powerlaw")
    pl = api.plan(api.SpmvProblem(mat), reorder="baseline", engine="csr",
                  topology=Topology(devices=4), partition=name)
    assert pl.partitioner == name
    np.testing.assert_array_equal(pl.perm, np.arange(mat.m)[::-1])
    op = pl.build(device="cpu")
    x = _x(mat.n)
    assert _rel(op(torch.as_tensor(x)), mat.spmv(x)) < F64_TOL
    # and wins partition="auto" alongside the built-ins when offered
    pl2 = api.plan(api.SpmvProblem(mat), reorder="baseline", engine="csr",
                   topology=Topology(devices=4),
                   partition=[name, "static"])
    assert set(k.split("+")[1] for k in pl2.partition_costs) == \
        {name, "static"}


@pytest.mark.parametrize("partition", ["static", "nnz_balanced",
                                       "chunked_cyclic_c16", "metis_cut"])
def test_every_partitioner_plans_and_executes(partition):
    want, got = _plans("powerlaw", "baseline", "csr", 4, "1d_rows",
                       partition)
    _same_decision(want, got)
    assert got.partitioner == partition and got.panel_starts.size == 5
    rm, pm = pair("powerlaw")
    x = _x(pm.n)
    y = got.build(device="cpu")(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y, pm.spmv(x)) < F32_TOL
    assert _rel(y, want.build()(jnp.asarray(x, jnp.float32))) < F32_TOL


def test_joint_partition_selection_prefers_balance_on_skew():
    rm = RG.power_law(512, alpha=1.6, seed=0)
    mat = port_mat(rm)
    pl = api.plan(api.SpmvProblem(mat), reorder="baseline", engine="csr",
                  topology=Topology(devices=8), partition="auto")
    assert pl.partitioner == "nnz_balanced", pl.partition_costs
    assert any(k.startswith("baseline+static") for k in pl.partition_costs)
    from repro_torch.core.sparse.partition import nnz_balanced_partition

    np.testing.assert_array_equal(
        pl.panel_starts, nnz_balanced_partition(pl.reordered_matrix(), 8))
    want = rapi.plan(rapi.SpmvProblem(rm), reorder="baseline",
                     engine="csr", topology=rapi.Topology(devices=8),
                     partition="auto")
    _same_decision(want, pl)


def test_sharded_plan_rejects_bad_requests():
    _, mat = pair("powerlaw")
    with pytest.raises(ValueError, match="'bell' or 'csr'"):
        api.plan(api.SpmvProblem(mat), reorder="baseline", engine="sell",
                 topology=Topology(devices=4))
    rect = CSRMatrix(rowptr=mat.rowptr[:65], cols=np.minimum(
        mat.cols[:mat.rowptr[64]], 127), vals=mat.vals[:mat.rowptr[64]],
        shape=(64, 128))
    with pytest.raises(ValueError, match="square"):
        api.plan(api.SpmvProblem(rect), reorder="baseline",
                 topology=Topology(devices=4))
    with pytest.raises(KeyError):
        api.plan(api.SpmvProblem(mat), reorder="baseline",
                 topology=Topology(devices=4), partition="nope")
    with pytest.raises(ValueError, match="bell'/'csr"):
        dist.build_sharded_layout(mat, Topology(devices=4),
                                  np.array([0, 256, 512, 768, 1024]),
                                  engine="sell")


# -- plan decisions, layouts and products against the reference ----------------
@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("layout", ["1d_rows", "2d_panels"])
@pytest.mark.parametrize("name", MATRICES)
def test_plan_decisions_are_the_references(name, layout, p):
    """reorder="auto" over {baseline, rcm} x partition="auto" x engine
    "auto": the joint argmin, its costs and the composed permutation."""
    rm, pm = pair(name)
    hints = {"schemes": ["baseline", "rcm"]}
    want = rapi.plan(rapi.SpmvProblem(rm, k=4, hints=hints), reorder="auto",
                     topology=rapi.Topology(devices=p, layout=layout),
                     partition="auto")
    got = api.plan(api.SpmvProblem(pm, k=4, hints=hints), reorder="auto",
                   topology=Topology(devices=p, layout=layout),
                   partition="auto")
    _same_decision(want, got)
    assert set(got.scheme_costs) == {"baseline", "rcm"}
    assert len(got.partition_costs) == 2 * 2 * 2


@pytest.mark.parametrize("partition", ["chunked_cyclic_c16", "metis_cut"])
@pytest.mark.parametrize("scheme", ["baseline", "rcm"])
def test_composed_permutation_is_the_references(scheme, partition):
    """A reordering partitioner composes its grouping with the scheme's
    permutation: perm_total = perm[perm2]."""
    want, got = _plans("banded", scheme, "csr", 8, "1d_rows", partition)
    _same_decision(want, got)
    assert got.perm is not None


LAYOUT_CASES = [("1d_rows", "all_gather"), ("1d_rows", "halo"),
                ("2d_panels", "psum")]


def _layouts(layout, schedule, engine, p):
    """build_sharded_layout of both packages on the RCM order of the
    shuffled band (where the halo is legal), nnz-balanced panels."""
    from repro.core.reorder import api as rreorder
    from repro_torch.core.sparse import partition

    rm, pm = pair("banded")
    perm = rreorder.reorder(rm, "rcm", 0, cache=False)
    rm, pm = rm.permute(perm), pm.permute(perm)
    t = Topology(devices=p, layout=layout)
    rt = rtopo.Topology(devices=p, layout=layout)
    starts = partition.nnz_balanced_partition(pm, t.row_devices)
    comm = topo_mod.comm_model(pm, starts, t, 4, 1, (8, 128))
    # the comm model picks the halo here; the all-gather is always legal
    assert comm["schedule"] == ("psum" if layout == "2d_panels" else "halo")
    kw = dict(engine=engine, block_shape=(8, 128), schedule=schedule,
              halo=comm["halo"])
    return (rdist.build_sharded_layout(rm, rt, starts, **kw),
            dist.build_sharded_layout(pm, t, starts, **kw), rm, pm)


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("engine", ["bell", "csr"])
@pytest.mark.parametrize("layout,schedule", LAYOUT_CASES)
def test_layout_arrays_are_the_references(layout, schedule, engine, p):
    want, got, _, _ = _layouts(layout, schedule, engine, p)
    assert sorted(got.arrays) == sorted(want.arrays)
    for key, arr in want.arrays.items():
        assert got.arrays[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got.arrays[key], arr)
    for field in ("padmap", "pad_idx", "panel_starts"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for field in ("engine", "shape", "schedule", "halo", "h_pad", "n_pad",
                  "seg_n", "block_shape"):
        assert getattr(got, field) == getattr(want, field), field
    if schedule == "halo":
        assert got.halo > 0


@pytest.mark.parametrize("engine", ["bell", "csr"])
@pytest.mark.parametrize("layout,schedule", LAYOUT_CASES)
def test_sharded_operator_matches_the_reference(layout, schedule, engine):
    """f32: the port's simulated ShardedOperator against the reference's,
    in the original space (SpMV and SpMM), in the permuted space and
    through unwrap(); then the mesh path on [cpu] * p."""
    want_lay, got_lay, rm, pm = _layouts(layout, schedule, engine, 8)
    perm = np.random.default_rng(7).permutation(pm.m)  # a carried perm
    rop = rdist.ShardedOperator(want_lay, perm)
    op = dist.ShardedOperator(got_lay, perm, device="cpu",
                              dtype=torch.float32)
    assert op.simulated and op.topology.devices == 8
    np.testing.assert_array_equal(op.iperm[op.perm], np.arange(pm.m))
    # original space: x is gathered through perm and y scattered back,
    # so y[perm] = A @ x[perm] for the layout's matrix A
    for k in (0, 3):
        x = _x(pm.n, k, seed=k)
        call = op.matmul if k else op
        rcall = rop.matmul if k else rop
        y = call(torch.as_tensor(x, dtype=torch.float32))
        assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
        assert _rel(y, rcall(jnp.asarray(x, jnp.float32))) < F32_TOL
        want = np.empty_like(x)
        want[perm] = _oracle(pm, x[perm])
        assert _rel(y, want) < F32_TOL
    xr = _x(pm.n, seed=3)
    yr = op(torch.as_tensor(xr, dtype=torch.float32), permuted=True)
    assert _rel(yr, pm.spmv(xr)) < F32_TOL
    assert _rel(yr, rop(jnp.asarray(xr, jnp.float32), permuted=True)) \
        < F32_TOL
    assert torch.equal(op.unwrap()(torch.as_tensor(xr, dtype=torch.float32)),
                       yr)
    # the mesh path: one panel a device, the collective as copies
    op.mesh_devices = [torch.device("cpu")] * 8
    assert not op.simulated
    ym = op(torch.as_tensor(xr, dtype=torch.float32), permuted=True)
    if engine == "csr":
        assert torch.equal(ym, yr)
    assert _rel(ym, yr) < MESH_TOL
    Xr = _x(pm.n, 3, seed=4)
    Ym = op.matmul(torch.as_tensor(Xr, dtype=torch.float32), permuted=True)
    op.force_simulated = True
    assert op.simulated
    Ys = op.matmul(torch.as_tensor(Xr, dtype=torch.float32), permuted=True)
    assert _rel(Ym, Ys) < MESH_TOL


@pytest.mark.parametrize("engine", ["bell", "csr"])
@pytest.mark.parametrize("layout,schedule", LAYOUT_CASES)
def test_sharded_operator_f64_is_the_oracle(layout, schedule, engine):
    """f64 plans keep f64: within 1e-12 of the oracle and of the
    reference (run with x64 on), simulated and on the mesh path."""
    want_lay, got_lay, rm, pm = _layouts(layout, schedule, engine, 4)
    op = dist.ShardedOperator(got_lay, None, device="cpu",
                              dtype=torch.float64)
    x = _x(pm.n, seed=1)
    y = op(torch.as_tensor(x))
    assert y.dtype == torch.float64
    assert _rel(y, pm.spmv(x)) < F64_TOL
    with jax.enable_x64(True):
        ry = np.asarray(rdist.ShardedOperator(want_lay, None)(
            jnp.asarray(x, jnp.float64)))
    assert ry.dtype == np.float64 and _rel(y, ry) < F64_TOL
    op.mesh_devices = ["cpu"] * 4
    assert _rel(op(torch.as_tensor(x)), y) < F64_TOL


@pytest.mark.parametrize("layout", ["1d_rows", "2d_panels"])
@pytest.mark.parametrize("engine", ["bell", "csr"])
def test_sharded_plan_builds_the_references_operator(engine, layout):
    """Through the facade: the rcm plan on the shuffled band, built by
    both packages, gives the same layout and products; the halo schedule
    is the comm model's choice on 1d_rows."""
    want, got = _plans("banded", "rcm", engine, 8, layout, "nnz_balanced")
    _same_decision(want, got)
    if layout == "1d_rows":
        assert got.comm["schedule"] == "halo"
        assert got.comm["bytes_per_spmv"] < got.comm["gather_bytes"] / 4
    rop, op = want.build(), got.build(device="cpu")
    assert isinstance(op, api.ShardedOperator)
    assert op.build_info["comm"] == got.comm
    assert op.build_info["partitioner"] == "nnz_balanced"
    for key, arr in rop.layout.arrays.items():
        np.testing.assert_array_equal(op.layout.arrays[key], arr)
    _, pm = pair("banded")
    x = _x(pm.n, seed=2)
    y = op(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y, rop(jnp.asarray(x, jnp.float32))) < F32_TOL
    assert _rel(y, pm.spmv(x)) < F32_TOL


def test_sharded_plan_f64_through_the_facade():
    """The reference's 8-device facade case (rmat 512, f64, rcm,
    nnz_balanced) on the port: both layouts within 1e-12 of the dense
    oracle on the simulated and the mesh path, SpMM included."""
    rm = RG.rmat(9, 6, seed=0)
    pm = port_mat(rm)
    x, X = _x(pm.n, seed=1), _x(pm.n, 3, seed=1)
    dense = pm.to_dense()
    for layout in ("1d_rows", "2d_panels"):
        pl = api.plan(api.SpmvProblem(pm, dtype=np.float64), reorder="rcm",
                      topology=Topology(devices=8, layout=layout),
                      partition="nnz_balanced")
        assert pl.partitioner == "nnz_balanced" and pl.scheme == "rcm"
        op = pl.build(device="cpu")
        for mesh in (None, ["cpu"] * 8):
            op.mesh_devices = mesh
            assert _rel(op(torch.as_tensor(x)), dense @ x) < F64_TOL
            assert _rel(op.matmul(torch.as_tensor(X)), dense @ X) < F64_TOL


def test_sharded_spans_are_the_references():
    from repro import obs as robs
    from repro_torch import obs

    rm, pm = pair("powerlaw")
    x = _x(pm.n)
    req = dict(reorder="rcm", engine="csr", partition="static")
    with obs.tracing() as buf:
        op = api.plan(api.SpmvProblem(pm), topology=Topology(devices=4),
                      **req).build(device="cpu")
        op(torch.as_tensor(x, dtype=torch.float32))
    events = buf.flush()
    with robs.tracing() as rbuf:
        rop = rapi.plan(rapi.SpmvProblem(rm),
                        topology=rapi.Topology(devices=4), **req).build()
        rop(jnp.asarray(x, jnp.float32))
    names = {e["name"] for e in events}
    assert {"plan", "plan.build", "sharded.spmv", "sharded.gather_x",
            "sharded.exec", "sharded.scatter_y"} <= names
    assert names == {e["name"] for e in rbuf.flush()}
    assert all(e["args"]["backend"] == "torch" for e in events
               if e["name"].startswith(("plan", "sharded")))
    spmv = [e for e in events if e["name"] == "sharded.spmv"]
    assert spmv[0]["args"]["simulated"] and \
        spmv[0]["args"]["schedule"] == op.layout.schedule


# -- the store -----------------------------------------------------------------
def test_sharded_roundtrip_zero_retune():
    _, mat = pair("powerlaw")
    req = dict(reorder="rcm", engine="auto", topology=Topology(devices=8),
               partition="auto")
    pl = api.plan(api.SpmvProblem(mat, k=4), **req)
    op = pl.build(device="cpu")           # persists the operator payload
    pl2 = api.Plan.load(pl.key, mat=mat)
    assert pl2 is not None and pl2.cache_hit
    assert pl2.plan_ms == pl2.tune_ms == pl2.reorder_ms == 0.0
    assert pl2.partitioner == pl.partitioner
    assert pl2.topology == pl.topology
    np.testing.assert_array_equal(pl2.panel_starts, pl.panel_starts)
    np.testing.assert_array_equal(pl2.perm, pl.perm)
    assert pl2.comm == pl.comm and pl2.partition_costs == pl.partition_costs
    op2 = pl2.build(device="cpu")
    assert op2.build_info["cache_hit"] and op2.build_info["build_ms"] == 0.0
    x = torch.as_tensor(_x(mat.n), dtype=torch.float32)
    assert torch.equal(op(x), op2(x))
    pl3 = api.plan(api.SpmvProblem(mat, k=4), **req)
    assert pl3.cache_hit and pl3.key == pl.key
    assert pl3.build(device="cpu").build_info["cache_hit"]


def test_sharded_store_write_discipline(stores):
    _, mat = pair("powerlaw")
    pl = api.plan(api.SpmvProblem(mat), reorder="rcm", engine="csr",
                  topology=Topology(devices=4), partition="static")
    pl.build(device="cpu")
    d = str(stores / "plans")
    assert not glob.glob(os.path.join(d, "*.tmp"))
    assert os.path.exists(os.path.join(d, pl.key + ".json"))
    z = np.load(os.path.join(d, pl.key + ".npz"))
    assert "panel_starts" in z.files                    # the plan's split
    assert any(k.startswith("op__") for k in z.files)   # operator payload
    # a corrupt payload is a miss and the operator is rebuilt
    with open(os.path.join(d, pl.key + ".npz"), "wb") as f:
        f.write(b"not an npz")
    pl2 = api.plan(api.SpmvProblem(mat), reorder="rcm", engine="csr",
                   topology=Topology(devices=4), partition="static")
    assert not pl2.cache_hit
    op = pl2.build(device="cpu")
    assert not op.build_info["cache_hit"]


@pytest.mark.parametrize("fault", ["missing_array", "foreign_error"])
def test_sharded_store_restore_failure(fault, monkeypatch):
    """An unreadable layout entry is counted and rebuilt; any other error
    while restoring is raised, not hidden behind a rebuild."""
    from repro_torch import obs

    _, mat = pair("banded")
    req = dict(reorder="rcm", engine="csr", topology=Topology(devices=4),
               partition="static")
    api.plan(api.SpmvProblem(mat), **req).build(device="cpu")
    pl = api.plan(api.SpmvProblem(mat), **req)
    assert pl.cache_hit and pl._op_state is not None
    failures = obs.counter("plan_store.restore_failures")
    before = failures.value
    if fault == "missing_array":
        pl._op_state[1].pop("panel_starts")
        op = pl.build(device="cpu")
        assert not op.build_info["cache_hit"]
        assert "KeyError" in op.build_info["restore_error"]
        assert failures.value == before + 1
        x = torch.as_tensor(_x(mat.n), dtype=torch.float64)
        assert _rel(op(x).numpy(), _oracle(mat, x.numpy())) < F32_TOL
    else:
        def broken(*args, **kwargs):
            raise RuntimeError("not a format error")

        monkeypatch.setattr(dist.ShardedOperator, "from_state", broken)
        with pytest.raises(RuntimeError, match="not a format error"):
            pl.build(device="cpu")
        assert failures.value == before


def test_rebuild_swaps_values_under_the_frozen_split():
    from repro_torch.launch import spmv_bench

    rm, pm = pair("banded")
    want, got = _plans("banded", "rcm", "bell", 8, "1d_rows", "auto")
    twin = spmv_bench.structure_twin(pm, seed=3)
    op = got.build(device="cpu", values=twin.vals)
    assert op.build_info["value_swap"] and not op.build_info["cache_hit"]
    assert op.layout.schedule == got.comm["schedule"]
    np.testing.assert_array_equal(op.panel_starts, got.panel_starts)
    rop = want.rebuild(rm.__class__(rowptr=rm.rowptr, cols=rm.cols,
                                    vals=twin.vals, shape=rm.shape))
    x = _x(pm.n, seed=5)
    y = op(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y, rop(jnp.asarray(x, jnp.float32))) < F32_TOL
    assert _rel(y, twin.spmv(x)) < F32_TOL
    with pytest.raises(ValueError, match="structure"):
        got.rebuild(pair("powerlaw")[1], device="cpu")


# -- CG, per-device bytes, conversion -----------------------------------------
def test_cg_through_sharded_operator():
    from repro_torch.core.measure import cg

    dense = RG.banded(256, 3, seed=1).to_dense()
    dense = (dense + dense.T) / 2 + 6.0 * np.eye(256)
    r, c = np.nonzero(dense)
    spd = CSRMatrix.from_coo(r, c, dense[r, c], (256, 256))
    b = torch.as_tensor(_x(256), dtype=torch.float64)
    prob = api.SpmvProblem(spd, dtype=np.float64)
    op = api.plan(prob, reorder="rcm", engine="csr",
                  topology=Topology(devices=4),
                  partition="nnz_balanced").build(device="cpu")
    one = api.plan(prob, reorder="rcm", engine="csr").build(device="cpu")
    assert isinstance(op, api.ShardedOperator)
    res = cg.cg_solve(op, b, max_iter=300, tol=1e-10)
    res1 = cg.cg_solve(one, b, max_iter=300, tol=1e-10)
    x = res.x.numpy()
    assert np.abs(spd.spmv(x) - b.numpy()).max() < 1e-8
    assert res.iters == res1.iters
    assert abs(float(res.residual) - float(res1.residual)) <= 1e-12
    B = torch.as_tensor(_x(256, 2), dtype=torch.float64)
    resb = cg.block_cg_solve(op.matmul, B, max_iter=300, tol=1e-10)
    assert np.abs(dense @ resb.x.numpy() - B.numpy()).max() < 1e-8


def test_operator_nbytes_per_device():
    rm, mat = pair("powerlaw")
    op1 = api.plan(api.SpmvProblem(mat), cache=False).build(device="cpu",
                                                           cache=False)
    assert opcache.operator_nbytes_per_device(op1) == \
        [opcache.operator_nbytes(op1)]
    for devices, layout in ((2, "1d_rows"), (8, "2d_panels")):
        req = dict(cache=False, partition="static")
        pl = api.plan(api.SpmvProblem(mat),
                      topology=Topology(devices=devices, layout=layout),
                      **req)
        op = pl.build(device="cpu", cache=False)
        per = opcache.operator_nbytes_per_device(op)
        assert len(per) == devices and all(b > 0 for b in per)
        idx = sum(getattr(op, a).numel() * getattr(op, a).element_size()
                  for a in ("_in_idx", "_in_idx_r", "_out_idx",
                            "_out_idx_r"))
        assert idx > 0 and min(per) >= idx
        # the same charge as the reference's, device by device
        rpl = rapi.plan(rapi.SpmvProblem(rm),
                        topology=rapi.Topology(devices=devices,
                                               layout=layout), **req)
        assert per == ropcache.operator_nbytes_per_device(
            rpl.build(cache=False))
        # one blob: the engine arrays and the index maps on the device
        blob = opcache.operator_nbytes(op)
        arrays = sum(t.numel() * t.element_size() for t in op._dev)
        assert blob >= arrays + idx


def test_convert_sharded_plan_and_operator():
    rm, pm = pair("banded")
    want = rapi.plan(rapi.SpmvProblem(rm), reorder="rcm", engine="csr",
                     topology=rapi.Topology(devices=4), partition="auto")
    with pytest.raises(ValueError, match="panel_starts"):
        convert.plan_from_reference(want.to_json(), want.perm, mat=pm)
    got = convert.plan_from_reference(want.to_json(), want.perm, mat=pm,
                                      panel_starts=want.panel_starts)
    _same_decision(want, got)
    rop = want.build()
    x = _x(pm.n, seed=6)
    ry = rop(jnp.asarray(x, jnp.float32))
    y = got.build(device="cpu", cache=False)(
        torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y, ry) < F32_TOL
    meta, arrays = rop.state()
    op = convert.operator_from_reference("ShardedOperator", meta, arrays,
                                         device="cpu", perm=rop.perm,
                                         dtype=torch.float32)
    assert _rel(op(torch.as_tensor(x, dtype=torch.float32)), ry) < F32_TOL
    pmeta, parrays = op.state()
    assert pmeta == meta and sorted(parrays) == sorted(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(parrays[key], arr)


# -- structure deltas: the same-shape rule ---------------------------------------
def test_sharded_plan_refuses_append():
    from repro_torch import obs
    from repro_torch.core.spmv.delta import DeltaTooLarge, StructureDelta

    _, mat = pair("powerlaw")
    pl = api.plan(api.SpmvProblem(mat), reorder="baseline", engine="csr",
                  topology=Topology(devices=2), partition="static",
                  cache=False)
    before = obs.counter("delta.fallbacks").value
    with pytest.raises(DeltaTooLarge, match="same-shape"):
        pl.apply_delta(StructureDelta(append_rows=1))
    assert obs.counter("delta.fallbacks").value == before + 1


def test_sharded_same_shape_delta_reuses_the_split():
    from repro_torch.core.spmv.delta import StructureDelta

    rm, mat = pair("banded")
    pl = api.plan(api.SpmvProblem(mat), reorder="rcm", engine="csr",
                  topology=Topology(devices=4), partition="nnz_balanced")
    # drop the first stored entry of 20 rows (no diagonal among them)
    rows = np.arange(0, 400, 20)
    cols = np.array([mat.cols[mat.rowptr[r]] for r in rows])
    keep = cols != rows
    delta = StructureDelta(del_rows=rows[keep], del_cols=cols[keep])
    pl2 = pl.apply_delta(delta)
    assert pl2.key != pl.key and pl2.partitioner == pl.partitioner
    np.testing.assert_array_equal(pl2.panel_starts, pl.panel_starts)
    np.testing.assert_array_equal(pl2.perm, pl.perm)
    assert pl2.comm == pl.comm
    op = pl2.build(device="cpu")
    x = _x(mat.n, seed=8)
    new = delta.apply_to(mat)
    assert new.nnz == mat.nnz - keep.sum()
    assert _rel(op(torch.as_tensor(x)), new.spmv(x)) < F64_TOL


# -- the "parallel" cell kind ----------------------------------------------------
def test_parallel_cell_kind_campaign_resumes():
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)
    from repro_torch.experiments.cells import parallel_variant

    spec = ExperimentSpec(
        name="t_par", matrices=("smoke_banded", "smoke_powerlaw"),
        schemes=("baseline", "rcm"), engines=("csr",), ps=(4,),
        kind="parallel",
        variants=(parallel_variant("1d_rows", "nnz_balanced"),
                  parallel_variant("2d_panels", "static")),
        policy=MeasurePolicy(iters=2, warmup=0, verify=True,
                             with_yax=False, with_parallel=False,
                             with_metrics=False))
    store = ResultStore()
    rep = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert rep.measured == 8 and rep.reused == 0 and not rep.failures
    for rec in rep.records:
        assert rec["comm_schedule"] in ("all_gather", "halo", "psum")
        assert rec["comm_bytes_per_spmv"] > 0 and rec["li"] >= 1.0
        assert rec["verify_rel_err"] < 1e-4
        assert rec["verify_twin_rel_err"] < 1e-4
        assert rec["modelled_par_ms"] > 0 and rec["simulated"]
        assert not rec["plan_store_hit"]
        assert rec["launches"] == {k: 0 for k in rec["launches"]}
    # the plan store serves a rerun on a fresh result store
    rep1 = Runner(spec, store=ResultStore(root=str(store.root) + "_2"),
                  verbose=False, device="cpu").run()
    assert rep1.measured == 8
    for rec in rep1.records:
        assert rec["plan_store_hit"] and rec["tune_ms"] == 0.0
        assert rec["op_cache_hit"]
    # resumability: the identical spec re-run measures nothing
    rep2 = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert rep2.measured == 0 and rep2.reused == 8
    # the scheme axis is honored: rcm cells see a smaller cut on a band
    cut = {r["resolved_scheme"]: r["cut_volume"] for r in rep2.records
           if r["matrix"] == "smoke_banded" and r["layout"] == "1d_rows"}
    assert cut["rcm"] <= cut["baseline"]


def test_parallel_cell_is_the_references_record():
    """One cell through both packages' kinds: the same decision fields."""
    from repro.experiments import cells as rcells
    from repro.experiments.spec import Cell as RCell
    from repro.experiments.spec import MeasurePolicy as RPolicy
    from repro_torch.experiments import cells
    from repro_torch.experiments.spec import Cell, MeasurePolicy

    rm, pm = pair("banded")
    pol = dict(iters=2, warmup=0, verify=True, time_spmv=False)
    coords = dict(kind="parallel", matrix="<adhoc>", scheme="rcm",
                  engine="auto", dtype="float32", p=8, k=1,
                  variant="1d_rows:auto")
    want = rcells.measure_parallel_cell(RCell(**coords, policy=tuple(
        sorted(RPolicy(**pol).resolve("").items()))), rm)
    got = cells.measure_parallel_cell(Cell(**coords, policy=tuple(
        sorted(MeasurePolicy(**pol).resolve("").items()))), pm, "cpu")
    for key in ("devices", "layout", "partitioner", "resolved_scheme",
                "engine", "plan_label", "li", "cut_volume", "halo_width",
                "comm_schedule", "comm_bytes_per_spmv", "gather_bytes",
                "halo_bytes", "h_pad", "simulated"):
        assert got[key] == want[key], key
    assert got["comm_schedule"] == "halo"


def test_parallel_cell_kind_rejects_single_device():
    from repro_torch.experiments import Cell, MeasurePolicy
    from repro_torch.experiments.cells import measure_parallel_cell

    pol = tuple(sorted(MeasurePolicy().resolve("").items()))
    cell = Cell(kind="parallel", matrix="<adhoc>", scheme="baseline",
                engine="csr", dtype="float32", p=1, k=1,
                variant="1d_rows:static", policy=pol)
    with pytest.raises(ValueError, match="p >= 2"):
        measure_parallel_cell(cell, pair("powerlaw")[1], "cpu")


@pytest.mark.parametrize("variant,want", [
    ("1d_rows:static", ("1d_rows", "static")),
    ("2d_panels", ("2d_panels", "nnz_balanced")),
    ("metis_cut", ("1d_rows", "metis_cut")),
    ("", ("1d_rows", "nnz_balanced"))])
def test_parallel_variant_grammar_is_the_references(variant, want):
    from repro.experiments import cells as rcells
    from repro_torch.experiments import cells

    assert cells._parse_parallel_variant(variant) == want
    assert rcells._parse_parallel_variant(variant) == want
    assert cells.parallel_variant(*want) == rcells.parallel_variant(*want)


# -- the service and the CLI -------------------------------------------------------
def test_service_sharded_key_original_space():
    from repro_torch.serving.errors import RoutedElsewhere
    from repro_torch.serving.spmv_service import SpmvService

    _, mat = pair("powerlaw")
    rng = np.random.default_rng(5)
    with SpmvService(engine="csr", reorder="rcm", max_batch=4,
                     window_ms=2.0, device="cpu") as svc:
        svc.register("plain", mat)
        svc.register("sharded", mat, topology=Topology(devices=4))
        xs = [rng.standard_normal(mat.n) for _ in range(8)]
        futs = [(x, svc.submit("sharded", x)) for x in xs]
        futs += [(x, svc.submit("plain", x)) for x in xs[:2]]
        svc.flush()
        for x, fut in futs:
            assert _rel(fut.result(timeout=30), mat.spmv(x)) < 1e-4
        op = svc.operator("sharded")
        assert isinstance(op, api.ShardedOperator)
        assert op.topology.devices == 4 and op.simulated
        for update in (lambda: svc.update_values("sharded", mat.vals),
                       lambda: svc.update_structure("sharded", mat)):
            with pytest.raises(RoutedElsewhere):
                update()


def test_run_parallel_cli_hits_the_store_on_the_second_run(capsys):
    from repro_torch.launch import spmv_bench

    argv = ["--matrix", "smoke_banded", "--scheme", "rcm", "--devices", "4",
            "--layout", "2d_panels", "--partition", "auto", "--iters", "2",
            "--device", "cpu"]
    spmv_bench.main(argv)
    spmv_bench.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[spmv-parallel]")]
    assert len(lines) == 2
    assert "store_hit=False" in lines[0] and "store_hit=True" in lines[1]
    assert "sched=psum" in lines[0] and "sim=True" in lines[0]
    with pytest.raises(SystemExit):
        spmv_bench.main(["--matrix", "smoke_banded", "--layout", "1d_rows",
                         "--device", "cpu"])
    # --serve-sim serves one device: a fleet is --serve-traffic's
    with pytest.raises(SystemExit) as e:
        spmv_bench.main(["--serve-sim", "--devices", "4", "--device", "cpu"])
    assert e.value.code == 2
    assert "--serve-traffic --devices N" in capsys.readouterr().err
