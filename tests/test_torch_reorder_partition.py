"""The port's k-way partitions against the JAX package's on the CPU:
metis_partition and patoh_partition labels at k = 2 and 8, the
connectivity and edge cuts of those splits, and the metis_cut
partitioner's (perm, starts) at p = 8, bit for bit on the five smoke
matrices, stencil2d_shuf_128 and sbm_m16384_k8 at seeds 0 and 3.
"""
import numpy as np
import pytest

from repro.core.reorder import api as rapi
from repro.core.reorder import graphutil as rgraphutil
from repro.core.reorder import patoh as rpatoh
from repro.core.sparse import partition as rpartition
from repro.matrices import suite as rsuite
from repro_torch.core.reorder import api, graphutil, patoh
from repro_torch.core.sparse import partition
from repro_torch.core.sparse.csr import CSRMatrix

MATRICES = ("smoke_banded", "smoke_stencil", "smoke_rmat", "smoke_sbm",
            "smoke_powerlaw", "stencil2d_shuf_128", "sbm_m16384_k8")
SEEDS = (0, 3)

_MATS = {}


def pair(name):
    """(reference matrix, the same arrays as the port's CSRMatrix), built
    from the reference catalog's generator (no on-disk matrix cache)."""
    if name not in _MATS:
        rm = rsuite._CATALOG[name].thunk()
        _MATS[name] = (rm, CSRMatrix(rowptr=rm.rowptr, cols=rm.cols,
                                     vals=rm.vals, shape=rm.shape))
    return _MATS[name]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("scheme", ["metis", "patoh"])
@pytest.mark.parametrize("name", MATRICES)
def test_partition_labels_and_cuts_are_the_references(name, scheme, k, seed):
    rm, pm = pair(name)
    want = rapi.partition_labels(rm, scheme, k, seed)
    got = api.partition_labels(pm, scheme, k, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.max() < k
    # the two halves of the split: the hypergraph and the graph cut
    side = (got >= max(k // 2, 1)).astype(np.int8)
    assert patoh.connectivity_cut(pm, side) == \
        rpatoh.connectivity_cut(rm, side)
    assert graphutil.edge_cut(graphutil.from_matrix(pm), side) == \
        rgraphutil.edge_cut(rgraphutil.from_matrix(rm), side)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", MATRICES)
def test_metis_cut_is_the_references(name, seed):
    rm, pm = pair(name)
    gname, gfn = partition.resolve_partitioner("metis_cut")
    wname, wfn = rpartition.resolve_partitioner("metis_cut")
    assert gname == wname == "metis_cut"
    gperm, gstarts = gfn(pm, 8, seed)
    wperm, wstarts = wfn(rm, 8, seed)
    for g, w in ((gperm, wperm), (gstarts, wstarts)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.sort(gperm), np.arange(pm.m))
    assert gstarts[0] == 0 and gstarts[-1] == pm.m and gstarts.size == 9


def test_metis_cut_registration_is_the_references():
    spec = partition.PARTITIONER_REGISTRY["metis_cut"]
    ref = rpartition.PARTITIONER_REGISTRY["metis_cut"]
    assert (spec.reorders, spec.auto_candidate, spec.description) == \
        (ref.reorders, ref.auto_candidate, ref.description)
    assert list(partition.PARTITIONER_REGISTRY) == \
        list(rpartition.PARTITIONER_REGISTRY)
    assert partition.auto_partitioners() == rpartition.auto_partitioners()


def test_schedule_cell_times_the_metis_cut_panels(monkeypatch):
    """The schedule cell's metis_cut variant (a port-side variant beside
    the paper's policies) times the reference's metis_cut panels of the
    permuted matrix."""
    import torch

    from repro_torch import experiments as E
    from repro_torch.core.measure import parallel_model
    from repro_torch.experiments import cells

    rm, pm = pair("smoke_sbm")
    seen = {}
    real = parallel_model.modelled_parallel_ms

    def spy(mat, p, engine="csr", **kw):
        seen.update(mat=mat, p=p, panels=kw.get("panels"))
        return real(mat, p, engine, **kw)

    monkeypatch.setattr(parallel_model, "modelled_parallel_ms", spy)
    cell = E.ExperimentSpec(name="s", matrices=("smoke_sbm",),
                            engines=("csr",), kind="schedule", ps=(8,),
                            variants=("metis_cut",),
                            policy=E.MeasurePolicy(iters=2)).cells()[0]
    got = cells.measure_schedule_cell(cell, pm, torch.device("cpu"))
    assert set(got) == {"m", "n", "nnz", "modelled_par_ms", "gflops"}
    assert got["modelled_par_ms"] > 0 and seen["p"] == 8
    perm, starts = rpartition.resolve_partitioner("metis_cut")[1](rm, 8, 0)
    np.testing.assert_array_equal(seen["panels"], starts)
    np.testing.assert_array_equal(seen["mat"].cols, rm.permute(perm).cols)
