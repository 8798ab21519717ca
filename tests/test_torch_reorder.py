"""The port's METIS, METIS-nnzbal, PaToH and Louvain reorderings
(core/reorder/{graphutil,metis,patoh,louvain,api}.py) against the JAX
package's on the CPU, and their quality properties on the port alone.

- every permutation is the reference's, bit for bit, on the five smoke
  matrices, stencil2d_shuf_128 and sbm_m16384_k8 at seeds 0 and 3 (the same
  numpy code, the same rng draws);
- the coarsening machinery (heavy-edge matching, contraction, induced
  subgraphs, side weights, edge cut) gives the reference's arrays;
- the scheme registry iterates in the reference's order, with the same
  paper flags, and PAPER_SCHEMES and PARTITIONERS match;
- METIS cuts the communication, Louvain finds planted communities, PaToH
  beats a random split on its connectivity objective and the METIS
  partition is balanced (the properties tests/test_reorder.py holds the
  reference to).

The partition labels, cuts and metis_cut are in
test_torch_reorder_partition.py.
"""
import numpy as np
import pytest

from repro.core import registry as rregistry
from repro.core.reorder import api as rapi
from repro.core.reorder import graphutil as rgraphutil
from repro.matrices import suite as rsuite
from repro_torch.core import registry
from repro_torch.core.reorder import api, graphutil
from repro_torch.core.reorder.metis import metis_partition
from repro_torch.core.reorder.patoh import connectivity_cut, patoh_partition
from repro_torch.core.sparse import metrics, partition
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.matrices import generators as G

MATRICES = ("smoke_banded", "smoke_stencil", "smoke_rmat", "smoke_sbm",
            "smoke_powerlaw", "stencil2d_shuf_128", "sbm_m16384_k8")
SCHEMES = ("metis", "metis_nnzbal", "patoh", "louvain")
SEEDS = (0, 3)

_MATS = {}


def _port(rm):
    return CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                     shape=rm.shape)


def pair(name):
    """(reference matrix, the same arrays as the port's CSRMatrix), built
    from the reference catalog's generator (no on-disk matrix cache)."""
    if name not in _MATS:
        rm = rsuite._CATALOG[name].thunk()
        _MATS[name] = (rm, _port(rm))
    return _MATS[name]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", MATRICES)
def test_permutation_is_the_references(name, scheme, seed):
    rm, pm = pair(name)
    want = rapi.reorder(rm, scheme, seed, cache=False)
    got = api.reorder(pm, scheme, seed, cache=False)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(pm.m))


@pytest.mark.parametrize("degree_weighted", [False, True])
@pytest.mark.parametrize("name", MATRICES[:5] + ("stencil2d_shuf_128",))
def test_coarsening_is_the_references(name, degree_weighted):
    rm, pm = pair(name)
    rg = rgraphutil.from_matrix(rm, degree_weighted=degree_weighted)
    g = graphutil.from_matrix(pm, degree_weighted=degree_weighted)
    np.testing.assert_array_equal(g.edge_sources(), rg.edge_sources())
    match = graphutil.heavy_edge_matching(g, np.random.default_rng(5))
    np.testing.assert_array_equal(
        match, rgraphutil.heavy_edge_matching(rg, np.random.default_rng(5)))
    coarse, cmap = graphutil.coarsen(g, match)
    rcoarse, rcmap = rgraphutil.coarsen(rg, match)
    np.testing.assert_array_equal(cmap, rcmap)
    for f in ("indptr", "indices", "weights", "vwgt"):
        a, b = getattr(coarse, f), getattr(rcoarse, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    verts = np.flatnonzero(np.random.default_rng(6).random(g.m) < 0.5)
    sub, rsub = graphutil.subgraph(g, verts), rgraphutil.subgraph(rg, verts)
    for f in ("indptr", "indices", "weights", "vwgt"):
        np.testing.assert_array_equal(getattr(sub, f), getattr(rsub, f))
    side = (np.random.default_rng(7).random(g.m) < 0.5).astype(np.int8)
    for a, b in zip(graphutil.neighbor_side_weights(g, side),
                    rgraphutil.neighbor_side_weights(rg, side)):
        np.testing.assert_array_equal(a, b)
    assert graphutil.edge_cut(g, side) == rgraphutil.edge_cut(rg, side)


def test_scheme_registry_is_the_references():
    assert list(registry.SCHEME_REGISTRY) == list(rregistry.SCHEME_REGISTRY)
    for name, spec in registry.SCHEME_REGISTRY.items():
        ref = rregistry.SCHEME_REGISTRY[name]
        assert (spec.paper, spec.auto_candidate, spec.description) == \
            (ref.paper, ref.auto_candidate, ref.description), name
    assert api.PAPER_SCHEMES == rapi.PAPER_SCHEMES == \
        ["rcm", "metis", "louvain", "patoh"]
    assert sorted(api.PARTITIONERS) == sorted(rapi.PARTITIONERS)


@pytest.mark.parametrize("scheme", list(registry.SCHEME_REGISTRY))
def test_every_scheme_gives_a_permutation(scheme):
    for name in ("smoke_sbm", "smoke_powerlaw"):
        _, pm = pair(name)
        perm = api.reorder(pm, scheme, cache=False)
        assert perm.shape == (pm.m,)
        np.testing.assert_array_equal(np.sort(perm), np.arange(pm.m))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_reorder_cache_round_trips(scheme, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_REORDER_CACHE", str(tmp_path))
    _, pm = pair("smoke_sbm")
    first = api.reorder(pm, scheme, 1, cache=True)
    again = api.reorder(pm, scheme, 1, cache=True)  # from the cache
    np.testing.assert_array_equal(first, again)
    assert len(list(tmp_path.iterdir())) == 1


# -- quality properties, on the port alone -----------------------------------
@pytest.fixture(scope="module")
def corpus():
    return {
        "sbm": G.shuffle(G.sbm(768, 6, 0.06, 0.001, seed=4), 5),
        "rmat": G.rmat(9, 5, seed=6),
    }


def test_metis_cuts_communication(corpus):
    mat = corpus["sbm"]
    base_cut = metrics.cut_volume(mat, partition.static_partition(mat, 8))
    rm = mat.permute(api.reorder(mat, "metis", cache=False))
    metis_cut = metrics.cut_volume(rm, partition.static_partition(rm, 8))
    assert metis_cut < base_cut * 0.8


def test_louvain_finds_planted_communities():
    mat = G.shuffle(G.sbm(512, 4, 0.2, 0.001, seed=0), 1)
    rm = mat.permute(api.reorder(mat, "louvain", cache=False))
    base_cut = metrics.cut_volume(mat, partition.static_partition(mat, 4))
    lv_cut = metrics.cut_volume(rm, partition.static_partition(rm, 4))
    assert lv_cut < base_cut


def test_patoh_connectivity_objective(corpus):
    mat = corpus["sbm"]
    labels = patoh_partition(mat, 2, seed=0)
    side = (labels > 0).astype(np.int8)
    rng = np.random.default_rng(0)
    rand_cut = connectivity_cut(mat, rng.permutation(side))
    assert connectivity_cut(mat, side) < rand_cut


def test_metis_partition_balanced(corpus):
    mat = corpus["rmat"]
    labels = metis_partition(mat, 8, seed=0)
    counts = np.bincount(labels, minlength=8)
    assert counts.max() <= mat.m / 8 * 1.6



def test_a_general_permute_is_the_reference_permute():
    """permute with its own column permutation (B = P A Q^T, Q != P), the
    form the partitioners' composed orders take: the reference's arrays
    bit for bit, in their types, and the matrix itself left as it was."""
    rm = rsuite.get("smoke_powerlaw")
    mat = _port(rm)
    rng = np.random.default_rng(3)
    rows, cols = rng.permutation(mat.m), rng.permutation(mat.n)
    want = rm.permute(rows, cols)
    before = mat.vals.copy()
    got = mat.permute(rows, cols)
    for f in ("rowptr", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    np.testing.assert_array_equal(mat.vals, before)
