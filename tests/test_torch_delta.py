"""The port's structure deltas (core/spmv/delta.py, Plan.apply_delta)
against the JAX package's on the CPU:

- StructureDelta.apply_to, delta_between, churn and signature give the
  reference's CSR arrays and numbers, bit for bit, on banded, power-law
  and random matrices;
- Plan.apply_delta gives the reference's perm, shape, nnz and counter
  moves (delta.applies / delta.fallbacks), under the same thresholds;
  appended rows extend the perm with an identity tail; an empty delta is
  a no-op;
- the reference's own delta cases, run on the port (its sharded-plan
  case waits for sharded plans; its GNN stream case is in
  test_torch_workloads.py);
- the sorts that stand in for np.lexsort, np.unique and np.isin
  (CSRMatrix.from_coo and permute, the delta's membership test) give the
  reference's arrays and numpy's booleans.
"""
import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core.spmv import delta as rdelta
from repro.core.sparse.csr import CSRMatrix as RCSR
from repro.core.spmv import plan as rplan
from repro.matrices import generators as RG
from repro_torch import obs
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv import delta as pdelta
from repro_torch.core.spmv.delta import (MAX_BW_GROWTH, MAX_CHURN, BadDelta,
                                         DeltaTooLarge, StructureDelta,
                                         delta_between)
from repro_torch.core.spmv.plan import (SpmvProblem, plan, structure_key,
                                        values_key)
from repro_torch.matrices import generators as G

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_PLAN_CACHE", "ref_plans"),
                     ("REPRO_OPERATOR_CACHE", "ref_opcache"),
                     ("REPRO_REORDER_CACHE", "ref_reorder")):
        monkeypatch.setenv(var, str(tmp_path / sub))


MATS = {
    "banded": lambda: RG.banded(96, 3, seed=0),
    "power_law": lambda: RG.power_law(128, alpha=1.9, seed=3),
    "random": lambda: RG.random_uniform(128, 5, seed=4),
}


def _port(rm):
    return CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                     shape=rm.shape)


def _entries(mat):
    rows = np.repeat(np.arange(mat.shape[0], dtype=np.int64),
                     np.diff(mat.rowptr.astype(np.int64)))
    return rows, mat.cols.astype(np.int64)


def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("rowptr", "cols", "vals"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _edit(mat, seed, append=0):
    """A mixed edit script: delete 6 entries, add 6 absent ones (some in
    appended rows), from a seed."""
    rng = np.random.default_rng(seed)
    rows, cols = _entries(mat)
    pick = np.sort(rng.choice(mat.nnz, size=6, replace=False))
    m, n = mat.shape
    m2, n2 = m + append, (n + append if m == n else n)
    taken = set((rows * n2 + cols).tolist())
    add = []
    while len(add) < 6:
        r, c = int(rng.integers(m2)), int(rng.integers(n2))
        if r * n2 + c not in taken:
            taken.add(r * n2 + c)
            add.append((r, c))
    add = np.asarray(add, np.int64)
    return dict(append_rows=append, add_rows=add[:, 0], add_cols=add[:, 1],
                add_vals=rng.standard_normal(6), del_rows=rows[pick],
                del_cols=cols[pick])


def _counters(reg):
    return (reg.counter("delta.applies").value,
            reg.counter("delta.fallbacks").value)


# -- bit-identical against the reference ---------------------------------
@pytest.mark.parametrize("append", [0, 2])
@pytest.mark.parametrize("name", sorted(MATS))
def test_delta_mechanics_match_reference(name, append):
    rm = MATS[name]()
    pm = _port(rm)
    kw = _edit(rm, seed=len(name) + append, append=append)
    rd, pd = rdelta.StructureDelta(**kw), StructureDelta(**kw)
    assert pd.signature() == rd.signature()
    assert pd.churn(pm) == rd.churn(rm) and pd.churn_nnz == rd.churn_nnz
    assert np.array_equal(pd.rows_touched(pm.m), rd.rows_touched(rm.m))
    rnew, pnew = rd.apply_to(rm), pd.apply_to(pm)
    _same_csr(pnew, rnew)
    back_r, back_p = rdelta.delta_between(rm, rnew), delta_between(pm, pnew)
    assert back_p.signature() == back_r.signature()
    assert back_p.append_rows == back_r.append_rows == append
    _same_csr(back_p.apply_to(pm), back_r.apply_to(rm))
    assert structure_key(back_p.apply_to(pm)) == structure_key(pnew)


def test_thresholds_and_refusals_match_reference():
    assert (MAX_CHURN, MAX_BW_GROWTH) == (rdelta.MAX_CHURN,
                                          rdelta.MAX_BW_GROWTH)
    rm = RG.banded(32, 2, seed=1)
    pm = _port(rm)
    assert delta_between(pm, _port(RG.banded(16, 2, seed=1))) is None
    assert rdelta.delta_between(rm, RG.banded(16, 2, seed=1)) is None
    for kw in ({"del_rows": [0], "del_cols": [31]},
               {"del_rows": [99], "del_cols": [0]}):
        with pytest.raises(rdelta.BadDelta):
            rdelta.StructureDelta(**kw).apply_to(rm)
        with pytest.raises(BadDelta):
            StructureDelta(**kw).apply_to(pm)


@pytest.mark.parametrize("append", [0, 2])
@pytest.mark.parametrize("scheme", ["baseline", "rcm"])
@pytest.mark.parametrize("name", sorted(MATS))
def test_apply_delta_matches_reference(name, scheme, append):
    rm = MATS[name]()
    pm = _port(rm)
    m = rm.shape[0]
    # appended entries hug the diagonal so the bandwidth stays legal
    kw = (dict(append_rows=append, add_rows=np.arange(m, m + append),
               add_cols=np.arange(m, m + append),
               add_vals=np.ones(append)) if append
          else _edit(rm, seed=7, append=0))
    rpl = rplan.plan(rplan.SpmvProblem(rm), reorder=scheme, cache=False)
    ppl = plan(SpmvProblem(pm), reorder=scheme, cache=False, device="cpu")
    assert (ppl.perm is None) == (rpl.perm is None)
    if ppl.perm is not None:
        assert np.array_equal(ppl.perm, rpl.perm)
    r0, p0 = _counters(robs), _counters(obs)
    outs = []
    for planned, mod, reg, c0 in ((rpl, rdelta, robs, r0),
                                  (ppl, None, obs, p0)):
        d = (rdelta.StructureDelta(**kw) if mod is rdelta
             else StructureDelta(**kw))
        try:
            out = planned.apply_delta(d)
        except (rdelta.DeltaTooLarge, DeltaTooLarge):
            out = None
        c1 = _counters(reg)
        outs.append((out, (c1[0] - c0[0], c1[1] - c0[1])))
    (rout, rmoves), (pout, pmoves) = outs
    assert pmoves == rmoves
    assert (pout is None) == (rout is None)
    if pout is None:
        return
    assert pout.mat_shape == tuple(rout.mat_shape)
    assert pout.mat_nnz == rout.mat_nnz
    assert (pout.perm is None) == (rout.perm is None)
    if pout.perm is not None:
        assert np.array_equal(pout.perm, rout.perm)
        if append:
            assert list(pout.perm[-append:]) == list(range(m, m + append))
    _same_csr(pout._mat, rout._mat)
    assert pout.scheme == rout.scheme and pout.tune.engine == rout.tune.engine
    assert pout.reorder_ms == pout.tune_ms == 0.0 and pout.key != ppl.key
    # the delta'd plan builds, and its operator multiplies the edited
    # matrix (original index space)
    x = np.random.default_rng(0).standard_normal(pout.mat_shape[1])
    op = pout.build(device="cpu", cache=False)
    got = op(torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    want = pout._mat.spmv(x)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_over_churn_moves_the_same_counters_as_reference():
    rm = RG.banded(128, 4, seed=4)
    rows, cols = _entries(rm)
    k = int(rm.nnz * MAX_CHURN) + 1
    r0, p0 = _counters(robs), _counters(obs)
    with pytest.raises(rdelta.DeltaTooLarge):
        rplan.plan(rplan.SpmvProblem(rm), reorder="rcm",
                   cache=False).apply_delta(
            rdelta.StructureDelta(del_rows=rows[:k], del_cols=cols[:k]))
    with pytest.raises(DeltaTooLarge):
        plan(SpmvProblem(_port(rm)), reorder="rcm", cache=False,
             device="cpu").apply_delta(
            StructureDelta(del_rows=rows[:k], del_cols=cols[:k]))
    r1, p1 = _counters(robs), _counters(obs)
    assert (p1[0] - p0[0], p1[1] - p0[1]) == (r1[0] - r0[0],
                                              r1[1] - r0[1]) == (0, 1)


# -- the reference's cases, on the port -------------------------------------
def test_apply_to_delete_and_add_roundtrip():
    mat = G.banded(64, 3, seed=0)
    rows, cols = _entries(mat)
    d = StructureDelta(del_rows=rows[:4], del_cols=cols[:4])
    out = d.apply_to(mat)
    assert out.nnz == mat.nnz - 4 and out.shape == mat.shape
    d2 = StructureDelta(add_rows=rows[:4], add_cols=cols[:4],
                        add_vals=mat.vals[:4])
    assert structure_key(d2.apply_to(out)) == structure_key(mat)


def test_apply_to_validates_edits():
    mat = G.banded(32, 2, seed=1)
    rows, cols = _entries(mat)
    with pytest.raises(BadDelta):      # delete a hole
        StructureDelta(del_rows=[0], del_cols=[31]).apply_to(mat)
    with pytest.raises(BadDelta):      # add onto an existing entry
        StructureDelta(add_rows=rows[:1], add_cols=cols[:1],
                       add_vals=[1.0]).apply_to(mat)
    with pytest.raises(BadDelta):      # out of range
        StructureDelta(del_rows=[99], del_cols=[0]).apply_to(mat)
    with pytest.raises(BadDelta):      # ragged arrays
        StructureDelta(add_rows=[0, 1], add_cols=[5], add_vals=[1.0])


def test_delta_between_recovers_edit():
    old = G.banded(64, 3, seed=2)
    rows, cols = _entries(old)
    new = StructureDelta(del_rows=rows[10:13],
                         del_cols=cols[10:13]).apply_to(old)
    d = delta_between(old, new)
    assert d is not None and d.churn_nnz == 3
    assert structure_key(d.apply_to(old)) == structure_key(new)
    assert delta_between(new, G.banded(32, 3, seed=2)) is None
    same = delta_between(old, old)
    assert same is not None and same.is_empty


def test_empty_delta_is_noop_and_moves_no_counters():
    pl = plan(SpmvProblem(G.banded(128, 4, seed=3)), reorder="rcm",
              cache=False, device="cpu")
    before = _counters(obs)
    assert pl.apply_delta(StructureDelta()) is pl
    assert _counters(obs) == before


def test_over_churn_delta_falls_back_exactly_once():
    mat = G.banded(128, 4, seed=4)
    rows, cols = _entries(mat)
    k = int(mat.nnz * MAX_CHURN) + 1
    pl = plan(SpmvProblem(mat), reorder="rcm", cache=False, device="cpu")
    applies0, fallbacks0 = _counters(obs)
    with pytest.raises(DeltaTooLarge):
        pl.apply_delta(StructureDelta(del_rows=rows[:k], del_cols=cols[:k]))
    assert _counters(obs) == (applies0, fallbacks0 + 1)


def test_keys_consistent_after_apply_delta():
    mat = G.banded(128, 4, seed=5)
    rows, cols = _entries(mat)
    d = StructureDelta(del_rows=rows[5:9], del_cols=cols[5:9])
    pl = plan(SpmvProblem(mat), reorder="rcm", cache=False, device="cpu")
    applies0, _ = _counters(obs)
    pl2 = pl.apply_delta(d)
    assert obs.counter("delta.applies").value == applies0 + 1
    new_mat = d.apply_to(mat)
    assert structure_key(pl2._mat) == structure_key(new_mat)
    assert values_key(pl2._mat) == values_key(new_mat)
    assert pl2.key != pl.key
    assert tuple(pl2.mat_shape) == tuple(new_mat.shape)
    assert pl2.mat_nnz == new_mat.nnz
    assert pl2.scheme == pl.scheme and pl2.tune.engine == pl.tune.engine
    op = pl2.build(device="cpu", cache=False)
    x = np.random.default_rng(0).standard_normal(new_mat.shape[1])
    want = new_mat.to_dense() @ x
    got = op(torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(), 1.0)


def test_append_rows_extends_perm_with_identity_tail():
    mat = G.banded(64, 3, seed=6)
    d = StructureDelta(append_rows=2, add_rows=[64, 65], add_cols=[63, 65],
                       add_vals=[1.0, 2.0])
    pl2 = plan(SpmvProblem(mat), reorder="rcm", cache=False,
               device="cpu").apply_delta(d)
    assert pl2.mat_shape == (66, 66)
    assert pl2.perm is not None and pl2.perm.size == 66
    assert list(pl2.perm[-2:]) == [64, 65]


# -- the sorts behind the CSR and the delta -----------------------------------
COO_CASES = {
    # (m, n, entries, duplicate share, values dtype, columns in range)
    "square_f64": (300, 300, 4000, 0.0, np.float64, True),
    "duplicates_f32": (200, 150, 3000, 0.3, np.float32, True),
    "rectangular_dups_f64": (64, 500, 2500, 0.5, np.float64, True),
    "empty": (10, 10, 0, 0.0, np.float64, True),
    "cols_out_of_range": (50, 40, 400, 0.2, np.float64, False),
    "cols_out_of_range_few": (50, 40, 30, 0.2, np.float64, False),
}


@pytest.mark.parametrize("case", sorted(COO_CASES))
def test_from_coo_matches_reference(case):
    m, n, k, dup, dtype, in_range = COO_CASES[case]
    rng = np.random.default_rng(len(case))
    rows = rng.integers(0, m, k)
    cols = rng.integers(0, n if in_range else 2 * n, k)
    nd = int(dup * k)
    if nd:                       # repeat some coordinates, other values
        pick = rng.integers(0, k, nd)
        rows[:nd], cols[:nd] = rows[pick], cols[pick]
    vals = rng.standard_normal(k).astype(dtype)
    if not in_range:             # the reference builds garbage or raises
        with pytest.raises(ValueError, match="out of range"):
            CSRMatrix.from_coo(rows, cols, vals, (m, n))
        return
    _same_csr(CSRMatrix.from_coo(rows, cols, vals, (m, n)),
              RCSR.from_coo(rows, cols, vals, (m, n)))


@pytest.mark.parametrize("name", sorted(MATS))
def test_permute_matches_reference(name):
    rm = MATS[name]()
    for seed in (0, 1):
        perm = np.random.default_rng(seed).permutation(rm.shape[0])
        _same_csr(_port(rm).permute(perm), rm.permute(perm))


def test_isin_is_numpys():
    rng = np.random.default_rng(3)
    for na, nb in ((500, 2000), (2000, 50), (0, 10), (10, 0), (0, 0)):
        a = rng.integers(0, 1000, na)
        b = rng.integers(0, 1000, nb)
        got = pdelta._isin(a, b)
        assert got.dtype == bool and np.array_equal(got, np.isin(a, b))
    assert pdelta._has_duplicates(np.array([3, 1, 3]))
    assert not pdelta._has_duplicates(np.array([3, 1, 2]))
