"""The port's campaign layer (experiments/, core/sparse/{metrics,partition},
core/measure/{parallel_model,profiles}, obs/export) against the JAX
package's on the CPU:

- partitions, every structural metric, the Figs. 5-8 statistics and
  regress.compare give the reference's values on the same inputs (exact:
  the same numpy code);
- a Report over the same synthetic records gives the reference's grids,
  speedups, profiles, buckets, win rates, consistency, plan/run split,
  break-even and bench summary;
- metrics.sorted_unique is np.unique;
- the spmv cell on smoke matrices has the reference cell's record keys
  plus verify_twin_rel_err and launches, and the same plan decisions and
  structural metrics; the schedule cell the reference's keys;
- a campaign run twice on one store measures nothing the second time, and
  a rerun on a fresh result store is served by the plan store;
- spmv_bench's smoke campaign passes, resumes and writes its summary;
- the Runner raises without a card unless given device="cpu".

Every test runs with its own stores (a temporary directory).
"""
import json

import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

from repro.core.measure import profiles as rprofiles
from repro.core.sparse import metrics as rmetrics
from repro.core.sparse import partition as rpartition
from repro.experiments import cells as rcells
from repro.experiments import regress as rregress
from repro.experiments import report as rreport
from repro.experiments import spec as rspec
from repro.matrices import generators as RG
from repro.matrices import suite as rsuite
from repro_torch import experiments as E
from repro_torch import kernels, obs
from repro_torch.core import registry
from repro_torch.core.measure import parallel_model, profiles
from repro_torch.core.sparse import metrics, partition
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.experiments import cells, regress, report
from repro_torch.matrices import suite

torch.set_num_threads(1)

CPU = torch.device("cpu")


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


MATS = {
    "power_law": lambda: RG.power_law(300, alpha=1.9, seed=3),
    "shuffled": lambda: RG.shuffle(RG.banded(256, 4, seed=1), seed=2),
    "rmat": lambda: RG.rmat(8, 4, seed=3),
    "empty_rows": lambda: RG.shuffle(RG.stencil_2d(12, seed=4), seed=5),
}


# -- partitions and metrics --------------------------------------------------
@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("p", [1, 3, 8, 500])
def test_partitions_are_the_references(name, p):
    rm = MATS[name]()
    pm = _port(rm)
    for fn in ("static_partition", "nnz_balanced_partition"):
        np.testing.assert_array_equal(getattr(partition, fn)(pm, p),
                                      getattr(rpartition, fn)(rm, p))
    for chunk in (1, 16):
        got = partition.chunked_cyclic_panels(pm.m, p, chunk)
        want = rpartition.chunked_cyclic_panels(rm.m, p, chunk)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for pname in ("static", "nnz_balanced", "chunked_cyclic",
                  "chunked_cyclic_c16"):
        gname, gfn = partition.resolve_partitioner(pname)
        wname, wfn = rpartition.resolve_partitioner(pname)
        gperm, gstarts = gfn(pm, p, 0)
        wperm, wstarts = wfn(rm, p, 0)
        assert gname == wname
        np.testing.assert_array_equal(gstarts, wstarts)
        assert (gperm is None) == (wperm is None)
        if gperm is not None:
            np.testing.assert_array_equal(gperm, wperm)
    starts = partition.nnz_balanced_partition(pm, p)
    np.testing.assert_array_equal(
        partition.partition_to_owner(starts, pm.m),
        rpartition.partition_to_owner(starts, rm.m))
    for g, w in zip(partition.pad_panels_to_uniform(pm, starts),
                    rpartition.pad_panels_to_uniform(rm, starts)):
        np.testing.assert_array_equal(g, w)
    assert partition.auto_partitioners() == ["static", "nnz_balanced"]


def test_metis_cut_is_not_ported_yet():
    """(Named when metis_cut waited for the METIS port.) It resolves now,
    to the reference's (perm, starts); unknown names still raise."""
    rm = MATS["rmat"]()
    gname, gfn = partition.resolve_partitioner("metis_cut")
    wname, wfn = rpartition.resolve_partitioner("metis_cut")
    assert gname == wname
    for g, w in zip(gfn(_port(rm), 4, 0), wfn(rm, 4, 0)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError, match="unknown partitioner"):
        partition.resolve_partitioner("nope")


@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("p", [1, 4, 8])
def test_every_metric_is_the_references(name, p):
    rm = MATS[name]()
    pm = _port(rm)
    for starts in (metrics.static_block_panels(pm.m, p),
                   partition.nnz_balanced_partition(pm, p),
                   np.array([0, pm.m // 3, pm.m // 2])):   # a partial split
        for fn in ("panel_loads", "cut_volume", "halo_width"):
            np.testing.assert_array_equal(getattr(metrics, fn)(pm, starts),
                                          getattr(rmetrics, fn)(rm, starts))
        np.testing.assert_array_equal(
            metrics.distinct_col_blocks(pm, starts, 16),
            rmetrics.distinct_col_blocks(rm, starts, 16))
        if starts[-1] == pm.m:
            assert metrics.load_imbalance(pm, starts) == \
                rmetrics.load_imbalance(rm, starts)
    np.testing.assert_array_equal(metrics.static_block_panels(pm.m, p),
                                  rmetrics.static_block_panels(rm.m, p))
    for fn in ("bandwidth", "profile", "avg_row_bandwidth"):
        assert getattr(metrics, fn)(pm) == getattr(rmetrics, fn)(rm)
    for bm, bn in ((8, 128), (4, 4)):
        assert metrics.block_fill_ratio(pm, bm, bn) == \
            rmetrics.block_fill_ratio(rm, bm, bn)
        assert metrics.num_nonempty_blocks(pm, bm, bn) == \
            rmetrics.num_nonempty_blocks(rm, bm, bn)
    assert metrics.summary(pm, p) == rmetrics.summary(rm, p)


@pytest.mark.parametrize("case", ["empty", "one", "repeats", "negative",
                                  "wide", "2d", "float"])
def test_sorted_unique_is_np_unique(case):
    rng = np.random.default_rng(11)
    a = {"empty": np.empty(0, np.int64),
         "one": np.array([7], np.int64),
         "repeats": rng.integers(0, 50, 4000),
         "negative": rng.integers(-1000, 1000, 3000),
         "wide": rng.integers(0, 2**62, 5000) // 3 * 3,
         "2d": rng.integers(0, 40, (30, 20)),
         "float": np.round(rng.standard_normal(2000), 1)}[case]
    got, want = metrics.sorted_unique(a), np.unique(a)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_panel_submatrix_and_rows_submatrix_are_the_references():
    rm = MATS["power_law"]()
    pm = _port(rm)
    from repro.core.measure import parallel_model as rpm

    for r0, r1, pad in ((0, 40, 0), (13, 300, 0), (100, 101, 512)):
        g, w = parallel_model.panel_submatrix(pm, r0, r1, pad), \
            rpm.panel_submatrix(rm, r0, r1, pad)
        for f in ("rowptr", "cols", "vals"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.shape == w.shape
    for rows in partition.chunked_cyclic_panels(pm.m, 8, 16) + \
            [np.array([299, 0, 7, 7], np.int64), np.empty(0, np.int64)]:
        g = cells._rows_submatrix(pm, rows)
        w = rcells._rows_submatrix(rm, rows)
        for f in ("rowptr", "cols", "vals"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            assert getattr(g, f).dtype == getattr(w, f).dtype
        assert g.shape == w.shape


def test_modelled_parallel_time_on_the_cpu():
    pm = _port(MATS["shuffled"]())
    for sched in ("static", "nnz_balanced"):
        ms = parallel_model.modelled_parallel_ms(pm, 4, "csr", sched,
                                                 iters=3, device="cpu")
        assert ms > parallel_model.ALPHA_SYNC_MS
    with pytest.raises(ValueError, match="panels"):
        parallel_model.modelled_parallel_ms(pm, 4, panels=[0, 256],
                                            device="cpu")


# -- statistics, regress, report ---------------------------------------------
def _perf(seed, s=4, m=9):
    rng = np.random.default_rng(seed)
    perf = rng.uniform(0.5, 3.0, (s, m))
    perf[1, 2] = perf[0, 2]                        # a tie
    return perf


@pytest.mark.parametrize("seed", range(4))
def test_profiles_are_the_references(seed):
    perf = _perf(seed)
    taus = np.array([1.0, 1.1, 1.5, 2.0, 4.0])
    np.testing.assert_array_equal(profiles.performance_profile(perf, taus),
                                  rprofiles.performance_profile(perf, taus))
    sp = perf / perf[0]
    np.testing.assert_array_equal(profiles.speedup_buckets(sp),
                                  rprofiles.speedup_buckets(sp))
    np.testing.assert_array_equal(profiles.pairwise_win_rates(perf),
                                  rprofiles.pairwise_win_rates(perf))
    for tau in (1.0, 1.1, 1.5):
        assert profiles.consistency_ratio(sp, tau) == \
            rprofiles.consistency_ratio(sp, tau)
    for fn in ("cdf", "reverse_cdf"):
        for g, w in zip(getattr(profiles, fn)(perf[0]),
                        getattr(rprofiles, fn)(perf[0])):
            np.testing.assert_array_equal(g, w)
    assert profiles.geomean(perf) == rprofiles.geomean(perf)
    recs = {f"c{i}": {"seq_ios_ms": float(v), "tune_ms": 2.0 * i,
                      "format_build_ms": 1.0, "op_cache_hit": i % 3 == 0}
            for i, v in enumerate(perf[1])}
    assert profiles.plan_run_split(recs, iters_to_amortize=7) == \
        rprofiles.plan_run_split(recs, iters_to_amortize=7)


def _summary(geo, speed, run_ms, m=2048, field="seq_ios_gflops"):
    return {"field": field, "geomean": geo, "speedup_vs_baseline": speed,
            "plan_run": {"median_run_ms": run_ms},
            "phases": {"median_tune_ms": 3.0},
            "scale": {"matrices": ["a", "b"], "max_m": m, "iters": 3,
                      "warmup": 1, "use_kernel": "auto",
                      "representative": False}}


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("portable", [False, True])
def test_regress_compare_is_the_references(case, portable):
    base = _summary({"baseline": 1.0, "rcm": 1.2}, {"rcm": 1.2}, 0.5)
    cur = [
        _summary({"baseline": 1.0, "rcm": 1.25}, {"rcm": 1.25}, 0.45),
        _summary({"baseline": 0.5, "rcm": 0.5}, {"rcm": 0.7}, 0.9),
        _summary({"baseline": 1.0, "rcm": 1.2}, {"rcm": 1.2}, 0.5, m=4096),
        _summary({"baseline": 1.0, "metis": 1.3}, {"metis": 1.3}, 0.5),
        {"geomean": {}},
    ][case]
    for tol in (0.35, 0.05):
        assert regress.compare(base, cur, tol, portable) == \
            rregress.compare(base, cur, tol, portable)
    assert regress.scale_mismatches(base, cur) == \
        rregress.scale_mismatches(base, cur)


def test_regress_cli_exit_codes(tmp_path):
    base = _summary({"baseline": 1.0, "rcm": 1.2}, {"rcm": 1.2}, 0.5)
    bad = _summary({"baseline": 0.5, "rcm": 0.5}, {"rcm": 0.7}, 0.9)
    paths = {}
    for name, s in (("base", base), ("bad", bad)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(s))
    args = lambda a, b: ["--baseline", str(paths[a]),  # noqa: E731
                         "--current", str(paths[b])]
    assert regress.main(args("base", "base")) == 0
    assert regress.main(args("base", "bad")) == 1
    assert regress.main(["--baseline", str(tmp_path / "none.json"),
                         "--current", str(paths["base"])]) == 2


def _synthetic_entries(cell_cls, spec, device=None):
    """The same records under both packages' Cell classes: 3 matrices x
    3 schemes x 2 profiles."""
    rng = np.random.default_rng(9)
    out = []
    for prof, p in (("P1", 8), ("P2", 4)):
        for m in ("m1", "m2", "m3"):
            for s in ("baseline", "rcm", "random"):
                rec = {"seq_ios_ms": float(rng.uniform(0.1, 2.0)),
                       "tune_ms": float(rng.uniform(0, 5)),
                       "format_build_ms": 1.5, "reorder_ms": 4.0,
                       "plan_store_hit": s == "random",
                       "m": 1000, "nnz": 9000, "engine": "csr",
                       "tuner_choice": "csr"}
                rec["seq_ios_gflops"] = 2 * 9000 / (rec["seq_ios_ms"] * 1e6)
                kw = {"device": device} if device else {}
                cell = cell_cls(kind="spmv", matrix=m, scheme=s,
                                engine="csr", dtype="float32", p=p, k=1,
                                variant="", policy=(("iters", 3),),
                                profile=prof, **kw)
                out.append((cell, rec, False, 0.1))
    return out


def test_report_gives_the_references_views():
    pol = E.MeasurePolicy(amortize_iters=50)
    rpol = rspec.MeasurePolicy(amortize_iters=50)
    spec = E.ExperimentSpec(name="syn", matrices=("m1",), policy=pol)
    rsp = rspec.ExperimentSpec(name="syn", matrices=("m1",), policy=rpol)
    got = report.Report(spec, _synthetic_entries(E.Cell, spec, "cpu"))
    want = rreport.Report(rsp, _synthetic_entries(rspec.Cell, rsp))
    mats, schemes = ["m1", "m2", "m3"], ["baseline", "rcm", "random"]
    f = "seq_ios_gflops"
    for prof in ("P1", "P2"):
        np.testing.assert_array_equal(got.grid(f, mats, schemes, profile=prof),
                                      want.grid(f, mats, schemes,
                                                profile=prof))
        np.testing.assert_array_equal(
            got.speedup(f, mats, schemes, profile=prof),
            want.speedup(f, mats, schemes, profile=prof))
        np.testing.assert_array_equal(
            got.performance_profile(f, mats, schemes, np.array([1, 1.2, 2]),
                                    profile=prof),
            want.performance_profile(f, mats, schemes, np.array([1, 1.2, 2]),
                                     profile=prof))
        np.testing.assert_array_equal(
            got.speedup_buckets(f, mats, schemes, profile=prof),
            want.speedup_buckets(f, mats, schemes, profile=prof))
        np.testing.assert_array_equal(
            got.pairwise_win_rates(f, mats, schemes, profile=prof),
            want.pairwise_win_rates(f, mats, schemes, profile=prof))
    assert got.consistency(f, mats, "rcm", ["P1", "P2"], [1.0, 1.1]) == \
        want.consistency(f, mats, "rcm", ["P1", "P2"], [1.0, 1.1])
    split_g, split_w = got.plan_run_split(), want.plan_run_split()
    assert [v for v in split_g.values()] == [v for v in split_w.values()]
    assert got.break_even() == want.break_even()
    sg, sw = got.bench_summary(), want.bench_summary()
    assert sg == sw
    with pytest.raises(report.MissingCellError, match="no measured cell"):
        got.cell("m9", "rcm", profile="P1")
    with pytest.raises(report.MissingCellError, match="pin more axes"):
        got.cell("m1", "rcm")
    with pytest.raises(report.MissingCellError, match="cg_ms"):
        got.value("cg_ms", "m1", "rcm", profile="P1")


def test_bench_summary_goes_to_the_ports_own_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    spec = E.ExperimentSpec(name="syn", matrices=("m1",))
    rep = report.Report(spec, _synthetic_entries(E.Cell, spec, "cpu"))
    out = rep.write_bench_summary()
    assert (tmp_path / report.SUMMARY_PATH).exists()
    assert out["cells"] == 18
    with pytest.raises(ValueError, match="JAX package"):
        rep.write_bench_summary(str(tmp_path / "BENCH_spmv.json"))


# -- specs, profiles, registry -------------------------------------------------
def test_machine_profiles_and_paper_schemes_match_the_reference():
    from repro.experiments import machine_profiles as rmp  # noqa: F401
    from repro.core import registry as rregistry

    mine = {n: s.physical() for n, s in registry.PROFILE_REGISTRY.items()}
    theirs = {n: s.physical() for n, s in
              rregistry.PROFILE_REGISTRY.items() if n.startswith("M")}
    assert mine == theirs and E.PRIMARY == "M1_csr_f32_p8"
    assert E.paper_schemes() == rspec.paper_schemes() == [
        "baseline", "rcm", "metis", "louvain", "patoh", "random"]
    assert "sell" in E.registered_engines()


def test_cell_keys_carry_the_device_kind():
    spec = E.ExperimentSpec(name="k", matrices=("smoke_banded",),
                            schemes=("baseline", "rcm"), ks=(1, 8))
    on_cpu = spec.cells(device="cpu")
    on_card = spec.cells(device="NVIDIA H100 80GB HBM3")
    assert len(on_cpu) == 4
    assert not {c.key() for c in on_cpu} & {c.key() for c in on_card}
    # the same physical point and policy keep their key
    assert [c.key() for c in on_cpu] == \
        [c.key() for c in spec.cells(device="cpu")]


def test_unported_kinds_raise():
    for kind in ("parallel", "route"):
        with pytest.raises(NotImplementedError,
                           match="not ported yet.*sharded plans"):
            cells.get_cell_kind(kind)
    for kind in ("workload", "serve"):
        assert cells.get_cell_kind(kind) is cells.CELL_KINDS[kind]
    with pytest.raises(KeyError, match="unknown cell kind"):
        cells.get_cell_kind("nope")


# -- the cells ----------------------------------------------------------------
def _policy(mod, **kw):
    return mod.MeasurePolicy(iters=3, warmup=1, verify=True,
                             cg_profiles=("*",), **kw)


@pytest.mark.parametrize("name", ["smoke_banded", "smoke_powerlaw"])
@pytest.mark.parametrize("scheme", ["baseline", "rcm"])
@pytest.mark.parametrize("k", [1, 8])
def test_spmv_cell_has_the_reference_cells_record(name, scheme, k):
    from repro.experiments import machine_profiles as rmp  # noqa: F401

    rm = rsuite.get(name)
    pm = suite.get(name)
    rcell = rspec.ExperimentSpec(name="c", matrices=(name,),
                                 schemes=(scheme,), ks=(k,),
                                 policy=_policy(rspec)).cells()[0]
    cell = E.ExperimentSpec(name="c", matrices=(name,), schemes=(scheme,),
                            ks=(k,), policy=_policy(E)).cells()[0]
    want = rcells.measure_spmv_cell(rcell, rm)
    got = cells.measure_spmv_cell(cell, pm, CPU)
    assert set(got) == set(want) | {"verify_twin_rel_err", "launches"}
    assert got["launches"] == {name: 0 for name in kernels.LAUNCHES}
    for key in ("resolved_scheme", "tuner_choice", "plan_label", "nnz", "m",
                "n", "li_static", "li_nnz_balanced", "bandwidth",
                "avg_row_bandwidth", "cut_volume", "block_fill_8x128",
                "tuner_decision", "tuner_candidates", "advisor_confidence",
                "plan_store_hit"):
        assert got[key] == want[key], key
    assert got["features"] == pytest.approx(want["features"], rel=1e-12)
    assert got["verify_rel_err"] < 1e-5 and got["verify_twin_rel_err"] < 1e-5


def test_schedule_cell_has_the_reference_cells_keys():
    rm = rsuite.get("smoke_banded")
    pm = suite.get("smoke_banded")
    for var in ("static_default", "static_c16", "nnz_balanced"):
        kw = dict(name="s", matrices=("smoke_banded",), schemes=("rcm",),
                  engines=("csr",), kind="schedule", variants=(var,))
        rcell = rspec.ExperimentSpec(
            policy=rspec.MeasurePolicy(iters=3), **kw).cells()[0]
        cell = E.ExperimentSpec(policy=E.MeasurePolicy(iters=3),
                                **kw).cells()[0]
        want = rcells.measure_schedule_cell(rcell, rm)
        got = cells.measure_schedule_cell(cell, pm, CPU)
        assert set(got) == set(want)
        assert got["nnz"] == want["nnz"] and got["modelled_par_ms"] > 0
    with pytest.raises(ValueError, match="unknown scheduling variant"):
        cells.measure_schedule_cell(
            E.ExperimentSpec(name="s", matrices=("x",), kind="schedule",
                             variants=("dynamic",)).cells()[0], pm, CPU)


def test_campaign_resumes_from_both_stores(stores):
    spec = E.ExperimentSpec(
        name="smoke", matrices=("smoke_banded", "smoke_sbm"),
        schemes=("baseline", "rcm"),
        policy=E.MeasurePolicy(iters=2, warmup=1, with_yax=False,
                               with_parallel=False, verify=True))
    store = E.ResultStore()
    assert store.root == str(stores / "results")
    first = E.Runner(spec, store, verbose=False, device="cpu").run()
    assert first.measured == 4 and first.reused == 0
    assert not any(r["plan_store_hit"] for r in first.records)
    again = E.Runner(spec, store, verbose=False, device="cpu").run()
    assert again.measured == 0 and again.reused == 4
    fresh = E.Runner(spec, E.ResultStore(str(stores / "fresh")),
                     verbose=False, device="cpu").run()
    assert fresh.measured == 4
    assert all(r["plan_store_hit"] and r["op_cache_hit"]
               and r["tune_ms"] == 0.0 for r in fresh.records)
    with obs.tracing() as buf:
        E.Runner(spec, E.ResultStore(str(stores / "traced")), verbose=False,
                 device="cpu").run()
    events = buf.flush()
    names = {e["name"] for e in obs.validate_chrome_trace(
        obs.to_chrome_trace(events)) if e["ph"] == "B"}
    assert {"runner.cell", "plan", "plan.build", "kernel.spmv"} <= names


def test_campaign_smoke_resumes_and_writes_its_summary(stores, monkeypatch,
                                                      capsys):
    from repro_torch.launch import spmv_bench

    monkeypatch.chdir(stores)
    assert spmv_bench.campaign_smoke(device="cpu",
                                     matrices=["smoke_banded"]) == 0
    out = capsys.readouterr().out
    assert out.count("miss+measure") == 2 and "ERROR" not in out
    assert "# resume: 2/2 cells served from the store" in out
    summary = json.loads((stores / report.SUMMARY_PATH).read_text())
    assert not (stores / "benchmarks" / "results" / "BENCH_spmv.json").exists()
    assert summary["campaign"] == "smoke_torch"
    assert (summary["cells"], summary["measured"], summary["failures"]) \
        == (2, 2, 0)
    assert set(summary["geomean"]) == {"baseline", "rcm"}
    assert min(summary["geomean"].values()) > 0
    assert set(summary["speedup_vs_baseline"]) == {"rcm"}
    # the second run is served from the result store: nothing measured
    assert spmv_bench.campaign_smoke(device="cpu",
                                     matrices=["smoke_banded"]) == 0
    assert capsys.readouterr().out.count(",hit") == 2


def test_export_matches_the_references_trace():
    from repro.obs import export as rexport

    with obs.tracing() as buf:
        with obs.span("outer", k=1):
            with obs.span("inner"):
                pass
            with obs.span("zero"):
                pass
    events = buf.flush()
    got, want = obs.to_chrome_trace(events), rexport.to_chrome_trace(events)
    for ev in got["traceEvents"]:
        ev.pop("cat", None)
    for ev in want["traceEvents"]:
        ev.pop("cat", None)
    assert got == want
    assert len(obs.validate_chrome_trace(got)) == 6
    with pytest.raises(ValueError, match="unbalanced"):
        obs.validate_chrome_trace({"traceEvents": [
            {"ph": "B", "name": "x", "ts": 0, "pid": 1, "tid": 1}]})


def test_runner_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = E.ExperimentSpec(name="x", matrices=("smoke_banded",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.Runner(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.run_spec(spec)
    assert E.Runner(spec, device="cpu").device == CPU
