"""The port's corpus-scale driver (repro_torch.bench.corpus_scale) and the
regress CLI (repro_torch.bench.regress) against the JAX package's
(benchmarks/corpus_scale.py, benchmarks/regress.py), on the CPU:

- corpus_scale.smoke on the bundled fixtures passes on both sides: the
  second ingest parses nothing, the learned campaign probes strictly
  fewer candidates than the exhaustive one, the learned pick is within
  1.05x of the exhaustive best on the exhaustive run's own table, and
  the advisor counters move. Candidate timing on a CPU is noise at 1k
  rows, so both sides time every candidate at one constant here: ties
  go to the first candidate timed, as on the card when candidates tie;
- the smoke's probe counts and the learned campaign's plan labels are
  the reference's; a planted pick-quality fault is counted;
- corpus_scale.run writes the reference's CSV header, row keys and
  summary keys, and raises on a stamp that is not representative;
- the regress CLI exits 0 / 1 / 2 / 2 on the four summaries of
  tests/test_obs.py's CLI test, and its defaults are the port's summary
  and the committed card baseline.

The reference is pointed at temporary directories by monkeypatching its
module attributes (RESULTS_DIR, BENCH_CORPUS_PATH) and environment;
nothing under benchmarks/ or the repository root changes.
"""
import copy
import csv
import json
import os

import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REF_ENV = ("REPRO_RESULT_STORE", "REPRO_PLAN_CACHE", "REPRO_OPERATOR_CACHE",
           "REPRO_REORDER_CACHE", "REPRO_MATRIX_CACHE", "REPRO_CORPUS_CACHE")
PORT_ENV = ("REPRO_TORCH_RESULT_STORE", "REPRO_TORCH_PLAN_CACHE",
            "REPRO_TORCH_OPERATOR_CACHE", "REPRO_TORCH_REORDER_CACHE",
            "REPRO_TORCH_RESULTS_DIR", "REPRO_TORCH_CORPUS_CACHE")
SMALL = ("corpus://fix_banded_1k", "corpus://fix_plaw_1k")


def _env(mp, root, names):
    for var in names:
        mp.setenv(var, str(root / var.lower()))


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _constant_timing(mp):
    """Every IOS timing on both sides reads 1 ms a call."""
    from repro.core.measure import ios as rios
    from repro_torch.core.measure import ios

    def const(op, n, k, iters=20, *a, **kw):
        return np.ones(iters)

    mp.setattr(rios, "run_ios_batched", const)
    mp.setattr(ios, "run_ios_batched", const)


@pytest.fixture(scope="module")
def smokes(tmp_path_factory):
    """corpus_scale.smoke, reference and port, with constant timings:
    each side's failure count, then its two campaigns again from its
    store."""
    import benchmarks.common as rcommon
    import benchmarks.corpus_scale as rcs
    from repro_torch.bench import corpus_scale

    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, ref_dir, REF_ENV)
        _env(mp, port_dir, PORT_ENV)
        mp.setattr(rcommon, "RESULTS_DIR", str(ref_dir))
        _constant_timing(mp)
        out["ref"] = rcs.smoke()
        out["port"] = corpus_scale.smoke(device="cpu")
        # both campaigns again, from each side's store
        out["ref_rep"] = rcommon.Runner(
            _learned(rcs), store=rcommon.result_store(),
            verbose=False).run()
        out["port_rep"] = corpus_scale.common.Runner(
            _learned(corpus_scale), store=corpus_scale.common.result_store(),
            verbose=False, device="cpu").run()
        out["ref_ex"] = rcommon.Runner(
            _exhaustive(rcs), store=rcommon.result_store(),
            verbose=False).run()
        out["port_ex"] = corpus_scale.common.Runner(
            _exhaustive(corpus_scale),
            store=corpus_scale.common.result_store(), verbose=False,
            device="cpu").run()
    return out


def _learned(mod):
    return mod.ExperimentSpec(
        name="corpus_smoke_learned", matrices=mod.SMOKE_MATRICES,
        schemes=mod.SMOKE_SCHEMES, engines=("auto",),
        policy=mod._policy("learned", 3))


def _exhaustive(mod):
    return mod.ExperimentSpec(
        name="corpus_smoke_seed", matrices=mod.SMOKE_MATRICES,
        schemes=mod.SMOKE_SCHEMES, engines=("auto",),
        policy=mod._policy("exhaustive", 3))


def test_smoke_passes_on_both_sides(smokes):
    assert smokes["ref"] == 0
    assert smokes["port"] == 0


@pytest.mark.parametrize("phase", ["rep", "ex"])
def test_smoke_campaigns_are_the_references(smokes, phase):
    """The same cells from each store, the same probe counts and the same
    picks."""
    ref, got = smokes[f"ref_{phase}"], smokes[f"port_{phase}"]
    assert ref.measured == got.measured == 0
    key = [(r["matrix"], r["scheme"]) for r in ref.records]
    assert [(r["matrix"], r["scheme"]) for r in got.records] == key
    for g, r in zip(got.records, ref.records):
        for field in ("probed_candidates", "tuner_candidates", "plan_label",
                      "advisor_confidence"):
            assert g.get(field) == r.get(field), (field, g["matrix"])
    if phase == "rep":
        assert all(0 < r["probed_candidates"] < e["probed_candidates"]
                   for r, e in zip(got.records, smokes["port_ex"].records))


def test_smoke_constants_are_the_references():
    import benchmarks.corpus_scale as rcs
    from repro_torch.bench import corpus_scale

    for name in ("SCALE_MATRICES", "SCALE_SCHEMES", "SMOKE_MATRICES",
                 "SMOKE_SCHEMES"):
        assert getattr(corpus_scale, name) == getattr(rcs, name)
    for spec in ("seed_spec", "learned_spec"):
        for quick in (False, True):
            got = getattr(corpus_scale, spec)(quick)
            want = getattr(rcs, spec)(quick)
            assert (got.name, got.matrices, got.schemes) \
                == (want.name, want.matrices, want.schemes)
            assert (got.policy.iters, got.policy.probe) \
                == (want.policy.iters, want.policy.probe)


def test_pick_ratio():
    from repro_torch.bench import corpus_scale

    table = {"csr": 2.0, "sell": 1.0, "bcsr": 1.04}
    assert corpus_scale.pick_ratio(table, "sell") == 1.0
    assert corpus_scale.pick_ratio(table, "bcsr") == pytest.approx(1.04)
    assert corpus_scale.pick_ratio(table, "csr") == 2.0
    assert corpus_scale.pick_ratio(table, "ell") == float("inf")
    assert corpus_scale.pick_ratio({}, "csr") == float("inf")


def test_smoke_counts_a_slow_pick(tmp_path, monkeypatch, capsys):
    """An exhaustive table whose best is twice as fast as every learned
    pick fails each of the four cells' pick-quality check."""
    from repro_torch.bench import corpus_scale

    _env(monkeypatch, tmp_path, PORT_ENV)
    _constant_timing(monkeypatch)
    real = corpus_scale.exhaustive_probe_table

    def slow_picks(matrix, scheme, pol, device=None):
        table = real(matrix, scheme, pol, device)
        return {**{k: 2.0 for k in table}, "a-faster-candidate": 1.0}

    monkeypatch.setattr(corpus_scale, "exhaustive_probe_table", slow_picks)
    assert corpus_scale.smoke(device="cpu") == 4
    out = capsys.readouterr().out
    assert out.count("PICK-QUALITY FAILED") == 4
    assert "PROBE-COUNT FAILED" not in out


def test_second_ingest_parses_nothing(tmp_path, monkeypatch, capsys):
    from repro_torch.bench import corpus_scale

    _env(monkeypatch, tmp_path, PORT_ENV)
    assert corpus_scale._ingest_fixtures() == 0
    out = capsys.readouterr().out
    cached = [ln for ln in out.splitlines() if ln.startswith("# ingest[cached]")]
    assert cached and all(ln.split(": ")[1].startswith("hit") for ln in cached)
    assert any("parsed" in ln for ln in out.splitlines()
               if ln.startswith("# ingest[cold]"))


# -- corpus_scale.run ----------------------------------------------------------
@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """corpus_scale.run, reference and port, on the 1k-row fixtures with
    the representative floor lowered to 1,000 rows (the 131k-row stand-ins
    take minutes a side on a CPU)."""
    import benchmarks.common as rcommon
    import benchmarks.corpus_scale as rcs
    from repro.experiments.report import Report as RReport
    from repro_torch.bench import corpus_scale
    from repro_torch.experiments.report import Report

    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    out = {"ref_dir": ref_dir, "port_dir": port_dir / "repro_torch_results_dir"}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, ref_dir, REF_ENV)
        _env(mp, port_dir, PORT_ENV)
        mp.setattr(rcommon, "RESULTS_DIR", str(ref_dir))
        mp.setattr(rcs, "BENCH_CORPUS_PATH",
                   str(ref_dir / "BENCH_corpus_scale.json"))
        for mod in (rcs, corpus_scale):
            mp.setattr(mod, "SCALE_MATRICES", SMALL)
        for rep in (RReport, Report):
            mp.setattr(rep, "REPRESENTATIVE_MIN_M", 1000)
        out["ref"] = rcs.run(quick=True)
        out["port"] = corpus_scale.run(quick=True, device="cpu")
    return out


def test_run_writes_the_references_csv_and_summary(small_runs):
    from repro_torch.bench import corpus_scale

    assert list(small_runs["port"]) == list(small_runs["ref"])
    assert set(small_runs["port"]["advisor"]) \
        == set(small_runs["ref"]["advisor"])
    assert small_runs["port"]["representative"] is True
    assert small_runs["port"]["max_m"] == small_runs["ref"]["max_m"]
    ref = _read(small_runs["ref_dir"] / "corpus_scale.csv")
    got = _read(small_runs["port_dir"] / corpus_scale.CSV)
    assert got[0] == ref[0] == corpus_scale.HEADER
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    # the seed probes and the tuner's candidates are host decisions
    assert [[r[2], r[4]] for r in got] == [[r[2], r[4]] for r in ref]
    rsum = json.loads((small_runs["ref_dir"]
                       / "BENCH_corpus_scale.json").read_text())
    psum = json.loads((small_runs["port_dir"]
                       / corpus_scale.SUMMARY_NAME).read_text())
    assert set(psum) == set(rsum)
    assert psum["campaign"] == rsum["campaign"] == "corpus_scale"
    assert psum["scale"]["representative"] is True
    assert not (small_runs["port_dir"] / "BENCH_corpus_scale.json").exists()


def test_run_raises_on_a_stamp_not_representative(tmp_path, monkeypatch):
    from repro_torch.bench import corpus_scale

    _env(monkeypatch, tmp_path, PORT_ENV)
    monkeypatch.setattr(corpus_scale, "SCALE_MATRICES", SMALL)
    with pytest.raises(RuntimeError, match="not representative"):
        corpus_scale.run(quick=True, device="cpu")
    stamp = {"scale": {"representative": False, "max_m": 1024}}
    with pytest.raises(RuntimeError, match="max_m=1024"):
        corpus_scale.check_representative(stamp)
    corpus_scale.check_representative({"scale": {"representative": True,
                                                  "max_m": 131072}})


# -- the regress CLI -----------------------------------------------------------
def _summary(geo_base=0.06, geo_rcm=0.05, run_ms=0.14, iters=3):
    """tests/test_obs.py's summary."""
    return {
        "schema": 1, "campaign": "smoke", "field": "seq_ios_gflops",
        "geomean": {"baseline": geo_base, "rcm": geo_rcm},
        "speedup_vs_baseline": {"rcm": geo_rcm / geo_base},
        "scale": {"matrices": ["a", "b"], "max_m": 1024, "iters": iters,
                  "warmup": 1, "use_kernel": "interpret",
                  "representative": False},
        "plan_run": {"median_plan_ms": 4.0, "median_run_ms": run_ms,
                     "median_amortized_ms": 0.2, "amortize_iters": 100},
        "phases": {"median_tune_ms": 1.0},
    }


def _four(tmp_path):
    base, cur = _summary(), _summary()
    slow = copy.deepcopy(cur)
    slow["geomean"] = {k: v / 2 for k, v in slow["geomean"].items()}
    xscale = copy.deepcopy(cur)
    xscale["scale"]["iters"] = 99
    paths = {}
    for name, obj in [("base", base), ("cur", cur), ("slow", slow),
                      ("xscale", xscale)]:
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(obj))
        paths[name] = str(p)
    paths["missing"] = str(tmp_path / "missing.json")
    return paths


@pytest.mark.parametrize("current,code", [("cur", 0), ("slow", 1),
                                          ("xscale", 2), ("missing", 2)])
def test_regress_cli_exit_codes(tmp_path, current, code):
    from repro_torch.bench import regress

    paths = _four(tmp_path)
    argv = ["--baseline", paths["base"], "--current", paths[current]]
    assert regress.main(argv) == code


def test_regress_cli_defaults(tmp_path, monkeypatch):
    """--current defaults to the port's summary under results_dir(),
    --baseline to the committed card baseline beside the module."""
    from repro_torch.bench import regress

    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(regress, "regress_main",
                        lambda argv: seen.append(argv) or 0)
    assert regress.main([]) == 0
    argv = seen[0]
    assert argv[argv.index("--current") + 1] \
        == str(tmp_path / "BENCH_spmv_torch.json")
    base = argv[argv.index("--baseline") + 1]
    assert base == regress.BASELINE
    assert base.endswith(os.path.join("bench", "baseline",
                                      "BENCH_spmv_torch.json"))
    assert os.path.exists(base)
    assert json.load(open(base))["scale"]["representative"] is False
    regress.main(["--current", "x.json", "--rel-tol", "0.5"])
    assert seen[1][:2] == ["--current", "x.json"]
    assert seen[1][-2:] == ["--baseline", regress.BASELINE]
