"""The port's offline corpus (corpus/{mtxstream,artifact,manifest,advisor,
__main__}.py, matrices/io.py, `corpus://` in matrices/suite.py) and the
learned probe (core/spmv/tune.py, plan.py) against the JAX package's on the
CPU:

- every bundled fixture parses to the reference's CSR arrays, at any
  chunk size; write_mtx/read_mtx and .csrz artifacts cross between the
  packages bit for bit; a corrupt artifact is a miss;
- the manifest, corpus_names() and the stand-ins of the seven smaller
  non-fixture entries are the reference's (the three largest are in
  test_torch_corpus_standins.py);
- suite.get("corpus://...") resolves; the CLI's list, ingest and verify
  run; the corpus package has no download path;
- with the same hand-built records in a temporary ResultStore of each
  package, the learned probe shortlists the same candidates with the same
  confidence, and plan(probe="learned") carries it; with probe=False the
  plans are the reference's and carry no advisor.

Every test runs with its own stores (a temporary directory).
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

from repro.core.spmv import plan as rplan
from repro.core.spmv import tune as rtune
from repro.corpus import advisor as radvisor
from repro.corpus import artifact as rartifact
from repro.corpus import manifest as rmanifest
from repro.corpus import mtxstream as rmtxstream
from repro.experiments.store import ResultStore as RResultStore
from repro.matrices import generators as RG
from repro.matrices import io as rio
from repro.matrices import suite as rsuite
from repro_torch import obs
from repro_torch.core.spmv import plan as tplan
from repro_torch.core.spmv import tune
from repro_torch.corpus import advisor, artifact, manifest, mtxstream
from repro_torch.corpus.__main__ import main as cli
from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                     ResultStore, Runner)
from repro_torch.matrices import generators as G
from repro_torch.matrices import io, suite

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS_PKG = ROOT / "src" / "repro_torch" / "corpus"
FIXTURES = sorted(n for n, e in rmanifest.load_manifest().items()
                  if e.fixture)
LARGEST = ("webbase-1M", "thermal2", "amazon0601")
STANDINS = sorted(n for n, e in rmanifest.load_manifest().items()
                  if not e.fixture and n not in LARGEST)


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_TORCH_RESULT_STORE", "results"),
                     ("REPRO_TORCH_CORPUS_CACHE", "corpus"),
                     ("REPRO_PLAN_CACHE", "ref_plans"),
                     ("REPRO_OPERATOR_CACHE", "ref_opcache"),
                     ("REPRO_REORDER_CACHE", "ref_reorder"),
                     ("REPRO_RESULT_STORE", "ref_results"),
                     ("REPRO_CORPUS_CACHE", "ref_corpus"),
                     ("REPRO_TORCH_MATRIX_CACHE", "matrices"),
                     ("REPRO_MATRIX_CACHE", "ref_matrices")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    monkeypatch.setenv("REPRO_CORPUS_OFFLINE", "1")   # the reference's
    advisor.advisor_reset()
    radvisor.advisor_reset()
    yield tmp_path
    advisor.advisor_reset()
    radvisor.advisor_reset()


def assert_same_csr(got, want):
    assert got.shape == want.shape
    for f in ("rowptr", "cols", "vals"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


def fixture_path(name):
    return os.path.join(manifest.FIXTURE_DIR,
                        manifest.get_entry(name).fixture)


# -- parsing and artifacts ---------------------------------------------------
@pytest.mark.parametrize("chunk_nnz", [None, 7, 1000])
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_parses_to_the_references_csr(name, chunk_nnz):
    path = fixture_path(name)
    ref_path = os.path.join(rmanifest.FIXTURE_DIR,
                            rmanifest.get_entry(name).fixture)
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()               # the same bundled bytes
    got, gstats = mtxstream.parse_mtx(path, chunk_nnz=chunk_nnz)
    want, wstats = rmtxstream.parse_mtx(ref_path, chunk_nnz=chunk_nnz)
    assert_same_csr(got, want)
    assert gstats == wstats
    assert mtxstream.read_header(path) == \
        mtxstream.MtxHeader(**vars(rmtxstream.read_header(ref_path)))
    entry = manifest.get_entry(name)
    assert (got.m, got.n, got.nnz) == (entry.m, entry.n, entry.nnz)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_resolves_and_verifies(name):
    res = manifest.ensure(name)
    rres = rmanifest.ensure(name)
    assert_same_csr(res.mat, rres.mat)
    assert res.key == rres.key and not res.meta.get("standin")
    assert res.meta["features"] == rres.meta["features"]
    assert res.meta["locality"] == rres.meta["locality"]
    assert manifest.ensure(name).cache_hit
    rep = manifest.verify_entry(name)
    assert rep["ok"] and not rep["standin"] and not rep["problems"]


def test_write_and_read_mtx_cross_the_packages(tmp_path):
    rm = RG.power_law(200, alpha=1.8, seed=3)
    mine, theirs = tmp_path / "mine.mtx", tmp_path / "theirs.mtx"
    io.write_mtx(str(mine), G.power_law(200, alpha=1.8, seed=3))
    rio.write_mtx(str(theirs), rm)
    assert mine.read_bytes() == theirs.read_bytes()
    assert_same_csr(io.read_mtx(str(theirs)), rio.read_mtx(str(mine)))
    assert_same_csr(io.read_mtx(str(mine), chunk_nnz=13), rm)


def test_csrz_round_trips_and_crosses_the_packages(tmp_path):
    mat = G.power_law(64, alpha=1.8, seed=4)
    zpath = artifact.save_csrz(str(tmp_path / "a.csrz"), mat)
    assert os.path.exists(zpath) and os.path.exists(zpath + ".json")
    got, meta = artifact.load_csrz(zpath)
    assert_same_csr(got, mat)
    assert meta == rartifact.structural_meta(RG.power_law(64, alpha=1.8,
                                                          seed=4))
    theirs, _ = rartifact.load_csrz(zpath)
    assert_same_csr(theirs, mat)
    rpath = rartifact.save_csrz(str(tmp_path / "r"),
                                RG.banded(50, 3, seed=1))
    assert_same_csr(artifact.load_csrz(rpath)[0], G.banded(50, 3, seed=1))


@pytest.mark.parametrize("corrupt", ["npz", "json", "schema", "missing"])
def test_csrz_corruption_is_a_miss(tmp_path, corrupt):
    zpath = artifact.save_csrz(str(tmp_path / "c.csrz"),
                               G.banded(16, 2, seed=2))
    jpath = zpath + ".json"
    if corrupt == "npz":
        with open(zpath, "wb") as f:
            f.write(b"not a zipfile")
    elif corrupt == "json":
        with open(jpath, "w") as f:
            f.write("{broken")
    elif corrupt == "schema":
        with open(jpath, "w") as f:
            json.dump({"schema": 999, "meta": {}}, f)
    else:
        os.remove(zpath)
    assert artifact.load_csrz(zpath) is None


def test_ingest_parses_once(tmp_path):
    path = str(tmp_path / "src.mtx")
    io.write_mtx(path, G.banded(32, 2, seed=6))

    def parses():
        return obs.snapshot()["counters"].get("corpus.parses", 0)

    p0 = parses()
    cold = artifact.ingest_path(path)
    assert not cold.cache_hit and cold.parse_stats is not None
    warm = artifact.ingest_path(path)
    assert warm.cache_hit and warm.parse_stats is None
    assert warm.key == cold.key == artifact.file_sha256(path)
    assert parses() == p0 + 1
    assert_same_csr(warm.mat, cold.mat)
    assert cold.key == rartifact.ingest_path(path).key


def test_cache_directory_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_CORPUS_CACHE")
    assert artifact.cache_dir() == os.path.join(tempfile.gettempdir(),
                                                "repro_torch_corpus")
    monkeypatch.setenv("REPRO_CORPUS_CACHE", "/elsewhere")  # the reference's
    assert artifact.cache_dir().endswith("repro_torch_corpus")
    monkeypatch.setenv("REPRO_TORCH_CORPUS_CACHE", "off")
    assert not artifact.cache_enabled()
    res = manifest.ensure("fix_ring_pat")
    assert not res.cache_hit and res.artifact == ""


# -- manifest and stand-ins --------------------------------------------------
def test_manifest_is_the_references():
    mine, theirs = manifest.load_manifest(), rmanifest.load_manifest()
    assert list(mine) == list(theirs)
    for name, e in mine.items():
        assert vars(e) == vars(theirs[name]), name
    assert manifest.corpus_names() == rmanifest.corpus_names()
    assert suite.corpus_names() == rsuite.corpus_names()
    assert manifest._STANDIN_VERSION == rmanifest._STANDIN_VERSION
    with open(manifest.MANIFEST_PATH) as a, \
            open(rmanifest.MANIFEST_PATH) as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("name", STANDINS)
def test_standin_is_the_references(name):
    entry, rentry = manifest.get_entry(name), rmanifest.get_entry(name)
    assert manifest._standin_key(entry) == rmanifest._standin_key(rentry)
    assert_same_csr(manifest.standin(entry), rmanifest.standin(rentry))


def test_entry_without_a_local_file_resolves_to_its_standin():
    res = manifest.ensure("corpus://bcsstk17")
    assert res.meta["standin"] and res.meta["source"]["name"] == "bcsstk17"
    assert_same_csr(res.mat, rmanifest.standin(
        rmanifest.get_entry("bcsstk17")))
    again = manifest.ensure("bcsstk17")
    assert again.cache_hit and again.meta["standin"]
    rep = manifest.verify_entry("bcsstk17")
    assert rep["ok"] and rep["standin"]


def test_a_local_mtx_wins_over_the_standin(tmp_path):
    entry = manifest.get_entry("bcsstk17")
    path = manifest.local_mtx_path(entry)
    os.makedirs(os.path.dirname(path))
    io.write_mtx(path, G.banded(100, 2, seed=1))
    with pytest.raises(ValueError, match="stale manifest or wrong file"):
        manifest.ensure("bcsstk17")


def test_suite_resolves_corpus_names():
    got = suite.get("corpus://fix_ring_pat")
    assert_same_csr(got, rsuite.get("corpus://fix_ring_pat"))
    assert "corpus" in suite.TIERS and suite.names("corpus") == []
    with pytest.raises(KeyError, match="fix_bcsstk"):
        suite.get("corpus://no_such_matrix")


# -- no download path --------------------------------------------------------
NETWORK_MODULES = {"urllib", "http", "socket", "ssl", "ftplib", "requests",
                   "tarfile"}


@pytest.mark.parametrize("path", sorted(CORPUS_PKG.glob("*.py")),
                         ids=lambda p: p.name)
def test_corpus_has_no_download_path(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        assert not {n.split(".")[0] for n in names} & NETWORK_MODULES, path
        if isinstance(node, (ast.FunctionDef, ast.Attribute, ast.Name)):
            ident = getattr(node, "name", None) or getattr(node, "attr", None) \
                or getattr(node, "id", None)
            assert ident not in ("fetch", "_download", "urlopen"), path
    assert not hasattr(manifest, "fetch")


# -- CLI ---------------------------------------------------------------------
def test_cli_list(capsys):
    assert cli(["list"]) == 0
    out = capsys.readouterr().out
    assert "corpus://fix_bcsstk" in out and "fixture" in out
    assert "stand-in" in out
    assert cli(["list", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["name"] for r in rows] == rmanifest.corpus_names()


def test_cli_ingest_then_expect_cached(capsys):
    assert cli(["ingest", "--fixtures", "--expect-cached"]) == 1
    capsys.readouterr()
    assert cli(["ingest", "--fixtures", "--expect-cached"]) == 0
    out = capsys.readouterr().out
    assert "cache-hit" in out and "0 parse(s)" in out


def test_cli_verify(capsys):
    assert cli(["verify", "--fixtures"]) == 0
    out = capsys.readouterr().out
    assert all(f"corpus://{n}: ok" in out for n in FIXTURES)
    assert cli(["verify", "corpus://delaunay_n17"]) == 0
    assert "(stand-in)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli(["ingest"])                       # no selection
    with pytest.raises(KeyError):
        cli(["verify", "no_such_matrix"])


def test_cli_runs_as_a_module(stores):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.corpus",
                           "list"], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "corpus://webbase-1M" in proc.stdout


# -- the learned probe -------------------------------------------------------
# (matrix, the decision a prior campaign recorded for it)
KB = (("smoke_banded", {"engine": "ell", "block_shape": [8, 128],
                        "sell_sigma": None}),
      ("smoke_powerlaw", {"engine": "sell", "block_shape": [8, 32],
                          "sell_sigma": 64}),
      ("smoke_rmat", {"engine": "csr", "block_shape": [8, 128],
                      "sell_sigma": None}),
      ("smoke_stencil", {"engine": "bcsr", "block_shape": [8, 128],
                         "sell_sigma": None}))


def seed_stores(ref_root, port_root):
    """The same hand-built records in a ResultStore of each package."""
    rstore, store = RResultStore(str(ref_root)), ResultStore(str(port_root))
    for i, (name, dec) in enumerate(KB):
        feat = rtune.matrix_features(rsuite._CATALOG[name].thunk())
        rec = {"matrix": name, "features": {k: float(v)
                                            for k, v in feat.items()},
               "tuner_decision": dec, "seq_ios_gflops": 1.0 + i}
        rstore.put(f"cell{i}", {"matrix": name}, rec)
        store.put(f"cell{i}", {"matrix": name}, rec)
    return rstore, store


def ranked(mat, k=1):
    feat = tune.matrix_features(mat)
    cands = tune.enumerate_candidates(mat, feat)
    cost = {id(cd): tune.candidate_cost(feat, cd["engine"],
                                        cd["block_shape"], cd["sigma"],
                                        cd.get("sell_pad"), k=k)
            for cd in cands}
    return feat, sorted(cands, key=lambda cd: cost[id(cd)])


def labels(cands):
    return [tune._label(cd["engine"], cd["block_shape"], cd["sigma"])
            for cd in cands]


@pytest.mark.parametrize("query", FIXTURES + ["smoke_sbm"])
def test_advisor_shortlist_is_the_references(stores, query):
    rstore, store = seed_stores(stores / "kb_ref", stores / "kb_port")
    mat = (suite.get(f"corpus://{query}") if query.startswith("fix_")
           else suite.get(query))
    rmat = (rsuite.get(f"corpus://{query}") if query.startswith("fix_")
            else rsuite.get(query))
    feat, cands = ranked(mat)
    rfeat = rtune.matrix_features(rmat)
    assert feat == rfeat
    np.testing.assert_array_equal(advisor.embed(feat), radvisor.embed(rfeat))
    adv, radv = advisor.TuneAdvisor(store), radvisor.TuneAdvisor(rstore)
    assert adv.knowledge_size() == radv.knowledge_size() == len(KB)
    picks, conf, predicted = adv.shortlist(feat, cands)
    rpicks, rconf, rpredicted = radv.shortlist(rfeat, cands)
    assert labels(picks) == labels(rpicks)
    assert (conf, predicted) == (rconf, rpredicted)
    assert 0 < conf <= 1 and 0 < len(picks) < tune.PROBE_TOP_K


@pytest.mark.parametrize("name", ["smoke_powerlaw", "smoke_sbm"])
def test_learned_tune_probes_the_references_shortlist(stores, name):
    rstore, store = seed_stores(stores / "kb_ref", stores / "kb_port")
    mat, rmat = suite.get(name), rsuite.get(name)
    got = tune.tune(mat, probe="learned", advisor=advisor.TuneAdvisor(store),
                    device="cpu")
    want = rtune.tune(rmat, probe="learned",
                      advisor=radvisor.TuneAdvisor(rstore))
    assert got.source == want.source == "learned"
    assert sorted(got.probe_ms) == sorted(want.probe_ms)
    for key in ("confidence", "predicted", "shortlist"):
        assert got.advisor[key] == want.advisor[key], key
    assert isinstance(got.advisor["hit"], bool)
    assert tune.TunePlan.from_json(got.to_json()) == got


def test_learned_plan_carries_the_references_confidence(stores):
    seed_stores(os.environ["REPRO_RESULT_STORE"],
                os.environ["REPRO_TORCH_RESULT_STORE"])
    mat, rmat = suite.get("smoke_sbm"), rsuite.get("smoke_sbm")
    before = obs.snapshot()["counters"]
    pl = tplan.plan(tplan.SpmvProblem(mat), reorder="baseline",
                    probe="learned", cache=False, device="cpu")
    rpl = rplan.plan(rplan.SpmvProblem(rmat), reorder="baseline",
                     probe="learned", cache=False)
    after = obs.snapshot()["counters"]
    assert pl.tune.source == rpl.tune.source == "learned"
    assert pl.advisor_confidence == rpl.advisor_confidence > 0
    assert sorted(pl.tune.probe_ms) == sorted(rpl.tune.probe_ms)
    assert sum(after.get(k, 0) - before.get(k, 0)
               for k in ("advisor.hits", "advisor.misses")) == 1
    assert tplan.Plan.from_json(pl.to_json()).advisor_confidence == \
        pl.advisor_confidence


def test_learned_falls_back_on_an_empty_store():
    before = obs.snapshot()["counters"].get("advisor.fallbacks", 0)
    pl = tplan.plan(tplan.SpmvProblem(G.banded(64, 2, seed=4)),
                    reorder="baseline", probe="learned", cache=False,
                    device="cpu")
    assert obs.snapshot()["counters"].get("advisor.fallbacks", 0) == \
        before + 1
    assert pl.advisor_confidence == 0.0 and pl.tune.source == "probe"
    assert len(pl.tune.probe_ms) == tune.PROBE_TOP_K


def test_probe_modes_and_keys_are_the_references():
    assert tune.PROBE_MODES == rtune.PROBE_MODES
    mat = G.banded(64, 2, seed=4)
    keys = {tplan.plan_key(tplan.SpmvProblem(mat), "baseline", "auto", p, 0)
            for p in tune.PROBE_MODES}
    assert len(keys) == len(tune.PROBE_MODES)
    with pytest.raises(ValueError, match="probe must be one of"):
        tplan.plan(tplan.SpmvProblem(mat), probe="bogus", device="cpu")


# plan(probe=True) on each named matrix in a fresh process: the warm-up
# count after each plan, and the candidates each plan timed
_WARMUP_CODE = """
import json, sys
from repro_torch import obs
from repro_torch.core.spmv import plan as tplan
from repro_torch.matrices import suite
counts, probed = [], []
for name in sys.argv[1:]:
    pl = tplan.plan(tplan.SpmvProblem(suite.get(name)), reorder="baseline",
                    probe=True, cache=False, device="cpu")
    counts.append(obs.counter("probe.warmups").value)
    probed.append(sorted(pl.tune.probe_ms))
print(json.dumps({"counts": counts, "probed": probed}))
"""


def test_probe_warms_its_timing_path_once_a_process(stores):
    """The first probe of a process runs one untimed IOS pass before it
    times its first candidate (probe.warmups 1), and no other probe of the
    process does (still 1 after the second plan); the warm-up adds no
    candidate: each plan times the reference's candidates."""
    names = [f"corpus://{n}" for n in FIXTURES[:2]]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _WARMUP_CODE, *names],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["counts"] == [1, 1]
    for name, probed in zip(names, out["probed"]):
        want = rplan.plan(rplan.SpmvProblem(rsuite.get(name)),
                          reorder="baseline", probe=True, cache=False)
        assert probed == sorted(want.tune.probe_ms)


@pytest.mark.parametrize("name", FIXTURES)
def test_model_plans_are_unchanged(stores, name):
    seed_stores(os.environ["REPRO_RESULT_STORE"],
                os.environ["REPRO_TORCH_RESULT_STORE"])
    mat = suite.get(f"corpus://{name}")
    rmat = rsuite.get(f"corpus://{name}")
    # the auto scheme search permutes rows and columns: square only
    for reorder in ("baseline", "auto")[:1 + (mat.m == mat.n)]:
        pl = tplan.plan(tplan.SpmvProblem(mat), reorder=reorder, cache=False,
                        device="cpu")
        rpl = rplan.plan(rplan.SpmvProblem(rmat), reorder=reorder,
                         cache=False)
        assert pl.scheme == rpl.scheme
        assert pl.tune.label() == rpl.tune.label()
        assert pl.tune.costs == rpl.tune.costs
        assert pl.tune.source == "model" and pl.tune.advisor is None
        assert pl.advisor_confidence == rpl.advisor_confidence == 0.0


def test_a_campaign_seeds_the_learned_probe(stores):
    """A probed campaign on the CPU fills the port's store; the learned
    campaign then probes strictly fewer candidates, mined from it."""
    mats = ("corpus://fix_banded_1k", "corpus://fix_plaw_1k")

    def policy(probe):
        return MeasurePolicy(iters=2, warmup=0, probe=probe, with_yax=False,
                             with_parallel=False, with_metrics=False)

    seeded = Runner(ExperimentSpec(name="seed", matrices=mats,
                                   schemes=("baseline",), engines=("auto",),
                                   policy=policy("exhaustive")),
                    verbose=False, device="cpu").run()
    n_ex = {m: seeded.cell(m, "baseline")["probed_candidates"] for m in mats}
    assert all(v > tune.PROBE_TOP_K for v in n_ex.values())
    advisor.advisor_reset()
    assert advisor.default_advisor().knowledge_size() == len(mats)
    rep = Runner(ExperimentSpec(name="learn", matrices=mats,
                                schemes=("baseline",), engines=("auto",),
                                policy=policy("learned")),
                 verbose=False, device="cpu").run()
    for m in mats:
        rec = rep.cell(m, "baseline")
        assert 0 < rec["probed_candidates"] < n_ex[m]
        assert rec["probed_candidates"] < tune.PROBE_TOP_K
        assert rec["advisor_confidence"] > 0
