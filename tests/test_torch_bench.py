"""The port's figure drivers (repro_torch.bench) against the JAX package's
(benchmarks/) on the CPU, on the same smoke matrices:

- every driver writes its reference's CSV file names and headers, the same
  row keys in the same order, and a summary with the same keys;
- the host-only columns are bit for bit the reference's: bell_formats'
  fill, block counts, FLOP overhead and x-tiles; the li of figs. 9-10; the
  locality cells' bandwidth, cut volume and li; the fig. 1 cells' m and
  nnz;
- every time column is finite and positive;
- run.py --smoke and --smoke-parallel pass their resume check and write
  their CSVs (the reference's headers) and summary under the port's
  results directory;
- run_single is a Runner cell: a repeat call measures nothing, --fresh
  measures again, and its record file and keys are the reference's (plus
  verify_twin_rel_err and launches).

The reference drivers are pointed at the smoke matrices and at temporary
directories by monkeypatching their module attributes and environment;
nothing under benchmarks/ changes. Each side has its own stores.
"""
import csv
import importlib
import json
import math
import os

import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MATS = ["smoke_banded", "smoke_stencil"]

# driver -> [(csv, row-key columns, host-only columns, time columns)];
# spmm_batch's host-only columns are the tuner's decisions
CSVS = {
    "fig01_banded_shuffle": [("fig01_banded_shuffle.csv", (0,), (1, 2),
                              (3, 4))],
    "fig03_ios_yax": [("fig03_ios_yax_cdf.csv", (0,), (), (1, 2))],
    "fig04_scheduling": [("fig04_scheduling.csv", (0, 1), (), (2, 3))],
    "fig05_profiles": [("fig05_profiles.csv", (0, 1, 2), (), ())],
    "fig06_speedup_stacks": [("fig06_speedup_stacks.csv", (0, 1, 2), (),
                              ())],
    "fig07_pairwise": [("fig07_pairwise.csv", (0, 1, 2), (), ())],
    "fig08_consistency": [("fig08_consistency.csv", (0, 1, 2), (), ())],
    "fig09_10_load_imbalance": [
        ("fig09_load_imbalance.csv", (0, 1), (2,), ()),
        ("fig10_relative_li.csv", (0, 1), (2,), ())],
    "fig11_nnz_balanced": [("fig11_nnz_balanced.csv", (0, 1), (), (2,))],
    "table1_rcm_vs_metis": [("table1_rcm_vs_metis.csv", (0,), (), ())],
    "summarize_repro": [],
    "spmm_batch": [("spmm_batch.csv", (0, 1, 2, 5), (3, 4), (6, 7, 8))],
    "bell_formats": [("bell_formats.csv", (0, 1), (2, 3, 4, 5), ())],
}
DRIVERS = list(CSVS)
REF_ENV = ("REPRO_RESULT_STORE", "REPRO_PLAN_CACHE", "REPRO_OPERATOR_CACHE",
           "REPRO_REORDER_CACHE", "REPRO_MATRIX_CACHE")
PORT_ENV = ("REPRO_TORCH_RESULT_STORE", "REPRO_TORCH_PLAN_CACHE",
            "REPRO_TORCH_OPERATOR_CACHE", "REPRO_TORCH_REORDER_CACHE",
            "REPRO_TORCH_RESULTS_DIR")


def _env(mp, root, names):
    for var in names:
        mp.setenv(var, str(root / var.lower()))


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _run_reference(name):
    mod = importlib.import_module(f"benchmarks.{name}")
    if name == "spmm_batch":
        return mod.run(smoke=True)
    return mod.run(quick=True)


def _run_port(name):
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    if name == "spmm_batch":
        return mod.run(smoke=True, device="cpu")
    kw = {"device": "cpu", "quick": True}
    if name == "fig01_banded_shuffle":
        return mod.run(**kw)
    return mod.run(matrices=MATS, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every driver, reference and port, on MATS; returns the results
    directories and each side's summaries."""
    from benchmarks import common as rcommon
    from repro.matrices import suite as rsuite
    from repro_torch.bench import fig01_banded_shuffle

    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    out = {"ref_dir": ref_dir, "ref": {}, "port": {},
           "port_dir": port_dir / "repro_torch_results_dir"}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, ref_dir, REF_ENV)
        _env(mp, port_dir, PORT_ENV)
        mp.setattr(rsuite, "locality_names", lambda: list(MATS))
        mp.setattr(rsuite, "bench_names", lambda: list(MATS))
        mp.setattr(rcommon, "CONSISTENCY_MATRICES", list(MATS))
        mp.setattr(rcommon, "RESULTS_DIR", str(ref_dir))
        mp.setattr(fig01_banded_shuffle, "MATRICES", tuple(MATS))
        for name in DRIVERS:
            mod = importlib.import_module(f"benchmarks.{name}")
            if hasattr(mod, "RESULTS_DIR"):
                mp.setattr(mod, "RESULTS_DIR", str(ref_dir))
            if name == "fig01_banded_shuffle":
                mp.setattr(mod, "MATRICES", tuple(MATS))
            out["ref"][name] = _run_reference(name)
            out["port"][name] = _run_port(name)
        out["ref_reports"], out["port_reports"] = _reports()
    return out


def _reports():
    """The locality and fig. 9 campaigns again (every cell from each
    side's store), for the records' structural fields."""
    from benchmarks import common as rcommon
    from benchmarks import fig09_10_load_imbalance as rfig9
    from repro_torch.bench import common, fig09_10_load_imbalance as fig9

    ref = {"locality": rcommon.campaign_report(rcommon.locality_spec(),
                                               verbose=False),
           "fig9": rcommon.campaign_report(rfig9.spec(True), verbose=False)}
    port = {"locality": common.campaign_report(
        common.locality_spec(matrices=MATS), verbose=False, device="cpu"),
        "fig9": common.campaign_report(fig9.spec(True, MATS),
                                       verbose=False, device="cpu")}
    for rep in list(ref.values()) + list(port.values()):
        assert rep.measured == 0
    return ref, port


def _keys(d):
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_matches_the_reference(runs, name):
    """Same CSV names, headers, row keys (in order) and summary keys;
    host-only columns bit for bit; time columns finite and positive."""
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    assert _keys(runs["port"][name]) == _keys(runs["ref"][name])
    for fname, keys, exact, times in CSVS[name]:
        ref = _read(runs["ref_dir"] / fname)
        got = _read(os.path.join(runs["port_dir"], fname))
        assert got[0] == ref[0]
        assert fname in (getattr(mod, "CSV", None),
                         getattr(mod, "CSV_RELATIVE", None))
        assert len(got) == len(ref) > 1
        for g, r in zip(got[1:], ref[1:]):
            assert [g[i] for i in keys] == [r[i] for i in keys]
            assert [g[i] for i in exact] == [r[i] for i in exact]
            for i in times:
                if g[i] != "" or r[i] != "":
                    v = float(g[i])
                    assert math.isfinite(v) and v > 0, (fname, g)


def test_driver_headers_are_the_reference_literals(runs):
    """Each driver's HEADER constant is the header its reference wrote."""
    for name, specs in CSVS.items():
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        heads = [getattr(mod, "HEADER", None),
                 getattr(mod, "HEADER_RELATIVE", None)]
        for fname, *_ in specs:
            assert _read(runs["ref_dir"] / fname)[0] in heads


@pytest.mark.parametrize("field", ["bandwidth", "cut_volume", "li_static",
                                   "li_nnz_balanced", "avg_row_bandwidth",
                                   "block_fill_8x128"])
def test_locality_structure_is_the_references(runs, field):
    from repro_torch.bench import common

    schemes = common.SCHEMES
    got = runs["port_reports"]["locality"].grid(field, MATS, schemes)
    want = runs["ref_reports"]["locality"].grid(field, MATS, schemes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", ["li", "cut_volume", "halo_width"])
def test_fig9_partition_metrics_are_the_references(runs, field):
    from repro_torch.bench import common

    got = runs["port_reports"]["fig9"].grid(field, MATS, common.SCHEMES)
    want = runs["ref_reports"]["fig9"].grid(field, MATS, common.SCHEMES)
    np.testing.assert_array_equal(got, want)


def test_summarize_repro_refuses_to_measure(tmp_path, monkeypatch):
    from repro_torch.bench import summarize_repro

    _env(monkeypatch, tmp_path, PORT_ENV)
    with pytest.raises(RuntimeError, match="locality campaign incomplete"):
        summarize_repro.run(matrices=MATS, device="cpu")
    assert not os.path.exists(tmp_path / "repro_torch_result_store")


# -- run.py ------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["--smoke", "--smoke-parallel"])
def test_run_smoke_resumes_and_writes_under_the_results_dir(
        tmp_path, monkeypatch, capsys, mode):
    from repro_torch.bench import run

    _env(monkeypatch, tmp_path, PORT_ENV)
    argv = [mode, "--matrices", "smoke_banded,smoke_powerlaw",
            "--device", "cpu"]
    if mode == "--smoke-parallel":
        argv += ["--devices", "4"]
    with pytest.raises(SystemExit) as e:
        run.main(argv)
    assert e.value.code == 0
    out = capsys.readouterr().out
    ncells = 4 if mode == "--smoke" else 8
    assert f"# resume: {ncells}/{ncells} cells served from the store" in out
    res = tmp_path / "repro_torch_results_dir"
    if mode == "--smoke":
        rows = _read(res / run.SMOKE_CSV)
        assert rows[0] == run.SMOKE_HEADER == [
            "matrix", "scheme", "engine", "plan_label", "seq_ios_ms",
            "seq_ios_gflops", "verify_rel_err"]
        summary = json.loads((res / run.SUMMARY_NAME).read_text())
        assert summary["cells"] == ncells and summary["failures"] == 0
    else:
        rows = _read(res / run.SMOKE_PARALLEL_CSV)
        assert rows[0] == run.SMOKE_PARALLEL_HEADER == [
            "matrix", "scheme", "layout", "partitioner", "engine",
            "comm_schedule", "comm_bytes_per_spmv", "li", "modelled_par_ms",
            "verify_rel_err"]
    assert len(rows) == ncells + 1
    assert not (res / "BENCH_spmv.json").exists()
    assert all(float(r[-1]) < 1e-4 for r in rows[1:])


def test_run_only_and_matrices_reach_the_driver(tmp_path, monkeypatch,
                                                capsys):
    from repro_torch.bench import run

    _env(monkeypatch, tmp_path, PORT_ENV)
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "fig09_10_load_imbalance", "--matrices",
                  "smoke_banded", "--device", "cpu"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("fig09_10_load_imbalance,")
    rows = _read(tmp_path / "repro_torch_results_dir"
                 / "fig09_load_imbalance.csv")
    assert {r[0] for r in rows[1:]} == {"smoke_banded"}
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "fig99", "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown" in capsys.readouterr().err
    # the roofline runs on request (no dry-run records here: no rows)
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "roofline", "--device", "cpu"])
    assert e.value.code == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("roofline,") and '"cells_ok": 0' in last


# -- run_single ------------------------------------------------------------
def test_run_single_is_a_runner_cell_with_the_references_record(
        tmp_path, monkeypatch):
    from repro.launch import spmv_bench as rbench
    from repro_torch import obs
    from repro_torch.launch import spmv_bench

    _env(monkeypatch, tmp_path / "port", PORT_ENV)
    _env(monkeypatch, tmp_path / "ref", REF_ENV)
    monkeypatch.setattr(rbench, "RESULTS", str(tmp_path / "ref_results"))
    want = rbench.run_single("smoke_powerlaw", "rcm", iters=2, k=4)
    writes = obs.counter("result_store.writes")
    n0 = writes.value
    first = spmv_bench.run_single("smoke_powerlaw", "rcm", iters=2, k=4,
                                  device="cpu")
    assert writes.value == n0 + 1 and not first["store_hit"]
    again = spmv_bench.run_single("smoke_powerlaw", "rcm", iters=2, k=4,
                                  device="cpu")
    assert writes.value == n0 + 1 and again["store_hit"]
    assert again["spmv_ios_ms"] == first["spmv_ios_ms"]
    fresh = spmv_bench.run_single("smoke_powerlaw", "rcm", iters=2, k=4,
                                  device="cpu", use_store=False)
    assert writes.value == n0 + 2 and not fresh["store_hit"]
    assert set(first) == set(want) | {"verify_twin_rel_err", "launches"}
    name = "spmv_single_smoke_powerlaw_rcm_k4.json"
    assert os.listdir(tmp_path / "ref_results") == [name]
    port_files = [f for f in os.listdir(
        tmp_path / "port" / "repro_torch_results_dir")
        if f.endswith(".json")]
    assert port_files == [name]
    rec = json.loads((tmp_path / "port" / "repro_torch_results_dir"
                      / name).read_text())
    assert rec == json.loads(json.dumps(fresh))
    for key in ("resolved_scheme", "engine", "plan_label", "k"):
        assert first[key] == want[key], key


def test_run_single_cli_defaults_to_the_references_iters(monkeypatch):
    from repro_torch.launch import spmv_bench

    seen = {}
    monkeypatch.setattr(spmv_bench, "run_single",
                        lambda *a, **kw: seen.update(kw))
    spmv_bench.main(["--matrix", "smoke_banded", "--device", "cpu"])
    assert seen["iters"] == 12
