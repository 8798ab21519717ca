"""The port's serve and route soaks (repro_torch.bench.run --smoke-serve and
--smoke-route) against the JAX package's (benchmarks/run.py), on the CPU,
on the same smoke matrix:

- each writes its reference's CSV name and header, the same rows (matrix,
  variant) in the same order, and a summary JSON with the same keys;
- every record holds the reference's per-cell invariants on both sides,
  and each side's soak passes its campaign checks and its resume;
- serve_invariants and route_invariants count exactly one failure for
  each planted fault, and a broken record fails the port's soak.

The reference is pointed at temporary directories by monkeypatching its
module attributes (RESULTS_DIR, SERVE_SLO_PATH, ROUTE_SUMMARY_PATH) and
environment; nothing under benchmarks/ changes. Each side has its own
stores.
"""
import json

import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import pytest
import torch

torch.set_num_threads(1)

MATS = ["smoke_banded"]
REF_ENV = ("REPRO_RESULT_STORE", "REPRO_PLAN_CACHE", "REPRO_OPERATOR_CACHE",
           "REPRO_REORDER_CACHE", "REPRO_MATRIX_CACHE")
PORT_ENV = ("REPRO_TORCH_RESULT_STORE", "REPRO_TORCH_PLAN_CACHE",
            "REPRO_TORCH_OPERATOR_CACHE", "REPRO_TORCH_REORDER_CACHE",
            "REPRO_TORCH_RESULTS_DIR")
SOAKS = {"serve": ("smoke_serve_campaign.csv", "serve_slo.json"),
         "route": ("smoke_route_campaign.csv", "route_smoke.json")}


def _env(mp, root, names):
    for var in names:
        mp.setenv(var, str(root / var.lower()))


@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    """Both soaks, reference and port, on MATS: their failure counts and
    output directories."""
    from benchmarks import common as rcommon
    from benchmarks import run as rrun
    from repro_torch.bench import run

    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    out = {"ref_dir": ref_dir, "port_dir": port_dir / "repro_torch_results_dir",
           "ref": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, ref_dir, REF_ENV)
        _env(mp, port_dir, PORT_ENV)
        mp.setattr(rcommon, "RESULTS_DIR", str(ref_dir))
        mp.setattr(rrun, "SERVE_SLO_PATH", str(ref_dir / "serve_slo.json"))
        mp.setattr(rrun, "ROUTE_SUMMARY_PATH",
                   str(ref_dir / "route_smoke.json"))
        out["ref"]["serve"] = rrun.smoke_serve(MATS)
        out["port"]["serve"] = run.smoke_serve(MATS, device="cpu")
        out["ref"]["route"] = rrun.smoke_route(MATS, 8)
        out["port"]["route"] = run.smoke_route(MATS, 8, device="cpu")
    return out


@pytest.mark.parametrize("soak", list(SOAKS))
def test_soak_passes_on_both_sides(soaks, soak):
    assert soaks["ref"][soak] == 0
    assert soaks["port"][soak] == 0


@pytest.mark.parametrize("soak", list(SOAKS))
def test_soak_csv_is_the_references(soaks, soak):
    """Same CSV name and header literal, the same (matrix, variant) rows
    in the same order (a variant holds commas, as in the reference's
    file); route's placement column is the policy asked."""
    from repro_torch.bench import run

    fname, summary = SOAKS[soak]
    header = {"serve": run.SMOKE_SERVE_HEADER,
              "route": run.SMOKE_ROUTE_HEADER}[soak]
    name = {"serve": run.SMOKE_SERVE_CSV, "route": run.SMOKE_ROUTE_CSV}[soak]
    assert name == fname
    lines = {}
    for side in ("ref_dir", "port_dir"):
        lines[side] = (soaks[side] / fname).read_text().splitlines()
        assert lines[side][0] == ",".join(header)
        recs = json.loads((soaks[side] / summary).read_text())["records"]
        assert len(lines[side]) == 1 + len(recs)
        keys = [f"{r['matrix']},{r['variant']}," for r in recs]
        assert all(ln.startswith(k) for ln, k in zip(lines[side][1:], keys))
        if soak == "route":
            assert [r["placement"] for r in recs] == ["bin_pack",
                                                      "comm_aware"]
    assert [ln.split(",")[:2] for ln in lines["port_dir"]] \
        == [ln.split(",")[:2] for ln in lines["ref_dir"]]
    assert len(lines["port_dir"]) == 1 + {"serve": 3, "route": 2}[soak]


@pytest.mark.parametrize("soak", list(SOAKS))
def test_soak_summary_has_the_references_keys(soaks, soak):
    """The summary JSON: the same keys, the same cells, each record with
    the reference's keys (beside the port's launches)."""
    _, fname = SOAKS[soak]
    ref = json.loads((soaks["ref_dir"] / fname).read_text())
    got = json.loads((soaks["port_dir"] / fname).read_text())
    assert set(got) == set(ref) == {"failures", "cells", "records"}
    assert got["failures"] == ref["failures"] == 0
    assert got["cells"] == ref["cells"] == len(got["records"])
    for g, r in zip(got["records"], ref["records"]):
        assert g["variant"] == r["variant"]
        assert set(r) - {"use_kernel"} <= set(g), set(r) - set(g)


@pytest.mark.parametrize("soak", list(SOAKS))
def test_every_record_holds_the_invariants_on_both_sides(soaks, soak):
    from repro_torch.bench import run

    check = {"serve": run.serve_invariants,
             "route": run.route_invariants}[soak]
    _, fname = SOAKS[soak]
    for side in ("ref_dir", "port_dir"):
        recs = json.loads((soaks[side] / fname).read_text())["records"]
        assert recs and all(check(r) == [] for r in recs), side
        if soak == "serve":
            assert run.serve_campaign_faults(recs) == [], side


def test_port_serve_soak_overloads_and_churns_the_lru(soaks):
    """The port's operator bytes overrun the 0.02 MB budget: requests are
    shed or refused, keys are evicted and reloaded, the update mix swaps
    values without a replan."""
    recs = json.loads((soaks["port_dir"] / "serve_slo.json").read_text())[
        "records"]
    assert sum(r["shed"] + r["rejected"] for r in recs) > 0
    assert sum(r["evictions"] for r in recs) > 0
    assert sum(r["op_reloads"] for r in recs) > 0
    degrade = recs[2]
    assert degrade["updates"] > 0 and degrade["value_swaps"] > 0
    assert degrade["replans"] == 0
    assert all(r["resident_bytes_max"] <= r["memory_budget_bytes"]
               for r in recs)


GOOD_SERVE = {"unresolved": 0, "budget_ok": True, "resident_bytes_max": 10,
              "memory_budget_bytes": 20, "counters_balanced": True,
              "errors": 0, "rejected": 3, "shed": 2,
              "retry_after_positive": True}


@pytest.mark.parametrize("fault", [
    {"unresolved": 1}, {"budget_ok": False}, {"counters_balanced": False},
    {"errors": 2}, {"retry_after_positive": False}])
def test_serve_invariants_count_each_fault_once(fault):
    from repro_torch.bench import run

    assert run.serve_invariants(GOOD_SERVE) == []
    assert len(run.serve_invariants({**GOOD_SERVE, **fault})) == 1


def test_serve_invariants_allow_no_retry_after_without_overload():
    from repro_torch.bench import run

    calm = {**GOOD_SERVE, "rejected": 0, "shed": 0,
            "retry_after_positive": False}
    assert run.serve_invariants(calm) == []


@pytest.mark.parametrize("fault,tag", [
    ({"shed": 0, "rejected": 0}, "SOAK UNDERLOADED"),
    ({"evictions": 0}, "SOAK LRU NOT EXERCISED"),
    ({"op_reloads": 0}, "SOAK LRU NOT EXERCISED"),
    ({"replans": 1}, "SOAK VALUE-SWAP FAILED"),
    ({"value_swaps": 0}, "SOAK VALUE-SWAP FAILED")])
def test_serve_campaign_faults_count_each_fault_once(fault, tag):
    from repro_torch.bench import run

    good = {"shed": 1, "rejected": 1, "evictions": 2, "op_reloads": 2,
            "value_swaps": 3, "updates": 3, "replans": 0}
    assert run.serve_campaign_faults([good]) == []
    (line,) = run.serve_campaign_faults([{**good, **fault}])
    assert line.startswith(tag)


def test_serve_soak_counts_a_broken_record(tmp_path, monkeypatch, capsys):
    """A service whose counters do not balance fails each cell of the soak
    (and stops it before the campaign checks and the resume)."""
    from repro_torch.bench import run
    from repro_torch.serving import spmv_service

    _env(monkeypatch, tmp_path, PORT_ENV)
    real = spmv_service.SpmvService.stats

    def unbalanced(self):
        st = real(self)
        return {**st, "results": st["results"] + 1}

    monkeypatch.setattr(spmv_service.SpmvService, "stats", unbalanced)
    assert run.smoke_serve(MATS, device="cpu") == 3
    out = capsys.readouterr().out
    assert out.count("SOAK INVARIANT FAILED") == 3
    assert "stats counters do not balance" in out
    assert "# resume" not in out and "SOAK UNDERLOADED" not in out


def test_smoke_route_spec_takes_devices():
    """Two meshes of max(2, min(4, devices // 2)) devices, as the
    reference's spec."""
    from benchmarks import run as rrun
    from repro_torch.bench import run

    for devices in (2, 4, 8, 16):
        got = run.smoke_route_spec(MATS, devices)
        want = rrun.smoke_route_spec(MATS, devices)
        assert got.name == want.name == "smoke_route"
        assert got.variants == want.variants
        assert run.route_mesh_devices(devices) == max(2, min(4, devices // 2))
    assert run.smoke_serve_spec(MATS).variants \
        == rrun.smoke_serve_spec(MATS).variants
    assert run.smoke_serve_spec().name == "smoke_serve"
