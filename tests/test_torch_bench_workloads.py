"""The port's workload drivers (repro_torch.bench.workloads and
moe_dispatch) against the JAX package's (benchmarks/workloads.py and
moe_dispatch.py), on the CPU, on the same streams:

- each writes its reference's CSV names and header literals, the same rows
  (workload, kind, scenario, scheme / config, dispatch) in the same order,
  and a summary with the same keys;
- the host-only columns are bit for bit the reference's: the workloads'
  steps, li_mean, drop_frac, plans, replans, rebuilds and reuses;
  moe_dispatch's router_li and drop_frac;
- the smoke's amortization invariants pass on both sides, and
  workload_invariants counts each planted fault once;
- bench.run: --only workloads reaches its driver, --smoke-workloads runs
  the smoke, roofline runs on request only (ON_REQUEST), and --trace
  writes a valid trace.

The reference is pointed at temporary directories by monkeypatching its
module attributes (RESULTS_DIR) and environment; nothing under
benchmarks/ changes. Each side has its own stores.
"""
import csv
import json

import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import pytest
import torch

torch.set_num_threads(1)

REF_ENV = ("REPRO_RESULT_STORE", "REPRO_PLAN_CACHE", "REPRO_OPERATOR_CACHE",
           "REPRO_REORDER_CACHE", "REPRO_MATRIX_CACHE")
PORT_ENV = ("REPRO_TORCH_RESULT_STORE", "REPRO_TORCH_PLAN_CACHE",
            "REPRO_TORCH_OPERATOR_CACHE", "REPRO_TORCH_REORDER_CACHE",
            "REPRO_TORCH_RESULTS_DIR")
# csv -> (row-key columns, host-only columns)
CSVS = {
    "workloads.csv": ((0, 1, 2, 3), (4, 5, 6, 9, 10, 11, 12)),
    "smoke_workloads_campaign.csv": ((0, 1, 2, 3), (4, 5, 6, 9, 10, 11, 12)),
    "moe_dispatch.csv": ((0, 1), (3, 4)),
}


def _env(mp, root, names):
    for var in names:
        mp.setenv(var, str(root / var.lower()))


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """workloads.run, workloads.smoke and moe_dispatch.run, reference and
    port, at the quick sizes."""
    import benchmarks.common as rcommon
    import benchmarks.moe_dispatch as rmoe
    import benchmarks.workloads as rwl
    from repro_torch.bench import moe_dispatch, workloads

    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    out = {"ref_dir": ref_dir, "port_dir": port_dir / "repro_torch_results_dir",
           "ref": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, ref_dir, REF_ENV)
        _env(mp, port_dir, PORT_ENV)
        for mod in (rcommon, rwl, rmoe):
            mp.setattr(mod, "RESULTS_DIR", str(ref_dir))
        out["ref"]["run"] = rwl.run(quick=True)
        out["port"]["run"] = workloads.run(quick=True, device="cpu")
        out["ref"]["smoke"] = rwl.smoke()
        out["port"]["smoke"] = workloads.smoke(device="cpu")
        out["ref"]["moe"] = rmoe.run(quick=True)
        out["port"]["moe"] = moe_dispatch.run(quick=True, device="cpu")
    return out


@pytest.mark.parametrize("fname", list(CSVS))
def test_csv_is_the_references(runs, fname):
    """The same header literal and row keys in the same order; the
    host-only columns bit for bit."""
    keys, exact = CSVS[fname]
    ref = _read(runs["ref_dir"] / fname)
    got = _read(runs["port_dir"] / fname)
    assert got[0] == ref[0]
    assert len(got) == len(ref) > 1
    for g, r in zip(got[1:], ref[1:]):
        assert [g[i] for i in keys] == [r[i] for i in keys]
        assert [g[i] for i in exact] == [r[i] for i in exact], (g, r)


def test_headers_and_names_are_the_reference_literals(runs):
    import benchmarks.workloads as rwl
    from repro_torch.bench import moe_dispatch, workloads

    assert workloads.CSV_HEADER == rwl.CSV_HEADER
    assert workloads.CSV == "workloads.csv"
    assert workloads.SMOKE_CSV == "smoke_workloads_campaign.csv"
    assert moe_dispatch.CSV == "moe_dispatch.csv"
    assert moe_dispatch.HEADER == _read(runs["ref_dir"]
                                        / "moe_dispatch.csv")[0]
    assert (workloads.SMOKE_MOE, workloads.SMOKE_ATTN, workloads.SMOKE_GNN) \
        == (rwl.SMOKE_MOE, rwl.SMOKE_ATTN, rwl.SMOKE_GNN)


@pytest.mark.parametrize("what", ["run", "moe"])
def test_summary_has_the_references_keys(runs, what):
    assert list(runs["port"][what]) == list(runs["ref"][what])


def test_host_only_summary_values_are_the_references(runs):
    for key in ("verify_ok_all", "static_replans_total"):
        assert runs["port"]["run"][key] == runs["ref"]["run"][key]
    assert runs["port"]["run"]["verify_ok_all"] is True
    assert runs["port"]["run"]["static_replans_total"] == 0
    for key, val in runs["ref"]["moe"].items():
        if key.endswith(("_router_li", "_dispatch_agree")):
            assert runs["port"]["moe"][key] == val, key


def test_smoke_passes_on_both_sides(runs):
    assert runs["ref"]["smoke"] == 0
    assert runs["port"]["smoke"] == 0


@pytest.mark.parametrize("spec", ["moe_spec", "structured_spec",
                                  "moe_dispatch_spec"])
def test_specs_are_the_references(spec):
    import benchmarks.workloads as rwl
    from repro_torch.bench import workloads

    args = (("workload://moe-e8-k2-t64-d8-n2",) if spec != "moe_dispatch_spec"
            else 2048)
    got, want = getattr(workloads, spec)(args), getattr(rwl, spec)(args)
    for field in ("name", "matrices", "schemes", "engines", "kind",
                  "variants"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.policy.iters == want.policy.iters
    assert got.policy.verify and want.policy.verify


GOOD = {"variant": "static", "kind": "moe", "verify_ok": True,
        "dispatch_bitwise_equal": True, "dispatch_agree": True,
        "replans": 0, "reuse_rate": 0.5}


@pytest.mark.parametrize("fault", [
    {"verify_ok": False}, {"dispatch_bitwise_equal": False},
    {"dispatch_agree": False}, {"replans": 2}, {"reuse_rate": 0.0},
    {"kind": "gnn", "variant": "shift1", "replans": 2}])
def test_workload_invariants_count_each_fault_once(fault):
    from repro_torch.bench import workloads

    assert workloads.workload_invariants(GOOD) == []
    assert workloads.workload_invariants(
        {**GOOD, "kind": "gnn", "variant": "shift1", "replans": 1}) == []
    assert len(workloads.workload_invariants({**GOOD, **fault})) == 1


# -- bench.run ---------------------------------------------------------------
def test_run_only_workloads_reaches_the_driver(tmp_path, monkeypatch,
                                               capsys):
    from repro_torch.bench import run

    assert run.ON_REQUEST == ("roofline",)
    assert "roofline" not in run.MODULES
    assert {"workloads", "moe_dispatch", "corpus_scale"} <= set(run.MODULES)
    _env(monkeypatch, tmp_path, PORT_ENV)
    seen = []
    monkeypatch.setattr("repro_torch.bench.workloads.run",
                        lambda quick=False, device=None:
                        seen.append((quick, device)) or {"ok": 1})
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "workloads", "--quick", "--device", "cpu"])
    assert e.value.code == 0
    assert seen == [(True, "cpu")]
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("workloads,") and last.endswith('{"ok": 1}"')


def test_run_smoke_workloads_resumes(tmp_path, monkeypatch, capsys):
    from repro_torch.bench import run, workloads

    _env(monkeypatch, tmp_path, PORT_ENV)
    with pytest.raises(SystemExit) as e:
        run.main(["--smoke-workloads", "--matrices", workloads.SMOKE_GNN,
                  "--device", "cpu"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "# resume: 6/6 cells served from the store" in out
    rows = _read(tmp_path / "repro_torch_results_dir" / workloads.SMOKE_CSV)
    assert rows[0] == workloads.CSV_HEADER and len(rows) == 7


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_run_trace_writes_events(tmp_path, monkeypatch, capsys, suffix):
    from repro_torch.bench import run
    from repro_torch.obs.export import validate_chrome_trace

    _env(monkeypatch, tmp_path, PORT_ENV)
    path = str(tmp_path / f"trace{suffix}")
    with pytest.raises(SystemExit) as e:
        run.main(["--smoke-serve", "--device", "cpu", "--trace", path])
    assert e.value.code == 0
    assert f"-> {path}" in capsys.readouterr().out
    if suffix == ".jsonl":
        with open(path) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
    else:
        events = [e for e in validate_chrome_trace(path) if e["ph"] == "B"]
    names = {e["name"] for e in events}
    assert {"serve.dispatch", "plan"} <= names
