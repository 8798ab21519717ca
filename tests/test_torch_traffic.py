"""The port's open-loop traffic simulator (serving/traffic.py) and the
"serve" cell kind against the JAX package's on the CPU:

- arrival_times, zipf_keys, update_mask, structure_mask and
  _deletion_delta give the reference's schedules bit for bit, for every
  arrival process at two seeds;
- serve_variant encodes to the reference's strings and parses back;
- the reference's own traffic cases, run on the port: schedule statistics,
  validation, run_open_loop accounting every arrival, and the serve cell
  through the Runner, resumed from its result store.
"""
import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

from repro.experiments import cells as rcells
from repro.matrices import generators as RG
from repro.serving import traffic as rtraffic
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.experiments import cells
from repro_torch.matrices import generators as G
from repro_torch.serving import traffic
from repro_torch.serving.traffic import (TrafficPattern, arrival_times,
                                         run_open_loop, structure_mask,
                                         update_mask, zipf_keys)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_TORCH_RESULT_STORE", "results")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    return tmp_path


def _port(rm):
    return CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                     shape=rm.shape)


# -- bit-identical against the reference ---------------------------------
@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("arrival", traffic.ARRIVALS)
def test_schedules_match_reference(arrival, seed):
    kw = dict(arrival=arrival, rate_rps=700.0, requests=300, n_keys=5,
              zipf_s=1.3, update_frac=0.2, structure_frac=0.05, seed=seed)
    p, rp = TrafficPattern(**kw), rtraffic.TrafficPattern(**kw)
    for fn, rfn in ((arrival_times, rtraffic.arrival_times),
                    (zipf_keys, rtraffic.zipf_keys),
                    (update_mask, rtraffic.update_mask),
                    (traffic.structure_mask, rtraffic.structure_mask)):
        got, want = fn(p), rfn(rp)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn


@pytest.mark.parametrize("seed", [0, 11])
def test_deletion_delta_matches_reference(seed):
    rm = RG.power_law(256, alpha=1.8, seed=seed)
    for frac in (0.005, 0.2):
        d = traffic._deletion_delta(_port(rm), np.random.default_rng(seed),
                                    frac)
        rd = rtraffic._deletion_delta(rm, np.random.default_rng(seed), frac)
        assert d.signature() == rd.signature()
        assert np.array_equal(d.del_rows, rd.del_rows)
        assert np.array_equal(d.del_cols, rd.del_cols)


def test_serve_variant_strings_match_reference():
    kws = [{}, dict(arrival="bursty", rate_rps=2000.0, requests=120,
                    n_keys=3, update_frac=0.25, budget_mb=0.02,
                    max_queue=16, window_ms=1.0, overload="degrade-to-k1"),
           dict(arrival="uniform", zipf_s=0.0, rate_rps=37.5)]
    for kw in kws:
        v = cells.serve_variant(**kw)
        assert v == rcells.serve_variant(**kw)
        assert cells._parse_serve_variant(v) == \
            rcells._parse_serve_variant(v)


# -- the reference's cases, on the port -------------------------------------
@pytest.mark.parametrize("arrival", traffic.ARRIVALS)
def test_arrival_times_deterministic_ascending_mean_rate(arrival):
    p = TrafficPattern(arrival=arrival, rate_rps=500.0, requests=400,
                       seed=7)
    t1, t2 = arrival_times(p), arrival_times(p)
    assert np.array_equal(t1, t2)
    assert t1.shape == (400,)
    assert np.all(np.diff(t1) >= 0) and t1[0] > 0
    achieved = p.requests / t1[-1]
    assert 0.6 * p.rate_rps < achieved < 1.6 * p.rate_rps
    if arrival != "uniform":
        assert not np.array_equal(
            t1, arrival_times(TrafficPattern(arrival=arrival,
                                             rate_rps=500.0,
                                             requests=400, seed=8)))


def test_uniform_arrivals_are_evenly_spaced():
    p = TrafficPattern(arrival="uniform", rate_rps=100.0, requests=10)
    assert np.allclose(np.diff(arrival_times(p)), 1.0 / 100.0)


def test_bursty_has_heavier_interarrival_tail_than_uniform():
    p = TrafficPattern(arrival="bursty", rate_rps=1000.0, requests=2000,
                       seed=3)
    gaps = np.diff(arrival_times(p))
    assert gaps.max() > 5 * np.median(gaps)


def test_zipf_keys_skew_toward_key_zero():
    p = TrafficPattern(rate_rps=1.0, requests=2000, n_keys=8, zipf_s=1.5,
                       seed=1)
    k = zipf_keys(p)
    assert k.min() >= 0 and k.max() < 8
    counts = np.bincount(k, minlength=8)
    assert counts[0] > counts[-1] * 2
    flat = np.bincount(zipf_keys(TrafficPattern(
        rate_rps=1.0, requests=2000, n_keys=8, zipf_s=0.0, seed=1)),
        minlength=8)
    assert flat[0] < counts[0]


def test_update_mask_matches_fraction():
    p = TrafficPattern(rate_rps=1.0, requests=5000, update_frac=0.3,
                       seed=2)
    m = update_mask(p)
    assert m.dtype == np.bool_ and m.shape == (5000,)
    assert 0.25 < m.mean() < 0.35
    assert not update_mask(TrafficPattern(rate_rps=1.0, requests=50)).any()


def test_pattern_validation():
    with pytest.raises(ValueError, match="arrival"):
        TrafficPattern(arrival="lognormal")
    with pytest.raises(ValueError):
        TrafficPattern(rate_rps=0.0)
    with pytest.raises(ValueError):
        TrafficPattern(requests=0)
    with pytest.raises(ValueError, match="update_frac"):
        TrafficPattern(update_frac=1.0)


def test_serve_variant_roundtrips_and_elides_defaults():
    assert cells.serve_variant() == "poisson"
    v = cells.serve_variant(arrival="bursty", rate_rps=2000.0, requests=120,
                            n_keys=3, update_frac=0.25, budget_mb=0.02,
                            max_queue=16, window_ms=1.0,
                            overload="degrade-to-k1")
    cfg = cells._parse_serve_variant(v)
    assert cfg["arrival"] == "bursty" and cfg["rate_rps"] == 2000.0
    assert cfg["requests"] == 120 and cfg["n_keys"] == 3
    assert cfg["update_frac"] == 0.25 and cfg["budget_mb"] == 0.02
    assert cfg["max_queue"] == 16 and cfg["window_ms"] == 1.0
    assert cfg["overload"] == "degrade-to-k1"
    assert cfg["zipf_s"] == 1.1
    with pytest.raises(ValueError, match="unknown serve-variant"):
        cells._parse_serve_variant("poisson,x9")


def test_run_open_loop_accounts_every_arrival():
    from repro_torch.serving.spmv_service import SpmvService

    mats = {f"k{i}": G.banded(128, 3, seed=i) for i in range(2)}
    p = TrafficPattern(arrival="poisson", rate_rps=2000.0, requests=60,
                       n_keys=2, update_frac=0.2, structure_frac=0.05,
                       seed=0)
    with SpmvService(max_batch=8, window_ms=1.0, engine="csr",
                     max_queue=16, overload="reject", device="cpu") as svc:
        for k, m in mats.items():
            svc.register(k, m)
        summary = run_open_loop(svc, mats, p)
        svc.flush(timeout=60)
    assert summary["offered"] == 60
    assert (summary["submitted"] + summary["rejected"]
            + summary["updates"] + summary["update_conflicts"]
            + summary["update_errors"] + summary["structure_updates"]
            + summary["structure_conflicts"]
            + summary["structure_errors"]) == 60
    assert (summary["ok"] + summary["shed"] + summary["errors"]
            + summary["unresolved"]) == summary["submitted"]
    assert summary["unresolved"] == summary["replan_unresolved"] == 0
    assert summary["errors"] == summary["replan_errors"] == 0
    assert summary["replans_landed"] == summary["structure_updates"] > 0
    assert summary["retry_after_positive"]
    assert summary["budget_ok"]
    assert summary["stats"]["requests"] == summary["submitted"]
    # the schedule, the submit window and the drain to the last answer
    kinds = structure_mask(p) | update_mask(p)
    assert int((~kinds).sum()) == summary["submitted"] + summary["rejected"]
    assert summary["schedule_s"] == float(arrival_times(p)[-1])
    assert summary["schedule_s"] <= summary["submit_s"] \
        <= summary["drain_s"] <= summary["wall_s"]


def test_run_open_loop_requires_enough_matrices():
    p = TrafficPattern(rate_rps=1.0, requests=1, n_keys=3)
    with pytest.raises(ValueError, match="3 keys"):
        run_open_loop(None, {"only": None}, p)


def test_serve_cell_kind_campaign_resumes():
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)

    spec = ExperimentSpec(
        name="t_serve", matrices=("smoke_banded",),
        schemes=("baseline",), engines=("sell",), ks=(4,),
        kind="serve",
        variants=(cells.serve_variant(rate_rps=1500.0, requests=50,
                                      n_keys=2, budget_mb=0.05,
                                      max_queue=8, window_ms=1.0,
                                      overload="shed-oldest"),),
        policy=MeasurePolicy(iters=1, warmup=0, with_yax=False,
                             with_parallel=False, with_metrics=False))
    store = ResultStore()
    rep = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert rep.measured == 1 and rep.reused == 0
    rec = rep.records[0]
    assert rec["offered"] == 50
    assert rec["unresolved"] == rec["errors"] == 0
    assert rec["counters_balanced"] and rec["budget_ok"]
    assert rec["memory_budget_bytes"] == int(0.05 * (1 << 20))
    assert rec["p50_ms"] <= rec["p95_ms"] <= rec["p99_ms"]
    if rec["shed"] or rec["rejected"]:
        assert rec["retry_after_positive"]
    # launches: a count per kernel (the plain versions run on the CPU)
    assert set(rec["launches"]) >= {"sell_spmv", "sell_spmm"}
    for key, v in rec.items():
        if key != "launches":
            assert isinstance(v, (int, float, bool, str)), key
    rep2 = Runner(spec, store=store, verbose=False, device="cpu").run()
    assert rep2.measured == 0 and rep2.reused == 1
    assert rep2.records[0]["store_reused"]


def test_serve_traffic_cli_on_the_cpu(capsys):
    from repro_torch.launch import spmv_bench

    spmv_bench.main(["--serve-traffic", "--matrix", "smoke_banded",
                     "--requests", "40", "--rate", "2000", "--keys", "2",
                     "--structure-frac", "0.05", "--engine", "csr",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve-traffic] smoke_banded x2 keys" in out
    with pytest.raises(NotImplementedError, match="router and sharded"):
        spmv_bench.main(["--serve-traffic", "--devices", "2",
                         "--device", "cpu"])


def test_serve_traffic_fails_on_a_failed_dispatch(monkeypatch):
    """A batch whose launch raises fails its Futures: the record counts
    the errors, `ok` is False and the CLI exits non-zero."""
    from repro_torch.launch import spmv_bench
    from repro_torch.serving import spmv_service

    def broken(y):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(spmv_service, "_host", broken)
    rec = spmv_bench.run_serve_traffic(
        matrix="smoke_banded", rate_rps=2000.0, requests=20, n_keys=2,
        update_frac=0.0, engine="csr", device="cpu")
    assert rec["errors"] == rec["offered"] - rec["rejected"] > 0
    assert rec["ok_count"] == 0 and rec["counters_balanced"]
    assert not rec["ok"]
    with pytest.raises(SystemExit, match="errors=") as exc:
        spmv_bench.main(["--serve-traffic", "--matrix", "smoke_banded",
                         "--requests", "20", "--rate", "2000", "--keys",
                         "2", "--update-frac", "0", "--engine", "csr",
                         "--device", "cpu"])
    assert "invariants FAILED" in str(exc.value)
