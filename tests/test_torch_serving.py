"""The port's micro-batching SpmvService (serving/spmv_service.py) on the
CPU:

- for sell, bcsr and csr keys under baseline and rcm, every response of a
  24-request burst equals the JAX package's service's response for the
  same x within 1e-5 relative (f32; the reference runs its Pallas
  kernels in interpret mode);
- the service raises without a card unless given device="cpu", and a
  sharded key (a topology) serves through a ShardedOperator;
- the reference's hardening cases (typed errors, the memory-budgeted LRU,
  admission control and QoS, dynamic matrices, observability, the
  producer stress) and its service cases of the SpMM suite, on the port.
"""
import threading
import time

import jax.numpy as jnp  # noqa: F401 — keeps JAX on the CPU for both
import numpy as np
import pytest
import torch

from repro.matrices import generators as RG
from repro.serving import spmv_service as rservice
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv import opcache
from repro_torch.matrices import generators as G
from repro_torch.serving.errors import (BadRequest, KeyBusy, QueueFull,
                                        RequestShed, RoutedElsewhere,
                                        ServiceClosed, ServiceError,
                                        UnregisteredKey)
from repro_torch.serving.spmv_service import SpmvService, _Reservoir

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


def svc_cpu(**kw):
    return SpmvService(device="cpu", **kw)


def _port(rm):
    return CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                     shape=rm.shape)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-9)


def _mats():
    return {"a": G.banded(256, 4, seed=1),
            "b": G.banded(256, 4, seed=9),
            "c": G.power_law(256, alpha=1.8, seed=3)}


def _force_stop(svc):
    """Tear down a service whose dispatcher is parked in a huge batch
    window without paying the drain."""
    with svc._cv:
        for q in svc._queues.values():
            q.clear()
        svc._queued = 0
        svc._queued_bytes = 0
        svc._stop = True
        svc._cv.notify_all()
    svc._worker.join(timeout=10)


# -- against the reference service ----------------------------------------
def _burst(service, mats, xs):
    with service as svc:
        for key, m in mats.items():
            svc.register(key, m)
        futs = [svc.submit(key, x) for key, x in xs]
        svc.flush(timeout=120)
        out = [np.asarray(f.result(timeout=60), np.float64) for f in futs]
        stats = svc.stats()
    return out, stats


@pytest.mark.parametrize("scheme", ["baseline", "rcm"])
@pytest.mark.parametrize("engine", ["sell", "bcsr", "csr"])
def test_burst_matches_reference_service(engine, scheme):
    rmats = {"banded": RG.shuffle(RG.banded(256, 4, seed=1), seed=2),
             "powerlaw": RG.power_law(384, alpha=1.9, seed=6)}
    rng = np.random.default_rng(0)
    xs = []
    for _ in range(24):
        key = ("banded", "powerlaw")[rng.integers(2)]
        xs.append((key, rng.standard_normal(rmats[key].shape[1])))
    got, stats = _burst(svc_cpu(engine=engine, reorder=scheme, max_batch=8,
                                window_ms=50.0),
                        {k: _port(m) for k, m in rmats.items()}, xs)
    want, _ = _burst(rservice.SpmvService(engine=engine, reorder=scheme,
                                          max_batch=8, window_ms=50.0,
                                          use_kernel="interpret"),
                     rmats, xs)
    for (key, x), g, w in zip(xs, got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-5, key
        assert _rel(g, rmats[key].spmv(x)) <= 1e-4, key
    assert stats["requests"] == 24 and stats["batches"] < 24


def test_service_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpmvService()


def test_sharded_keys_are_not_ported():
    """Sharded keys are ported (the name is kept from when they raised):
    a service-wide topology and a per-key one both serve through a
    ShardedOperator in the original index space, and the router's share
    — updates of a sharded key — raises RoutedElsewhere."""
    from repro_torch.core.spmv.distributed import ShardedOperator
    from repro_torch.core.spmv.topology import Topology

    mat = _mats()["a"]
    x = np.random.default_rng(2).standard_normal(mat.n)
    with svc_cpu(engine="csr", cache=False, reorder="rcm",
                 topology=Topology(devices=4),
                 partition="static") as svc:
        svc.register("a", mat)
        assert _rel(svc.submit("a", x).result(timeout=30),
                    mat.spmv(x)) <= 1e-5
        assert isinstance(svc.operator("a"), ShardedOperator)
        assert svc.operator("a").plan.partitioner == "static"
    with svc_cpu(engine="csr", cache=False) as svc:
        svc.register("a", mat, topology=Topology(devices=2,
                                                 layout="2d_panels"))
        svc.register("b", mat, topology=Topology(devices=1))
        assert _rel(svc.submit("a", x).result(timeout=30),
                    mat.spmv(x)) <= 1e-5
        assert not isinstance(svc.operator("b"), ShardedOperator)
        with pytest.raises(RoutedElsewhere, match="router"):
            svc.update_values("a", mat.vals * 2)
        svc.update_values("b", mat.vals * 2)     # a trivial topology
    assert issubclass(RoutedElsewhere, BadRequest)


# -- typed errors -----------------------------------------------------------
def test_typed_errors_keep_builtin_bases():
    assert issubclass(ServiceClosed, RuntimeError)
    assert issubclass(QueueFull, RuntimeError)
    assert issubclass(RequestShed, QueueFull)
    assert issubclass(KeyBusy, RuntimeError)
    assert issubclass(UnregisteredKey, KeyError)
    assert issubclass(BadRequest, ValueError)
    for c in (ServiceClosed, QueueFull, KeyBusy, UnregisteredKey,
              BadRequest):
        assert issubclass(c, ServiceError)


def test_submit_raises_typed_errors():
    svc = svc_cpu(max_batch=2, window_ms=1.0, engine="csr", cache=False)
    svc.register("a", _mats()["a"])
    with pytest.raises(UnregisteredKey):
        svc.submit("nope", np.zeros(4))
    with pytest.raises(BadRequest):
        svc.submit("a", np.zeros(7))
    with pytest.raises(UnregisteredKey):
        svc.update_values("nope", np.zeros(4))
    with pytest.raises(BadRequest):
        svc.update_values("a", np.zeros(7))
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit("a", np.zeros(256))
    with pytest.raises(ServiceClosed):
        svc.update_values("a", np.zeros(256))


def test_queue_full_carries_retry_after():
    svc = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False,
                  max_queue=2)
    svc.register("a", _mats()["a"])
    x = np.zeros(256)
    for _ in range(2):
        svc.submit("a", x)
    with pytest.raises(QueueFull) as ei:
        svc.submit("a", x)
    assert ei.value.retry_after_ms > 0
    assert "backpressure" in str(ei.value)
    _force_stop(svc)


# -- the memory-budgeted LRU ------------------------------------------------
def test_lru_evicts_under_budget_and_reloads_without_retune():
    mats = _mats()
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr") as probe:
        probe.register("a", mats["a"])
        nb = opcache.operator_nbytes(probe.operator("a"))
    assert nb > 0
    budget = int(2.5 * nb)          # room for two residents, never three
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr",
                 memory_budget_bytes=budget) as svc:
        for k, m in mats.items():
            svc.register(k, m)
        for k in ("a", "b", "c"):
            svc.operator(k)
        s = svc.stats()
        assert s["evictions"] >= 1
        assert s["resident_ops"] <= 2
        assert s["resident_bytes"] <= budget
        assert s["resident_bytes_max"] <= budget
        before = s["op_builds"]
        op = svc.operator("a")
        s2 = svc.stats()
        assert s2["op_builds"] == before + 1
        assert s2["op_reloads"] >= 1
        assert op.build_info["cache_hit"] is True
        assert op.build_info.get("tune_ms", 0.0) == 0.0
        x = np.random.default_rng(0).standard_normal(256)
        y = svc.submit("a", x).result(timeout=30)
        assert _rel(y, mats["a"].spmv(x)) < 1e-4


def test_singleton_over_budget_serves_transiently():
    mats = _mats()
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr",
                 memory_budget_bytes=1) as svc:
        svc.register("a", mats["a"])
        x = np.random.default_rng(1).standard_normal(256)
        y = svc.submit("a", x).result(timeout=30)
        assert _rel(y, mats["a"].spmv(x)) < 1e-4
        s = svc.stats()
    assert s["resident_bytes"] == 0
    assert s["resident_bytes_max"] == 0
    assert s["budget_overruns"] >= 1


# -- admission control + QoS ------------------------------------------------
def test_shed_oldest_fails_oldest_with_request_shed():
    svc = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False,
                  max_queue=2, overload="shed-oldest")
    svc.register("a", _mats()["a"])
    x = np.zeros(256)
    f0 = svc.submit("a", x)
    f1 = svc.submit("a", x)
    f2 = svc.submit("a", x)          # admitted: f0 (oldest) is shed
    assert f0.done()
    with pytest.raises(RequestShed) as ei:
        f0.result(timeout=0)
    assert ei.value.retry_after_ms > 0
    assert not f1.done() and not f2.done()
    s = svc.stats()
    assert s["sheds"] == 1 and s["rejected"] == 0
    assert s["queued"] == 2
    _force_stop(svc)


def test_per_key_overflow_sheds_own_oldest_only():
    svc = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False,
                  max_queue=2, overload="shed-oldest")
    mats = _mats()
    svc.register("lo", mats["a"], priority=0)
    svc.register("hi", mats["b"], priority=1)
    x = np.zeros(256)
    lo0 = svc.submit("lo", x)
    hi0 = svc.submit("hi", x)
    hi1 = svc.submit("hi", x)
    hi2 = svc.submit("hi", x)        # hi full: hi0 (own oldest) is shed
    assert isinstance(hi0.exception(timeout=0), RequestShed)
    assert not (lo0.done() or hi1.done() or hi2.done())
    assert svc.stats()["sheds"] == 1
    _force_stop(svc)


def test_priority_classes_protect_high_under_global_limit():
    svc = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False,
                  max_queue=8, max_queue_global=3, overload="shed-oldest")
    mats = _mats()
    svc.register("lo", mats["a"], priority=0)
    svc.register("hi", mats["b"], priority=1)
    x = np.zeros(256)
    lo0 = svc.submit("lo", x)
    lo1 = svc.submit("lo", x)
    hi0 = svc.submit("hi", x)
    hi1 = svc.submit("hi", x)
    assert isinstance(lo0.exception(timeout=0), RequestShed)
    assert not (lo1.done() or hi0.done() or hi1.done())
    hi2 = svc.submit("hi", x)        # sheds lo1 (global limit again)
    assert isinstance(lo1.exception(timeout=0), RequestShed)
    with pytest.raises(QueueFull):
        svc.submit("lo", x)          # only hi queued: outranked, reject
    s = svc.stats()
    assert s["sheds"] == 2 and s["rejected"] == 1
    assert not (hi0.done() or hi1.done() or hi2.done())
    _force_stop(svc)


def test_degrade_to_k1_drains_instead_of_waiting_windows():
    svc = svc_cpu(max_batch=8, window_ms=60000.0, engine="csr", cache=False,
                  max_queue=4, overload="degrade-to-k1")
    svc.register("a", _mats()["a"])
    x = np.zeros(256)
    futs = [svc.submit("a", x) for _ in range(4)]
    t0 = time.monotonic()
    for f in futs:
        f.result(timeout=30)
    assert time.monotonic() - t0 < 30
    svc.close()


def test_global_queue_and_byte_limits():
    mats = _mats()
    svc = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False,
                  max_queue=8, max_queue_global=3)
    svc.register("a", mats["a"])
    svc.register("b", mats["b"])
    x = np.zeros(256)
    svc.submit("a", x)
    svc.submit("a", x)
    svc.submit("b", x)
    with pytest.raises(QueueFull, match="global"):
        svc.submit("b", x)
    _force_stop(svc)
    svc2 = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False,
                   max_queue=8, max_queue_bytes=3 * x.nbytes)
    svc2.register("a", mats["a"])
    for _ in range(3):
        svc2.submit("a", x)
    with pytest.raises(QueueFull, match="payload"):
        svc2.submit("a", x)
    _force_stop(svc2)


# -- dynamic matrices -------------------------------------------------------
def test_update_values_swaps_without_replan():
    mat = _mats()["a"]
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr") as svc:
        svc.register("a", mat)
        x = np.random.default_rng(2).standard_normal(256)
        y0 = svc.submit("a", x).result(timeout=30)
        plan_before = svc._plans["a"][2]
        builds_before = svc.stats()["op_builds"]
        svc.update_values("a", mat.vals * 3.0)
        y1 = svc.submit("a", x).result(timeout=30)
        s = svc.stats()
        assert s["value_swaps"] == 1
        assert s["replans"] == 0
        assert svc._plans["a"][2] is plan_before
        assert s["op_builds"] == builds_before
        assert svc._build_info["a"].get("value_swap") is True
    assert _rel(y1, 3.0 * mat.spmv(x)) < 1e-4
    assert not np.allclose(y0, y1)


def test_update_structure_background_replan_and_staleness_gate():
    a = G.banded(256, 4, seed=1)
    b = G.power_law(256, alpha=1.8, seed=7)     # different structure
    x = np.random.default_rng(3).standard_normal(256)
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr",
                 cache=False) as svc:
        svc.register("m", a)
        assert np.abs(svc.submit("m", x).result(timeout=30)
                      - a.spmv(x)).max() < 1e-3
        orig = svc._build_operator

        def slow(*args, **kw):
            time.sleep(0.3)
            return orig(*args, **kw)

        svc._build_operator = slow
        fut = svc.update_structure("m", b, staleness_s=0.0)
        y = svc.submit("m", x).result(timeout=30)
        gen = fut.result(timeout=30)
        assert gen == svc._gen["m"]
        assert _rel(y, b.spmv(x)) < 1e-4
        s = svc.stats()
        assert s["replans"] == 1 and s["replan_errors"] == 0
        with pytest.raises(BadRequest):
            svc.update_structure("m", G.banded(128, 4, seed=1))  # shape


def test_update_structure_serves_stale_until_swap():
    a = G.banded(256, 4, seed=1)
    b = G.power_law(256, alpha=1.8, seed=7)
    x = np.random.default_rng(4).standard_normal(256)
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr",
                 cache=False) as svc:
        svc.register("m", a)
        svc.submit("m", x).result(timeout=30)
        orig = svc._build_operator
        started = threading.Event()

        def slow(*args, **kw):
            started.set()
            time.sleep(0.5)
            return orig(*args, **kw)

        svc._build_operator = slow
        fut = svc.update_structure("m", b)     # no staleness bound
        assert started.wait(timeout=10)
        y_stale = svc.submit("m", x).result(timeout=30)
        assert _rel(y_stale, a.spmv(x)) < 1e-4
        fut.result(timeout=30)
        y_new = svc.submit("m", x).result(timeout=30)
        assert _rel(y_new, b.spmv(x)) < 1e-4


def test_update_values_refused_during_replan():
    a = G.banded(256, 4, seed=1)
    b = G.power_law(256, alpha=1.8, seed=7)
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr",
                 cache=False) as svc:
        svc.register("m", a)
        svc.operator("m")
        orig = svc._build_operator
        svc._build_operator = lambda *a_, **k: (time.sleep(0.4),
                                                orig(*a_, **k))[1]
        fut = svc.update_structure("m", b)
        with pytest.raises(KeyBusy):
            svc.update_values("m", a.vals * 2.0)
        with pytest.raises(KeyBusy):
            svc.update_structure("m", b)
        fut.result(timeout=30)


# -- CV wakeups + observability --------------------------------------------
def test_quiescent_service_never_busy_wakes():
    with svc_cpu(max_batch=4, window_ms=2.0, engine="csr",
                 cache=False) as svc:
        svc.register("a", _mats()["a"])
        before = svc.stats()["wakeups"]
        time.sleep(0.5)
        assert svc.stats()["wakeups"] == before
        x = np.zeros(256)
        for _ in range(5):
            svc.submit("a", x)
        svc.flush(timeout=30)
        settled = svc.stats()["wakeups"]
        time.sleep(0.4)
        assert svc.stats()["wakeups"] == settled


def test_latency_percentiles_from_reservoir():
    mat = _mats()["a"]
    with svc_cpu(max_batch=4, window_ms=1.0, engine="csr",
                 cache=False) as svc:
        svc.register("a", mat)
        rng = np.random.default_rng(5)
        futs = [svc.submit("a", rng.standard_normal(256))
                for _ in range(20)]
        svc.flush(timeout=60)
        for f in futs:
            f.result(timeout=10)
        slo = svc.stats()["slo"]
    assert slo["latency_samples"] == 20
    assert 0 < slo["p50_ms"] <= slo["p95_ms"] <= slo["p99_ms"]
    assert slo["throughput_rps"] > 0


def test_reservoir_is_bounded_and_counts_all():
    r = _Reservoir(size=64, seed=0)
    for i in range(5000):
        r.add(float(i))
    assert r.count == 5000
    assert len(r.snapshot()) == 64


def test_stats_snapshot_counters_balance_after_close_drop():
    svc = svc_cpu(max_batch=8, window_ms=60000.0, engine="csr", cache=False)
    svc.register("a", _mats()["a"])
    fut = svc.submit("a", np.zeros(256))
    with pytest.raises(TimeoutError):
        svc.close(timeout=0.05)      # drain cannot finish: window is huge
    assert isinstance(fut.exception(timeout=5), ServiceClosed)
    s = svc.stats()
    assert s["requests"] == s["results"] + s["sheds"] + s["errors"] == 1
    assert s["pending"] == 0


# -- concurrency stress -----------------------------------------------------
@pytest.mark.parametrize("overload", ["reject", "shed-oldest"])
def test_producer_stress_every_future_resolves(overload):
    mats = _mats()
    svc = svc_cpu(max_batch=8, window_ms=1.0, engine="csr", max_queue=16,
                  overload=overload, memory_budget_bytes=1 << 20)
    svc.register("a", mats["a"])
    svc.register("b", mats["b"])
    futures = []
    flock = threading.Lock()

    def produce(tid):
        rng = np.random.default_rng(tid)
        for i in range(30):
            key = ("a", "b")[int(rng.integers(2))]
            try:
                f = svc.submit(key, rng.standard_normal(256))
                with flock:
                    futures.append(f)
            except QueueFull:
                pass
            if i % 10 == 5:
                try:
                    svc.update_values(key, mats[key].vals * (1 + 0.1 * i))
                except (KeyBusy, ServiceClosed):
                    pass

    threads = [threading.Thread(target=produce, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    svc.register("c", mats["c"])             # concurrent registration
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "producer deadlocked"
    svc.close(timeout=60)
    resolved = 0
    for f in futures:
        assert f.done(), "a Future was silently dropped"
        if f.exception(timeout=0) is None:
            resolved += 1
        else:
            assert isinstance(f.exception(timeout=0),
                              (ServiceError, RuntimeError))
    s = svc.stats()
    assert s["requests"] == s["results"] + s["sheds"] + s["errors"]
    assert s["pending"] == 0
    assert resolved == s["results"]
    svc.close(timeout=5)


# -- the SpMM suite's service cases -----------------------------------------
def _service_mats():
    return {"banded": G.banded(256, 4, seed=1),
            "powerlaw": G.power_law(512, alpha=1.9, seed=6)}


def test_service_results_match_unbatched():
    mats = _service_mats()
    rng = np.random.default_rng(0)
    with svc_cpu(max_batch=8, window_ms=100.0) as svc:
        for key, m in mats.items():
            svc.register(key, m)
        pending = []
        for _ in range(24):
            key = ("banded", "powerlaw")[rng.integers(2)]
            x = rng.standard_normal(mats[key].n)
            pending.append((key, x, svc.submit(key, x)))
        svc.flush()
        stats = svc.stats()
        for key, x, fut in pending:
            got = np.asarray(fut.result(timeout=10))
            alone = svc.operator(key)(
                torch.as_tensor(x, dtype=torch.float32)).numpy()
            assert _rel(got, alone) < 1e-5, key
            assert _rel(got, mats[key].spmv(x)) < 1e-4
    assert stats["requests"] == 24
    assert stats["batches"] < 24
    assert stats["batch_size_max"] > 1


def test_service_batches_cap_and_window():
    mats = _service_mats()
    with svc_cpu(max_batch=4, window_ms=150.0, engine="csr",
                 cache=False) as svc:
        svc.register("banded", mats["banded"])
        rng = np.random.default_rng(1)
        futs = [svc.submit("banded", rng.standard_normal(mats["banded"].n))
                for _ in range(11)]
        svc.flush()
        for f in futs:
            f.result(timeout=10)
        s = svc.stats()
    assert s["batch_size_sum"] == 11
    assert s["batch_size_max"] <= 4
    assert 3 <= s["batches"] < 11


def test_service_rejects_unknown_key_and_closed():
    svc = svc_cpu(max_batch=2, window_ms=1.0)
    svc.register("banded", _service_mats()["banded"])
    with pytest.raises(KeyError):
        svc.submit("nope", np.zeros(4))
    with pytest.raises(ValueError):
        svc.submit("banded", np.zeros(255))
    with pytest.raises(ValueError):
        svc.submit("banded", np.zeros((256, 2)))
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit("banded", np.zeros(256))


def test_service_reregister_invalidates_operator():
    a = G.banded(256, 4, seed=1)
    b = G.banded(256, 4, seed=9)
    x = np.random.default_rng(5).standard_normal(256)
    with svc_cpu(max_batch=2, window_ms=1.0, engine="csr",
                 cache=False) as svc:
        svc.register("m", a)
        ya = svc.submit("m", x).result(timeout=10)
        svc.flush()
        svc.register("m", b)
        yb = svc.submit("m", x).result(timeout=10)
    assert np.abs(ya - a.spmv(x)).max() / (np.abs(ya).max() + 1e-9) < 1e-5
    assert np.abs(yb - b.spmv(x)).max() / (np.abs(yb).max() + 1e-9) < 1e-5
    assert not np.allclose(ya, yb)


def test_service_refuses_reregister_with_pending_requests():
    a = G.banded(256, 4, seed=1)
    b = G.banded(256, 4, seed=9)
    svc = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False)
    svc.register("m", a)
    svc.submit("m", np.zeros(256))   # parked in the (huge) batch window
    with pytest.raises(RuntimeError, match="pending"):
        svc.register("m", b)
    _force_stop(svc)


def test_service_backpressure_bounds_queue():
    mats = _service_mats()
    svc = svc_cpu(max_batch=8, window_ms=5000.0, engine="csr", cache=False,
                  max_queue=4)
    svc.register("banded", mats["banded"])
    x = np.zeros(256)
    futs = [svc.submit("banded", x) for _ in range(4)]
    with pytest.raises(RuntimeError, match="backpressure"):
        svc.submit("banded", x)
    _force_stop(svc)
    assert all(not f.done() for f in futs)  # dropped, never mis-resolved


def test_service_uses_k_specialized_plan():
    with svc_cpu(max_batch=16, window_ms=1.0) as svc:
        svc.register("powerlaw", _service_mats()["powerlaw"])
        op = svc.operator("powerlaw")
    assert op.plan.k == 16


def test_serve_sim_end_to_end():
    from repro_torch.launch.spmv_bench import run_serve_sim

    rec = run_serve_sim(matrices=("smoke_banded", "smoke_powerlaw"),
                        requests=12, max_batch=4, window_ms=50.0,
                        engine="csr", device="cpu")
    assert rec["ok"] and rec["batches"] <= 12
    assert rec["coalesce_ratio"] >= 1.0
