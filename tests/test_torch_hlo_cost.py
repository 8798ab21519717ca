"""The port's dispatch counter (`launch/hlo_cost.py`, `launch/hlo.py`)
against closed forms, as `tests/test_hlo_cost.py` holds the reference's
HLO walker, and against the reference's walker on the same programs.

- flops within 5% of the closed form: one matmul 2n^3, a loop of `trips`
  matmuls trips * 2n^3 (eager loops unroll: no trip count to apply),
  nested loops, an einsum 2bmkn; bytes at least trips * 3n^2 * 4 for a
  loop of tanh(c @ w);
- exact bytes: a view moves nothing; a one-token write into a [B, S, H, D]
  cache moves the token twice, not the cache (copy_ into a slice,
  index_put_, slice_scatter); a slice read (index, embedding,
  index_select, gather) moves its indices, the slice and the result;
- each c10d kind on a fake group of 8 (and on a group of 4 of a (2, 4)
  mesh, whose size the op's ProcessGroup argument gives) has the operand
  and wire bytes of the reference's conventions, among them
  `test_hlo_parse.py`'s all-reduce of 2048 f32 over g = 8;
- the private fake process group is pinned (its import, its meta-device
  point-to-point);
- a matmul and an einsum through the reference's `analyze_text` (jit on
  the CPU) and the port's `analyze`: flops within 5%.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import hlo as HLO
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch.mesh import fake_group, make_mesh


def _zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _close(got, want):
    return abs(got - want) / want < 0.05


def _matmul_loop(x, w, trips):
    for _ in range(trips):
        x = x @ w
    return x


def test_single_matmul():
    n = 128
    rec = HC.analyze(lambda a, b: a @ b, _zeros(n, n), _zeros(n, n))
    assert _close(rec["flops"], 2 * n ** 3)
    assert set(rec) == {"flops", "bytes", "collectives"}


def test_loop_counts_every_trip():
    n, trips = 64, 12
    rec = HC.analyze(_matmul_loop, _zeros(n, n), _zeros(n, n), trips)
    assert _close(rec["flops"], trips * 2 * n ** 3), rec["flops"]


def test_nested_loops():
    n, outer, inner = 32, 5, 7

    def f(x, w):
        for _ in range(outer):
            x = _matmul_loop(x, w, inner)
        return x

    rec = HC.analyze(f, _zeros(n, n), _zeros(n, n))
    assert _close(rec["flops"], outer * inner * 2 * n ** 3), rec["flops"]


def test_einsum_contraction():
    b, m, k, n = 4, 32, 48, 56
    rec = HC.analyze(lambda a, w: torch.einsum("bmk,kn->bmn", a, w),
                     _zeros(b, m, k), _zeros(k, n))
    assert _close(rec["flops"], 2 * b * m * k * n)


def test_bytes_nonzero_and_scaled_by_the_loop():
    n, trips = 64, 9

    def f(x, w):
        for _ in range(trips):
            x = torch.tanh(x @ w)
        return x

    rec = HC.analyze(f, _zeros(n, n), _zeros(n, n))
    # at least trips * (read w + read c + write y)
    assert rec["bytes"] >= trips * 3 * n * n * 4


def test_views_move_nothing():
    a = _zeros(16, 32)
    rec = HC.analyze(lambda a: a.view(512).view(32, 16).t()[2:5]
                     .unsqueeze(0).expand(2, 3, 32).permute(2, 0, 1), a)
    assert rec["bytes"] == 0 and rec["flops"] == 0


B, S, H, D = 2, 64, 4, 16
TOKEN = B * 1 * H * D * 4


def _slice_copy(cache, tok):
    cache[:, 5:6] = tok
    return cache


def _index_put(cache, tok):
    cache[:, torch.tensor([5])] = tok
    return cache


def _slice_scatter(cache, tok):
    return torch.slice_scatter(cache, tok, dim=1, start=5, end=6)


@pytest.mark.parametrize("write,extra", [
    (_slice_copy, 0), (_index_put, 8), (_slice_scatter, 0)])
def test_a_one_token_cache_write_counts_the_token(write, extra):
    """extra: the index tensor's bytes (one int64)."""
    rec = HC.analyze(write, _zeros(B, S, H, D), _zeros(B, 1, H, D))
    assert rec["bytes"] == 2 * TOKEN + extra


@pytest.mark.parametrize("read", [
    lambda t, i: t[i],
    lambda t, i: torch.nn.functional.embedding(i, t),
    lambda t, i: torch.index_select(t, 0, i),
])
def test_a_slice_read_counts_the_slice(read):
    table, idx = _zeros(1000, 64), torch.zeros(3, dtype=torch.long)
    rec = HC.analyze(read, table, idx)
    assert rec["bytes"] == 3 * 8 + 2 * 3 * 64 * 4


def test_gather_counts_the_slice():
    table = _zeros(1000, 64)
    idx = torch.zeros(1000, 2, dtype=torch.long)
    rec = HC.analyze(lambda t, i: torch.gather(t, 1, i), table, idx)
    assert rec["bytes"] == 1000 * 2 * 8 + 2 * 1000 * 2 * 4


def test_default_op_reads_operands_and_writes_result():
    rec = HC.analyze(lambda a, b: a + b, _zeros(10, 10), _zeros(10))
    assert rec["bytes"] == (100 + 10 + 100) * 4


# -- collectives --------------------------------------------------------------
N = 2048


def _all_gather(group):
    out = _zeros(N * group.size())
    dist.all_gather_into_tensor(out, _zeros(N), group=group)
    return out.numel() * 4


def _reduce_scatter(group):
    out = _zeros(N // group.size())
    dist.reduce_scatter_tensor(out, _zeros(N), group=group)
    return out.numel() * 4


def _all_reduce(group):
    dist.all_reduce(_zeros(N), group=group)
    return N * 4


def _all_to_all(group):
    dist.all_to_all_single(_zeros(N), _zeros(N), group=group)
    return N * 4


def _permute(group):
    ops = [dist.P2POp(dist.isend, _zeros(N), 1),
           dist.P2POp(dist.irecv, _zeros(N), 7)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return N * 4


KINDS = [(_all_gather, "all-gather"), (_reduce_scatter, "reduce-scatter"),
         (_all_reduce, "all-reduce"), (_all_to_all, "all-to-all")]


@pytest.mark.parametrize("call,kind,sub", [
    *((c, k, False) for c, k in KINDS), *((c, k, True) for c, k in KINDS),
    (_permute, "collective-permute", False)])
def test_collective_bytes_follow_the_table(call, kind, sub):
    """operand / wire per the reference's `hlo.py` conventions; `sub`: on
    the "model" group of a (2, 4) mesh (g = 4), else the world (g = 8)."""
    with fake_group(8):
        group = (make_mesh((2, 4), ("data", "model"), "cpu")
                 .get_group("model") if sub else dist.group.WORLD)
        g = group.size()
        seen = {}
        rec = HC.analyze(lambda: seen.setdefault("r", call(group)))
    r = seen["r"]
    operand, wire = {
        "all-gather": (r / g, r * (g - 1) / g),
        "reduce-scatter": (r * g, r * (g - 1)),
        "all-reduce": (r, 2 * r * (g - 1) / g),
        "all-to-all": (r, r * (g - 1) / g),
        "collective-permute": (r, r)}[kind]
    coll = rec["collectives"]
    assert coll[kind] == operand and coll[kind + "_count"] == 1
    assert coll["total"] == operand and coll["wire"] == int(wire)
    assert set(coll) == {kind, kind + "_count", "total", "wire"}


def test_all_reduce_of_2048_f32_over_8():
    """The reference's `test_hlo_parse.py::test_collective_bytes_wire_
    model` case, from a dispatched all-reduce and from the events."""
    with fake_group(8):
        rec = HC.analyze(lambda: dist.all_reduce(_zeros(2048)))
    assert rec["collectives"]["all-reduce"] == 2048 * 4
    assert abs(rec["collectives"]["wire"] - 2 * 2048 * 4 * 7 / 8) < 1
    assert HLO.collective_bytes([("all-reduce", 2048 * 4, 8)]) == \
        rec["collectives"]


def test_collective_bytes_sums_events_and_rejects_unknown_kinds():
    rec = HLO.collective_bytes([("all-gather", 4096, 4),
                                ("all-gather", 4096, 4),
                                ("collective-permute", 512, 8)])
    assert rec == {"all-gather": 2048, "all-gather_count": 2,
                   "collective-permute": 512, "collective-permute_count": 1,
                   "total": 2560, "wire": 2 * 3072 + 512}
    assert HLO.collective_bytes([]) == {"total": 0, "wire": 0}
    with pytest.raises(ValueError, match="unknown collective"):
        HLO.operand_and_wire("broadcast", 8, 2)


def test_op_histogram_counts_dispatched_ops():
    _, rec = HC.trace(lambda a: torch.tanh(a @ a) @ a, _zeros(4, 4))
    assert rec["op_hist"] == {"aten.mm": 2, "aten.tanh": 1}
    assert HLO.op_histogram(["aten.mm", "aten.add", "aten.mm"]) == \
        {"aten.mm": 2, "aten.add": 1}


def test_fake_process_group_is_pinned():
    """The dry-run's group: the private FakeStore, a mixed cpu/meta
    backend that takes meta tensors point to point, and one group at a
    time."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert callable(FakeStore)
    with fake_group(256):
        assert dist.get_world_size() == 256 and dist.get_rank() == 0
        assert "fake" in dist.get_backend()
        with pytest.raises(RuntimeError, match="open already"):
            with fake_group(8):
                pass
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        assert mesh.get_group("model").size() == 16
        _permute(None)
    assert not dist.is_initialized()


# -- against the reference's walker --------------------------------------------
@pytest.mark.parametrize("case", ["matmul", "einsum"])
def test_flops_match_the_references_walker(case):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.launch import hlo_cost as ref

    rng = np.random.default_rng(0)
    if case == "matmul":
        shapes, ref_fn = [(96, 80), (80, 112)], (lambda a, b: a @ b)
        port_fn = ref_fn
    else:
        shapes = [(4, 32, 48), (48, 56)]
        ref_fn = lambda a, w: jnp.einsum("bmk,kn->bmn", a, w)  # noqa: E731
        port_fn = lambda a, w: torch.einsum("bmk,kn->bmn", a, w)  # noqa: E731
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    text = jax.jit(ref_fn).lower(*arrays).compile().as_text()
    want = ref.analyze_text(text)["flops"]
    got = HC.analyze(port_fn, *(torch.from_numpy(a) for a in arrays))
    assert _close(got["flops"], want), (got["flops"], want)
