"""The mesh paths of the port on the CPU: four gloo processes on a (2, 2)
and a (1, 4) ("data", "model") mesh, against the port's own
single-device step (the reference's multi-device tests cannot serve as an
oracle). The mesh step is tensor-parallel over "model": on (1, 4) the four
ranks of one "model" group compute one loss together, each its heads, d_ff,
vocabulary or experts, and its block of the sequence between layers.

One spawn runs every case; the tests read what its ranks wrote:

- the reference's SPMD archs (qwen2-7b, qwen3-moe-30b-a3b, gemma2-27b,
  rwkv6-7b) and zamba2-7b, each at its smoke config (MoE at capacity
  factor 8.0 and router_aux_weight 0), and qwen2-7b's smoke config with 2
  KV heads, which do not split over 4 ranks (its attention splits the
  sequence on (1, 4), its heads on (2, 2)), batch 4 x 64, on each mesh:
  one step of make_train_step(mesh=) with microbatches=2 against the
  single-device step on the whole batch. Every case holds the same
  tolerances. The loss within 1e-5; mu (after one step from
  zero moments, (1 - b1) x the clipped gradient) gathered within 1e-4 of
  each leaf's largest entry; the parameters within 1e-5 of each leaf's
  largest entry plus what Adam's first update makes of mu's difference
  (a gradient entry near eps turns its rounding into a step of up to 2
  lr). Beside it loss_and_grads(mesh=) on one microbatch, its gradient
  gathered, within 1e-4 of each leaf's largest entry of the whole
  batch's;
- every rank's state leaves have the shapes of their blocks under the
  state's specs;
- the MoE layer alone at the default aux weight and a capacity that drops
  tokens: moe_layer(mesh=) on each rank's (dp, ep) token shard (its rows,
  its block of the sequence) against the single-device body run on each
  shard and concatenated, the metrics averaged, within 1e-6.

And in this process, on a one-rank gloo group and a (1, 1) mesh (what
chip_smoke.py's phase 15 runs on the card over NCCL): for each of the ten
archs at its smoke config, two steps of make_train_step(mesh=) are the
single-device steps bit for bit (loss, grad_norm, every state leaf), and
forward(mesh=), each layer gathering its weights, gives the single-device
logits bit for bit, with and without the remat units of train=True.
"""
import dataclasses
import json
import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import registry
from repro_torch.configs.base import smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import model as MDL
from repro_torch.models.layers import moe as MOE
from repro_torch.training import data as DATA
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves_with_paths, tree_map

ARCHS = ("qwen2-7b", "qwen3-moe-30b-a3b", "gemma2-27b", "rwkv6-7b",
         "zamba2-7b")
KV2 = "qwen2-7b-kv2"             # 2 KV heads: do not split over 4 ranks
CASES = ARCHS + (KV2,)
WORLD, MESH = 4, (2, 2)
MESHES = {"2x2": MESH, "1x4": (1, 4)}
BATCH, SEQ, MICRO = 4, 64, 2
LOSS_TOL, GRAD_TOL, PARAM_TOL, MOE_TOL = 1e-5, 1e-4, 1e-5, 1e-6
OPT_KW = dict(warmup_steps=1, total_steps=4)
MOE_CAPACITY = 0.5               # drops tokens at 32 local tokens a shard


def _cfg(arch):
    if arch == KV2:
        return dataclasses.replace(smoke_config(registry.get("qwen2-7b")),
                                   kv_heads=2)
    cfg = smoke_config(registry.get(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, router_aux_weight=0.0))
    return cfg


def _clone(tree):
    return tree_map(torch.clone, tree)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _whole_step(cfg, state, batch):
    step, _, _ = TL.make_train_step(cfg, OPT.OptConfig(**OPT_KW),
                                    compute_dtype=torch.float32,
                                    device="cpu")
    return step(_clone(state), batch)


def _oracle(arch):
    """(cfg, state, batch, the single-device step's state and metrics, the
    whole batch's gradient) of one case."""
    cfg = _cfg(arch)
    state = TL.init_state(cfg, seed=0, device="cpu")
    batch = DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)).batch_for_model(
        0, cfg)
    want_state, want_m = _whole_step(cfg, state, batch)
    _, _, g_whole = TL.loss_and_grads(
        state["params"], TL.batch_to_device(batch, "cpu"), cfg)
    return cfg, state, batch, want_state, want_m, g_whole


def _arch_case(oracle, mesh, rank):
    cfg, state, batch, want_state, want_m, g_whole = oracle
    step, shardings, bspec = TL.make_train_step(
        cfg, OPT.OptConfig(**OPT_KW), mesh=mesh, dp_axes=("data",),
        microbatches=MICRO, compute_dtype=torch.float32, device="cpu")
    specs = shardings(state["params"])
    local = SH.shard_tree(_clone(state), specs, mesh)
    shapes_ok = all(
        tuple(leaf.shape) == SH.local_shape(whole.shape, spec, mesh)
        for (_, leaf), (_, whole), (_, spec) in zip(
            leaves_with_paths(local), leaves_with_paths(state),
            leaves_with_paths(specs)))
    sharded = sum(leaf.numel() for _, leaf in leaves_with_paths(local))
    got_state, got_m = step(local, batch)
    got = SH.unshard_tree(got_state, specs, mesh)

    # the gradient of one microbatch's worth: this rank's rows of the whole
    # batch against the whole batch on one device
    rows = TL.dp_rows(BATCH, mesh, ("data",))
    _, _, g_mesh = TL.loss_and_grads(
        SH.shard_tree(_clone(state), specs, mesh)["params"],
        TL.batch_to_device({k: v[rows] for k, v in batch.items()}, "cpu"),
        cfg, mesh=mesh, dp_axes=("data",))
    g_mesh = SH.unshard_tree(g_mesh, specs["params"], mesh)

    out = {"rank": rank, "shapes_ok": shapes_ok,
           "held": sharded,
           "whole": sum(t.numel() for _, t in leaves_with_paths(state)),
           "bspec": list(bspec)}
    if rank == 0:
        wl, gl = float(want_m["loss"]), float(got_m["loss"])
        out.update(
            loss_rel=abs(gl - wl) / abs(wl),
            gnorm_rel=abs(float(got_m["grad_norm"])
                          - float(want_m["grad_norm"]))
            / float(want_m["grad_norm"]),
            lr_equal=float(got_m["lr"]) == float(want_m["lr"]),
            step=int(got["opt"]["step"]),
            grad_rel=max(_rel(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(g_mesh), leaves_with_paths(g_whole))),
            mu_rel=max(_rel(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(got["opt"]["mu"]),
                leaves_with_paths(want_state["opt"]["mu"]))),
            param_excess=_param_excess(got, want_state,
                                       float(want_m["lr"])))
    return out


def _param_excess(got, want, lr) -> float:
    """The largest |d param| over its allowance: PARAM_TOL of the leaf's
    largest entry plus lr x what Adam's first update u(g) = g / (|g| +
    eps) makes of mu's difference. <= 1 passes."""
    eps, b1 = OPT.OptConfig().eps, OPT.OptConfig().b1
    mu_g = dict(leaves_with_paths(got["opt"]["mu"]))
    mu_w = dict(leaves_with_paths(want["opt"]["mu"]))

    def u(x):
        return x / (x.abs() + eps)

    worst = 0.0
    for path, w in leaves_with_paths(want["params"]):
        g = dict(leaves_with_paths(got["params"]))[path].double()
        w = w.double()
        ghat = mu_w[path].double() / (1 - b1)
        dg = (mu_g[path].double() - mu_w[path].double()).abs() / (1 - b1)
        du = torch.maximum((u(ghat + dg) - u(ghat)).abs(),
                           (u(ghat - dg) - u(ghat)).abs())
        allow = PARAM_TOL * w.abs().max() + lr * du + 1e-30
        worst = max(worst, float(((g - w).abs() / allow).max()))
    return worst


def _moe_case(mesh, rank):
    cfg = smoke_config(registry.get("qwen3-moe-30b-a3b"))
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=MOE_CAPACITY)
    params = MDL.init_params(cfg, seed=3, device="cpu")
    whole = MDL._layer(params["layers"]["moe"], 0)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(BATCH, SEQ, cfg.d_model, generator=gen)
    specs = MOE.expert_specs(moe_cfg, cfg.d_model, mesh)
    shards = {"router": whole["router"],
              **{k: SH.shard(whole[k], specs[k], mesh) for k in specs}}
    rows = TL.dp_rows(BATCH, mesh, ("data",))
    seq = SH.block_start(mesh, ("model",), SEQ // MESH[1], SEQ)
    y, metrics = MOE.moe_layer(shards, x[rows, seq:seq + SEQ // MESH[1]],
                               moe_cfg, mesh=mesh, dp_axes=("data",))
    y = SH.gather_whole(y, ("data", "model", None), mesh)
    if rank:
        return {"rank": rank}
    # the oracle: the single-device body on each (dp, ep) token shard
    dp, ep = MESH
    per, seq = BATCH // dp, SEQ // ep
    parts, ms = [], []
    for d in range(dp):
        row = []
        for m in range(ep):
            yk, mk = MOE._moe_body(whole, x[d * per:(d + 1) * per,
                                            m * seq:(m + 1) * seq], moe_cfg)
            row.append(yk)
            ms.append(mk)
        parts.append(torch.cat(row, dim=1))
    want = torch.cat(parts, dim=0)
    want_m = {k: sum(float(m[k]) for m in ms) / len(ms) for k in ms[0]}
    return {"rank": 0, "y_rel": _rel(y, want),
            "metric_rel": max(abs(float(metrics[k]) - v) / max(abs(v), 1e-30)
                              for k, v in want_m.items()),
            "drop_frac": float(metrics["drop_frac"])}


def _worker(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    try:
        meshes = {name: make_cpu_mesh(*shape)
                  for name, shape in MESHES.items()}
        oracles = {arch: _oracle(arch) for arch in CASES}
        out = {name: {arch: _arch_case(oracles[arch], mesh, rank)
                      for arch in CASES} for name, mesh in meshes.items()}
        out["moe_layer"] = _moe_case(meshes["2x2"], rank)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    mp.start_processes(_worker, args=(tmp,), nprocs=WORLD, join=True,
                       start_method="spawn")
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


# the (2, 2) cases keep their arch as their id
MESH_CASES = [pytest.param(name, arch, id=arch if name == "2x2" else
                           f"{name}-{arch}")
              for name in MESHES for arch in CASES]


@pytest.mark.parametrize("mesh,arch", MESH_CASES)
def test_mesh_step_loss(runs, mesh, arch):
    r = runs[0][mesh][arch]
    assert r["loss_rel"] <= LOSS_TOL, r
    assert r["gnorm_rel"] <= GRAD_TOL, r
    assert r["lr_equal"] and r["step"] == 1, r


@pytest.mark.parametrize("mesh,arch", MESH_CASES)
def test_mesh_gradients(runs, mesh, arch):
    r = runs[0][mesh][arch]
    assert r["grad_rel"] <= GRAD_TOL, r
    assert r["mu_rel"] <= GRAD_TOL, r


@pytest.mark.parametrize("mesh,arch", MESH_CASES)
def test_mesh_adamw_params(runs, mesh, arch):
    assert runs[0][mesh][arch]["param_excess"] <= 1.0, runs[0][mesh][arch]


@pytest.mark.parametrize("mesh,arch", MESH_CASES)
def test_each_rank_holds_its_shards(runs, mesh, arch):
    for r in runs:
        assert r[mesh][arch]["shapes_ok"], (r[mesh][arch]["rank"], mesh, arch)
        assert r[mesh][arch]["held"] < r[mesh][arch]["whole"], r[mesh][arch]
        assert r[mesh][arch]["bspec"] == ["data", None]


def test_moe_layer_matches_the_body_on_each_shard(runs):
    r = runs[0]["moe_layer"]
    assert r["y_rel"] <= MOE_TOL, r
    assert r["metric_rel"] <= MOE_TOL, r
    # local capacity is exercised: the shards drop tokens
    assert r["drop_frac"] > 0, r


ALL_ARCHS = sorted(registry.ARCHS)


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one_rank")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        yield make_cpu_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_rank_mesh_step_is_the_plain_step_bit_for_bit(one_rank_mesh,
                                                          arch):
    cfg = smoke_config(registry.get(arch))
    state = TL.init_state(cfg, seed=0, device="cpu")
    data = DATA.SyntheticLM(DATA.DataConfig(vocab=cfg.vocab, seq_len=32,
                                            global_batch=2))
    dtype = torch.bfloat16 if cfg.moe or arch == "minicpm-2b" else \
        torch.float32
    opt = OPT.OptConfig(**OPT_KW)
    mesh_step, shardings, _ = TL.make_train_step(
        cfg, opt, mesh=one_rank_mesh, compute_dtype=dtype, device="cpu")
    plain_step, _, _ = TL.make_train_step(cfg, opt, compute_dtype=dtype,
                                          device="cpu")
    got = SH.shard_tree(state, shardings(state["params"]), one_rank_mesh)
    want = _clone(state)
    for k in range(2):
        batch = data.batch_for_model(k, cfg)
        got, got_m = mesh_step(got, batch)
        want, want_m = plain_step(want, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(torch.as_tensor(got_m[key]),
                               torch.as_tensor(want_m[key])), (k, key)
    for (path, a), (_, b) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("train", (True, False))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_rank_mesh_forward_is_the_plain_forward(one_rank_mesh, arch,
                                                    train):
    cfg = smoke_config(registry.get(arch))
    params = MDL.init_params(cfg, seed=1, device="cpu")
    batch = TL.batch_to_device(DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2)).batch_for_model(0, cfg),
        "cpu")
    specs = MDL.param_layout(cfg, one_rank_mesh)
    want, _, want_m = MDL.forward(params, batch, cfg, train=train)
    got, _, got_m = MDL.forward(SH.shard_tree(params, specs, one_rank_mesh),
                                batch, cfg, train=train, mesh=one_rank_mesh)
    assert torch.equal(got, want)
    assert {k: float(v) for k, v in got_m.items()} == \
        {k: float(v) for k, v in want_m.items()}
