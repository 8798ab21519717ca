"""Decode on a mesh on the CPU: the serve step of the port on four gloo
processes against the port's own plain serve step, and four archs against
the reference's single-device serve step (the reference's mesh tests
cannot serve as an oracle).

One spawn of four ranks runs every case; the tests read what the ranks
wrote. For each of the nine decoding archs at its smoke config (f32),
on the meshes (1, 4) and (2, 2), with a batch of 4 (split over "data" on
(2, 2), whole on (1, 4), whose "data" axis has one rank) and a batch of
1 (the positions split over ("data", "model")), and for kv_shard "seq"
and "hd" (gemma2's window cut from 64 to 4, so that its local layers
mask inside the 16-position cache; Zamba2 at the reference's own init,
see below):

- a 16-position cache is filled by the plain serve step over a prompt of
  6 tokens; its blocks under `cache_specs` (`sharding.shard_tree`) and
  the whole cache then each take 4 decode steps, through
  make_serve_step(mesh=) and the plain serve step. Every step's tokens
  are equal, its logits within 1e-5 of the largest plain logit, and after
  the 4 steps the cache gathered from the blocks is within 1e-6 of each
  leaf's largest entry;
- every cache leaf a rank holds has its block's shape, and on these
  meshes every KV cache and state leaf is split (the rank holds less than
  the whole);
- a recording wrapper around torch.distributed.all_gather_into_tensor and
  all_reduce, around each decode step, records what every collective
  moves (the all-gather's output, the all-reduce's tensor), outside the
  layers' weight gathers (`sharding.gather` of the parameter shards). No
  collective moves more than one token's activations of the rank's rows,
  B x max(d_model, H*D, conv channels) elements, but two held by name:
  the all-gather of the token's logits over the vocabulary, B x the
  padded vocabulary (the step splits the unembedding over "model"), and
  with kv_shard "hd" the all-reduce of the partial q.k scores, B x H x
  S_blk (the rank's positions). The scores outgrow a token wherever
  S_blk > head_dim: here, at 16 positions, they do not, so a qwen2-7b
  case at 64 positions shows them above the token bound. The MoE layers'
  slot exchange and Mamba2's regrouping of in_proj's column blocks are
  all_to_alls, which the wrapper does not see;
- on (2, 2), for qwen2-7b and zamba2-7b, both batches and both
  kv_shards, the mesh step and the plain step decode until the cache is
  full, and the next token raises RuntimeError through each.

For qwen2-7b, gemma2-27b, zamba2-7b and rwkv6-7b (one arch of each cache
kind), the reference's parameters converted to the port's and its
smoke config (gemma2's window 4 on both sides): the port's mesh step on
(2, 2), batch 4, kv_shard "seq", against the reference's single-device
`make_serve_step` from the same cache (filled by the port's plain step,
converted): tokens equal and logits within 1e-4 of the largest (the
reference's logits from its forward on the same inputs).

Zamba2 runs at the reference's own init, as the port's other tests run
it: its activations are small there (~1e-23 at the logits) and float32
keeps their relative precision. Scaled up as chip_smoke.py scales its
embedding (x 2 to x 10), a change of one unit in the last place of the
shared attention's output alone moves a Mamba2 state by 0.86-1.13e-6 of
its largest entry on the plain path
(test_scaled_zamba2_sits_at_the_cache_gate), so no path that sums in
another order can be held to the 1e-6 cache gate there. At x 10, the
scale of chip_smoke.py's Zamba2 cells, the 4-rank grid of meshes,
batches and kv_shards runs once more, each case held to the same token
and logit gates and its cache to ULP_GATE (2) times that one-ulp move,
measured on the plain path at the same scale and batch.

And in this process, on a one-rank gloo group and a (1, 1) mesh (what
chip_smoke.py's phase 16 runs on the card over NCCL): for each of the
nine archs, the mesh step's tokens are the plain step's and its logits
within 1e-6 (here bit for bit: a dim split over one rank is whole, so
the step does the plain step's arithmetic), for kv_shard "seq" and
"hd"; and a token past a full cache raises RuntimeError there too.
"""
import copy
import dataclasses
import itertools
import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import model as MDL
from repro_torch.serving.decode import make_serve_step
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves_with_paths, tree_map

ARCHS = tuple(a for a in sorted(registry.ARCHS)
              if not registry.get(a).encoder_only)
REF_ARCHS = ("qwen2-7b", "gemma2-27b", "zamba2-7b", "rwkv6-7b")
WORLD = 4
MESHES = ((1, 4), (2, 2))
BATCHES = (4, 1)
KV_SHARDS = ("seq", "hd")
CACHE_LEN, PROMPT, STEPS, WINDOW = 16, 6, 4, 4
LOGIT_TOL, CACHE_TOL, REF_TOL, ONE_RANK_TOL = 1e-5, 1e-6, 1e-4, 1e-6
CASES = [pytest.param(a, m, b, kv, id=f"{a}-{m[0]}x{m[1]}-b{b}-{kv}")
         for a, m, b, kv in itertools.product(ARCHS, MESHES, BATCHES,
                                               KV_SHARDS)]
# Zamba2 with its embedding scaled as chip_smoke.py's EMBED_SCALE scales it
ZAMBA, ZAMBA_SCALE, ULP_GATE = "zamba2-7b", 10.0, 2.0
SCALED_CASES = [pytest.param(m, b, kv, id=f"{m[0]}x{m[1]}-b{b}-{kv}")
                for m, b, kv in itertools.product(MESHES, BATCHES,
                                                  KV_SHARDS)]
# decode past the cache's end, on (2, 2)
END_ARCHS = ("qwen2-7b", "zamba2-7b")
END_CASES = [pytest.param(a, b, kv, id=f"{a}-b{b}-{kv}")
             for a, b, kv in itertools.product(END_ARCHS, BATCHES,
                                               KV_SHARDS)]
# kv_shard "hd" at a length where a rank's scores outgrow one token
LONG_ARCH, LONG_CACHE = "qwen2-7b", 64


def _cfg(arch):
    cfg = smoke_config(registry.get(arch))
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    return cfg


def _key(mesh_shape, batch, kv):
    return f"{mesh_shape[0]}x{mesh_shape[1]}/b{batch}/{kv}"


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else copy.deepcopy(t), tree)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _inputs(cfg, batch, seed):
    """(prompt tokens [B, PROMPT], extra batch entries: the vlm's image
    embeddings), from numpy."""
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, PROMPT)))
    extra = {}
    if cfg.cross_attn_period:
        extra["image_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)), dtype=torch.float32)
    return prompt, extra


def _filled_cache(cfg, params, batch, seed, cache_len=CACHE_LEN):
    """(the cache of `cache_len` positions after the plain serve step over
    a prompt of PROMPT tokens, its last token [B, 1], the vlm's image
    embeddings or {})."""
    prompt, extra = _inputs(cfg, batch, seed)
    step = make_serve_step(cfg, compute_dtype=torch.float32)
    cache = MDL.init_cache(cfg, batch, cache_len, dtype=torch.float32,
                           device="cpu")
    tok = None
    for t in range(PROMPT):
        tok, cache = step(params, {"tokens": prompt[:, t:t + 1], **extra},
                          cache)
    return cache, tok[:, None], extra


def _step(step, *args):
    """A serve step's (next tokens, cache, logits): the logits as the step
    gets them from model.forward."""
    seen, forward = [], MDL.forward

    def spy(*a, **kw):
        out = forward(*a, **kw)
        seen.append(out[0])
        return out

    MDL.forward = spy
    try:
        tok, cache = step(*args)
    finally:
        MDL.forward = forward
    return tok, cache, seen[-1]


class _Recorder:
    """Records the elements each all_gather_into_tensor (its output) and
    all_reduce moves while on, outside the layers' weight gathers, as
    ("gather" or "reduce", elements)."""

    def __init__(self):
        self.on, self.sizes = False, []
        self.local = threading.local()

    def install(self):
        gather_into, reduce, weights = (dist.all_gather_into_tensor,
                                        dist.all_reduce, SH.gather)

        def record(kind, n):
            if self.on and not getattr(self.local, "weights", 0):
                self.sizes.append((kind, n))

        def all_gather_into_tensor(out, inp, *a, **kw):
            record("gather", out.numel())
            return gather_into(out, inp, *a, **kw)

        def all_reduce(t, *a, **kw):
            record("reduce", t.numel())
            return reduce(t, *a, **kw)

        def gather(*a, **kw):
            self.local.weights = getattr(self.local, "weights", 0) + 1
            try:
                return weights(*a, **kw)
            finally:
                self.local.weights -= 1

        dist.all_gather_into_tensor = all_gather_into_tensor
        dist.all_reduce = all_reduce
        SH.gather = gather


def _token_bound(cfg, rows: int) -> int:
    """One token's activations of `rows` rows: rows x max(d_model, H*D,
    the Mamba2 conv channels)."""
    width = max(cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    if cfg.ssm is not None:
        width = max(width, cfg.ssm.expand * cfg.d_model
                    + 2 * cfg.ssm.d_state)
    return rows * width


def _paths(cfg, params, mesh, kv, filled, cache_len=CACHE_LEN):
    """The two paths from a copy of the `filled` cache (`_filled_cache`)
    of `cache_len` positions: (the mesh step, its parameter shards, the
    cache's blocks under cache_specs(kv), their spec, this rank's rows,
    the batch's dp entry), (the plain step, the whole cache)."""
    cache, tok = _clone(filled[0]), filled[1]
    batch = tok.shape[0]
    shape = ShapeConfig("decode", cache_len, batch, "decode")
    spec = SP.cache_specs(cache, cfg, shape, mesh, ("data",), kv)
    dp = SP.batch_specs(cfg, shape, mesh, ("data",))["tokens"].spec[0]
    rows = TL.dp_rows(batch, mesh, ("data",)) if dp else slice(None)
    mesh_step = make_serve_step(cfg, mesh=mesh, dp_axes=("data",),
                                compute_dtype=torch.float32)
    plain_step = make_serve_step(cfg, compute_dtype=torch.float32)
    return ((mesh_step, SH.shard_tree(params, MDL.param_layout(cfg, mesh),
                                      mesh),
             SH.shard_tree(cache, spec, mesh), spec, rows, dp),
            (plain_step, cache))


def _mesh_decode(cfg, params, mesh, kv, filled, rec=None,
                 cache_len=CACHE_LEN):
    """STEPS decode steps through the mesh step and the plain step, from
    a copy of the `filled` cache (`_filled_cache`) of `cache_len`
    positions. Returns what the tests read."""
    (mesh_step, shards, blocks, spec, rows, dp), (plain_step, cache) = \
        _paths(cfg, params, mesh, kv, filled, cache_len)
    tok, extra = filled[1], filled[2]
    batch = tok.shape[0]
    local_extra = {k: v[rows] for k, v in extra.items()}
    t_mesh, t_plain = tok[rows], tok
    tokens_equal, logit_rel, sizes, got_logits = True, 0.0, set(), []
    for _ in range(STEPS):
        if rec is not None:
            rec.sizes, rec.on = [], True
        n_mesh, blocks, got = _step(mesh_step, shards,
                                    {"tokens": t_mesh, **local_extra},
                                    blocks, spec)
        if rec is not None:
            rec.on = False
            sizes.update(rec.sizes)
        n_plain, cache, want = _step(plain_step, params,
                                     {"tokens": t_plain, **extra}, cache)
        tokens_equal &= n_mesh.tolist() == n_plain[rows].tolist()
        logit_rel = max(logit_rel, _rel(got, want[rows]))
        got_logits.append(SH.gather_whole(got, (dp, None, None), mesh))
        t_mesh, t_plain = n_mesh[:, None], n_plain[:, None]
    gathered = SH.unshard_tree(blocks, spec, mesh)
    leaves = [(p, b, w, g, sp) for (p, b), (_, w), (_, g), (_, sp) in zip(
        leaves_with_paths(blocks), leaves_with_paths(cache),
        leaves_with_paths(gathered), leaves_with_paths(spec))
        if isinstance(b, torch.Tensor)]
    rows_n = len(range(batch)[rows])
    bound = _token_bound(cfg, rows_n)
    s_blk = max((b.shape[-3] for p, b, *_ in leaves if p.endswith("['k']")),
                default=0)
    return {
        "tokens_equal": tokens_equal, "logit_rel": logit_rel,
        "cache_rel": max(_rel(g, w) for _, _, w, g, _ in leaves),
        "cache_worst": max((_rel(g, w), p) for p, _, w, g, _ in leaves)[1],
        "len_equal": [g for p, g in leaves_with_paths(gathered)
                      if p.endswith("['len']")]
        == [w for p, w in leaves_with_paths(cache)
            if p.endswith("['len']")],
        "shapes_ok": all(tuple(b.shape) == SH.local_shape(w.shape, sp, mesh)
                         for _, b, w, _, sp in leaves),
        "all_split": all(b.numel() < w.numel() for _, b, w, _, _ in leaves),
        "recorded": bool(sizes),
        "over": sorted([kind, n] for kind, n in sizes if n > bound),
        "bound": bound,
        # the token's logits, gathered over the vocabulary
        "logit_bound": rows_n * cfg.padded_vocab,
        # kv_shard "hd": the partial q.k scores, all-reduced over "model"
        "score_bound": rows_n * cfg.n_heads * s_blk,
        "logits": torch.stack(got_logits).tolist() if rec is None else None,
    }


def _past_the_end(cfg, params, mesh, kv, filled):
    """From a copy of the `filled` cache, decode through the mesh step
    and through the plain step until the cache is full, then one token
    more. Returns {path: [the steps it took, the class of the error it
    raised (None if it raised none)]}."""
    (mesh_step, shards, blocks, spec, rows, _), (plain_step, cache) = \
        _paths(cfg, params, mesh, kv, filled)
    tok, extra = filled[1], filled[2]
    runs = {"mesh": (mesh_step, shards, blocks, (spec,), tok[rows],
                     {k: v[rows] for k, v in extra.items()}),
            "plain": (plain_step, params, cache, (), tok, extra)}
    out = {}
    for name, (step, p, c, more, t, ex) in runs.items():
        done, err = 0, None
        try:
            for _ in range(CACHE_LEN - PROMPT + 1):
                t, c = step(p, {"tokens": t, **ex}, c, *more)
                t = t[:, None]
                done += 1
        except Exception as e:  # noqa: BLE001 - the class is the result
            err = type(e).__name__
        out[name] = [done, err]
    return out


def _scaled_zamba():
    """Zamba2's smoke config and its parameters, the embedding scaled by
    ZAMBA_SCALE."""
    cfg = _cfg(ZAMBA)
    params = MDL.init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"].mul_(ZAMBA_SCALE)
    return cfg, params


def _worker(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    try:
        meshes = {shape: make_cpu_mesh(*shape) for shape in MESHES}
        rec = _Recorder()
        rec.install()
        out = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            params = MDL.init_params(cfg, seed=0, device="cpu")
            for batch in BATCHES:
                filled = _filled_cache(cfg, params, batch, seed=0)
                for shape, kv in itertools.product(MESHES, KV_SHARDS):
                    out[f"{arch}/{_key(shape, batch, kv)}"] = _mesh_decode(
                        cfg, params, meshes[shape], kv, filled, rec)
        for arch in REF_ARCHS:
            cfg = _cfg(arch)
            params = torch.load(os.path.join(tmp, f"{arch}.pt"))
            filled = _filled_cache(cfg, params, 4, seed=1)
            if rank == 0:
                torch.save(filled, os.path.join(tmp, f"{arch}.cache.pt"))
            out[f"reference/{arch}"] = _mesh_decode(
                cfg, params, meshes[(2, 2)], "seq", filled)
        cfg, params = _scaled_zamba()
        for batch in BATCHES:
            filled = _filled_cache(cfg, params, batch, seed=0)
            for shape, kv in itertools.product(MESHES, KV_SHARDS):
                out[f"scaled/{_key(shape, batch, kv)}"] = _mesh_decode(
                    cfg, params, meshes[shape], kv, filled)
        for arch in END_ARCHS:
            cfg = _cfg(arch)
            params = MDL.init_params(cfg, seed=0, device="cpu")
            for batch in BATCHES:
                filled = _filled_cache(cfg, params, batch, seed=0)
                for kv in KV_SHARDS:
                    out[f"end/{arch}/b{batch}/{kv}"] = _past_the_end(
                        cfg, params, meshes[(2, 2)], kv, filled)
        cfg = _cfg(LONG_ARCH)
        params = MDL.init_params(cfg, seed=0, device="cpu")
        out["long"] = _mesh_decode(
            cfg, params, meshes[(2, 2)], "hd",
            _filled_cache(cfg, params, 4, seed=0, cache_len=LONG_CACHE), rec,
            cache_len=LONG_CACHE)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _ref_models():
    """arch -> (reference cfg, reference params) for REF_ARCHS, gemma2's
    window cut as the port's."""
    import jax

    from repro.configs import registry as ref_registry
    from repro.configs.base import smoke_config as ref_smoke_config
    from repro.models import model as RM

    out = {}
    for arch in REF_ARCHS:
        rcfg = ref_smoke_config(ref_registry.get(arch))
        if rcfg.sliding_window:
            rcfg = dataclasses.replace(rcfg, sliding_window=WINDOW)
        out[arch] = (rcfg, jax.device_get(RM.init_params(
            rcfg, jax.random.PRNGKey(0))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.convert import params_from_reference

    tmp = str(tmp_path_factory.mktemp("mesh_decode"))
    refs = _ref_models()
    for arch, (_, rp) in refs.items():
        torch.save(params_from_reference(rp, _cfg(arch), device="cpu"),
                   os.path.join(tmp, f"{arch}.pt"))
    mp.start_processes(_worker, args=(tmp,), nprocs=WORLD, join=True,
                       start_method="spawn")
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out, refs, tmp


@pytest.mark.parametrize("arch,mesh_shape,batch,kv", CASES)
def test_mesh_decode_matches_the_plain_step(runs, arch, mesh_shape, batch,
                                            kv):
    for r in runs[0]:
        got = r[f"{arch}/{_key(mesh_shape, batch, kv)}"]
        assert got["tokens_equal"], got
        assert got["logit_rel"] <= LOGIT_TOL, got
        assert got["cache_rel"] <= CACHE_TOL, got
        assert got["len_equal"], got


def _within_one_token(got, kv) -> bool:
    """No collective of a decode step moved more than one token's
    activations (`_token_bound`), but the gather of the token's logits
    over the vocabulary, B x V elements, and with kv_shard "hd" the
    partial q.k scores' all-reduce, B x H x S_blk elements (S_blk the
    rank's positions), which the step moves by design."""
    allowed = [["gather", got["logit_bound"]]]
    if kv == "hd":
        allowed.append(["reduce", got["score_bound"]])
    return got["recorded"] and all(o in allowed for o in got["over"])


@pytest.mark.parametrize("arch,mesh_shape,batch,kv", CASES)
def test_no_rank_holds_a_cache_whole(runs, arch, mesh_shape, batch, kv):
    for r in runs[0]:
        got = r[f"{arch}/{_key(mesh_shape, batch, kv)}"]
        assert got["shapes_ok"] and got["all_split"], got
        assert _within_one_token(got, kv), got


def test_hd_scores_outgrow_one_token_at_length(runs):
    """kv_shard "hd" with a rank's positions (64) above head_dim (32):
    the score all-reduce, B x H x S_blk, is above one token's
    activations, as at decode_32k's length, and the only collective
    there beside the logits' gather; the step still holds the plain
    step's tokens, logits and cache."""
    for r in runs[0]:
        got = r["long"]
        assert got["score_bound"] > got["bound"], got
        assert got["over"] == [["gather", got["logit_bound"]],
                               ["reduce", got["score_bound"]]], got
        assert got["tokens_equal"] and got["logit_rel"] <= LOGIT_TOL, got
        assert got["cache_rel"] <= CACHE_TOL and got["len_equal"], got


@pytest.mark.parametrize("arch,batch,kv", END_CASES)
def test_decode_past_the_cache_end_raises(runs, arch, batch, kv):
    """On (2, 2), both paths decode until the cache is full; the next
    token raises RuntimeError on every rank, on the mesh as on one
    device, where no rank's block holds its position."""
    for r in runs[0]:
        got = r[f"end/{arch}/b{batch}/{kv}"]
        assert got == {"mesh": [CACHE_LEN - PROMPT, "RuntimeError"],
                       "plain": [CACHE_LEN - PROMPT, "RuntimeError"]}, got


def _to_reference(cache):
    import jax.numpy as jnp

    if isinstance(cache, dict):
        return {k: _to_reference(v) for k, v in cache.items()}
    if cache is None:
        return None
    if isinstance(cache, list):
        return jnp.asarray(cache, jnp.int32)
    return jnp.asarray(cache.numpy())


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_mesh_decode_matches_the_reference(runs, arch):
    import jax
    import jax.numpy as jnp

    from repro.models import model as RM
    from repro.serving.decode import make_serve_step as ref_serve_step

    ranks, refs, tmp = runs
    got = ranks[0][f"reference/{arch}"]
    rcfg, rp = refs[arch]
    cache, tok, _ = torch.load(os.path.join(tmp, f"{arch}.cache.pt"))
    rcache = _to_reference(cache)
    step = jax.jit(ref_serve_step(rcfg, compute_dtype=jnp.float32))
    fwd = jax.jit(lambda p, b, c: RM.forward(p, b, rcfg, cache=c)[0])
    tok = jnp.asarray(tok.numpy(), jnp.int32)
    for k in range(STEPS):
        batch = {"tokens": tok}
        want = fwd(rp, batch, rcache)
        tok, rcache = step(rp, batch, rcache)
        logits = np.asarray(got["logits"][k])
        assert np.argmax(logits[:, -1], -1).tolist() == \
            np.asarray(tok).tolist(), k
        assert _rel(torch.as_tensor(logits), torch.as_tensor(
            np.asarray(want))) <= REF_TOL, k
        tok = tok[:, None]
    assert all(r[f"reference/{arch}"]["tokens_equal"] for r in ranks)


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one_rank")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        yield make_cpu_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kv", KV_SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_decode_is_the_plain_step(one_rank_mesh, arch, kv):
    cfg = _cfg(arch)
    params = MDL.init_params(cfg, seed=2, device="cpu")
    got = _mesh_decode(cfg, params, one_rank_mesh, kv,
                       _filled_cache(cfg, params, 2, seed=2))
    assert got["tokens_equal"], got
    assert got["logit_rel"] <= ONE_RANK_TOL, got
    assert got["cache_rel"] <= CACHE_TOL and got["shapes_ok"], got


def test_a_mesh_step_runs_where_its_mesh_is(one_rank_mesh):
    """A batch on another device than the mesh's raises, and a cache on a
    mesh without its layout raises."""
    cfg = _cfg("qwen2-7b")
    params = MDL.init_params(cfg, seed=0, device="cpu")
    cache = MDL.init_cache(cfg, 1, CACHE_LEN, dtype=torch.float32,
                           device="cpu")
    step = make_serve_step(cfg, mesh=one_rank_mesh,
                           compute_dtype=torch.float32)
    tokens = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="mesh is on cpu"):
        step(params, {"tokens": tokens.to("meta")}, cache, {})
    with pytest.raises(ValueError, match="cache_spec"):
        step(params, {"tokens": tokens}, cache)


@pytest.mark.parametrize("kv", KV_SHARDS)
@pytest.mark.parametrize("arch", END_ARCHS)
def test_one_rank_decode_past_the_cache_end_raises(one_rank_mesh, arch, kv):
    """On a (1, 1) mesh, as on (2, 2): the token after a full cache raises
    RuntimeError through the mesh step, as through the plain step."""
    cfg = _cfg(arch)
    params = MDL.init_params(cfg, seed=2, device="cpu")
    got = _past_the_end(cfg, params, one_rank_mesh, kv,
                        _filled_cache(cfg, params, 2, seed=2))
    assert got == {"mesh": [CACHE_LEN - PROMPT, "RuntimeError"],
                   "plain": [CACHE_LEN - PROMPT, "RuntimeError"]}, got


def _ulp_move(params, batch) -> float:
    """The plain step alone, Zamba2's attention output moved by one unit
    in the last place (x (1 + 2^-23)) in every decode step: how far the
    prompt and STEPS decode tokens then move the worst Mamba2 state, over
    its largest entry."""
    from repro_torch.models.layers import attention as A

    cfg = _cfg(ZAMBA)
    decode = A.decode_attention

    def run(factor):
        A.decode_attention = lambda *a, **kw: decode(*a, **kw) * factor
        try:
            cache, tok, _ = _filled_cache(cfg, params, batch, seed=0)
            step = make_serve_step(cfg, compute_dtype=torch.float32)
            for _ in range(STEPS):
                tok, cache = step(params, {"tokens": tok}, cache)
                tok = tok[:, None]
        finally:
            A.decode_attention = decode
        return cache

    base, moved = run(1.0), run(1.0 + 2.0 ** -23)
    return max(_rel(moved[part][k], base[part][k])
               for part in ("mamba", "tail") for k in ("conv", "ssm"))


@pytest.mark.parametrize("scale", (2.0, 3.0, 5.0, 10.0))
def test_scaled_zamba2_sits_at_the_cache_gate(scale):
    """Why the Zamba2 cases of the nine-arch grid run the reference's own
    init: with its embedding scaled, a one-ulp move of the attention
    output alone (`_ulp_move`) ends with a tail Mamba2 state at least
    half the cache gate away (measured: 0.86-1.13e-6)."""
    params = MDL.init_params(_cfg(ZAMBA), seed=0, device="cpu")
    params["embed"]["table"].mul_(scale)
    worst = _ulp_move(params, 4)
    assert CACHE_TOL / 2 <= worst <= 2 * CACHE_TOL, worst


@pytest.fixture(scope="module")
def ulp_moves():
    """batch -> `_ulp_move` of the scaled Zamba2 the 4-rank cases run."""
    _, params = _scaled_zamba()
    return {batch: _ulp_move(params, batch) for batch in BATCHES}


@pytest.mark.parametrize("mesh_shape,batch,kv", SCALED_CASES)
def test_scaled_zamba2_mesh_decode_within_its_ulp_gate(runs, ulp_moves,
                                                       mesh_shape, batch,
                                                       kv):
    """Zamba2 at chip_smoke.py's activation scale on four ranks, where the
    conv-channel and SSM-head gathers run across ranks: tokens equal,
    logits within 1e-5, and the gathered cache within ULP_GATE times what
    a one-ulp move of the attention output does to it on the plain path
    alone (`_ulp_move`, measured here at the same scale and batch)."""
    gate = ULP_GATE * ulp_moves[batch]
    for r in runs[0]:
        got = r[f"scaled/{_key(mesh_shape, batch, kv)}"]
        assert got["tokens_equal"] and got["logit_rel"] <= LOGIT_TOL, got
        assert got["cache_rel"] <= gate, (got, gate)
        assert got["len_equal"] and got["shapes_ok"], got
