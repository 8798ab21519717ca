"""The rwkv6, vlm and audio families of the port against the JAX package on
the CPU, at smoke_config of their architectures (rwkv6-7b,
llama-3.2-vision-11b, hubert-xlarge: 4 layers, d_model 128, 4 heads of 32,
vocab 512; RWKV chunk 16, decay LoRA 16; the vlm's period 2 with 16 image
tokens).

Parameters come from the reference's init_params through
convert.params_from_reference; tokens, embeddings, image embeddings and
caches are made with numpy from a seed. The vlm's gates are zero at init,
which makes its cross-attention contribute nothing, so every vlm case first
sets them to GATE in the shared numpy tree. Tolerances (f32 throughout; the
same model summed in another order):
  * logits, layer outputs and caches: within 1e-4 of the largest entry of
    the reference's;
  * decode through the cache against a prefill over the same tokens, in
    the port: within 1e-4 of the largest logit;
  * greedy generate: tokens identical to the reference's.
Witnesses: under parameters where it binds, scaling out the vlm's gate,
RWKV's bonus u or its decay LoRA moves the logits by more than 1e-2 of the
largest; redrawing hubert's last frame moves its first frame's logits (a
causal encoder would leave them exactly unchanged).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.models.layers import attention as RA
from repro.models.layers import rwkv6 as RR
from repro.serving.decode import generate as ref_generate
from repro_torch.configs import registry
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import rwkv6 as TR
from repro_torch.serving.decode import generate, make_serve_step, prefill

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-4
WITNESS = 1e-2
GATE = 0.5
RWKV, VLM, AUDIO = "rwkv6-7b", "llama-3.2-vision-11b", "hubert-xlarge"
ARCHS = (RWKV, VLM, AUDIO)
DECODERS = (RWKV, VLM)
SEQ = 40        # the RWKV chunk is 16: three chunks, the last one padded


def _gated(rp):
    """A copy of a vlm parameter tree with every cross layer's gate GATE."""
    out = jax.tree_util.tree_map(lambda a: a, rp)
    out["cross_layers"] = dict(out["cross_layers"], gate=np.full_like(
        rp["cross_layers"]["gate"], GATE))
    return out


@pytest.fixture(scope="module")
def model():
    """arch -> (reference cfg, port cfg, reference params, port params);
    the vlm's gates set to GATE."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg = ref_smoke_config(ref_registry.get(arch))
            cfg = smoke_config(registry.get(arch))
            rp = jax.device_get(RM.init_params(rcfg, jax.random.PRNGKey(0)))
            if cfg.cross_attn_period:
                rp = _gated(rp)
            built[arch] = (rcfg, cfg, rp,
                           params_from_reference(rp, cfg, device=CPU))
        return built[arch]
    return get


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _scaled(tree, path, factor):
    """A copy of a numpy parameter tree with the leaf at `path` scaled."""
    out = jax.tree_util.tree_map(lambda a: a, tree)
    node = out
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]] * np.float32(factor)
    return out


def _inputs(cfg, b, s, seed=0):
    """The forward batch of the arch, as numpy: tokens or frame embeddings,
    and the vlm's image embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s))}
    else:
        batch = {"embeds": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
    if cfg.cross_attn_period:
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _ref_forward(rcfg, rp, batch, cache=None):
    return RM.forward(rp, {k: jnp.asarray(v) for k, v in batch.items()},
                      rcfg, cache=cache)


def _port_forward(cfg, tp, batch, cache=None):
    return TM.forward(tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                      cfg, cache=cache)


def _first(tree):
    return jax.tree_util.tree_map(lambda t: t[0], tree)


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_are_the_references(arch):
    cfg, rcfg = registry.get(arch), ref_registry.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(smoke_config(cfg)) == \
        dataclasses.asdict(ref_smoke_config(rcfg))
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (rcfg.param_count(), rcfg.active_param_count())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_layout(model, arch):
    _, cfg, rp, _ = model(arch)
    tp = TM.init_params(cfg, seed=0, device=CPU)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    assert ("embed" in tp) == cfg.embed_inputs
    assert ("head" in tp) == (not cfg.tie_embeddings)
    if cfg.cross_attn_period:
        assert not bool(tp["cross_layers"]["gate"].any())
    again = TM.init_params(cfg, seed=0, device=CPU)
    path = ("wr", "w") if cfg.rwkv else ("attn", "wq", "w")
    w, w_again = tp["layers"], again["layers"]
    for key in path:
        w, w_again = w[key], w_again[key]
    assert torch.equal(w, w_again)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_checks_the_stacks(model, arch):
    _, cfg, rp, _ = model(arch)
    deeper = dataclasses.replace(
        cfg, n_layers=cfg.n_layers + (cfg.cross_attn_period or 2))
    with pytest.raises(ValueError, match="layers"):
        params_from_reference(rp, deeper, device=CPU)
    if not cfg.tie_embeddings:
        headless = {k: v for k, v in rp.items() if k != "head"}
        with pytest.raises(ValueError, match="head"):
            params_from_reference(headless, cfg, device=CPU)


# ---------------------------------------------------------------------------
# the RWKV6 layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [16, 40, 17])
def test_rwkv6_time_mix_prefill_matches(model, s):
    """One chunk, three chunks with the last padded, two with 15 of 16
    positions of padding."""
    rcfg, cfg, rp, tp = model(RWKV)
    x = np.random.default_rng(1).standard_normal((2, s, cfg.d_model))
    x = x.astype(np.float32)
    want, _ = RR.rwkv6_time_mix(_first(rp["layers"]), jnp.asarray(x),
                                rcfg.rwkv)
    got, cache = TR.rwkv6_time_mix(TM._layer(tp["layers"], 0),
                                   torch.as_tensor(x), cfg.rwkv)
    assert cache is None and got.shape == (2, s, cfg.d_model)
    assert _rel(got, want) <= TOL


def _rwkv_layer_cache(cfg, b, seed):
    rng = np.random.default_rng(seed)
    h, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    shapes = {"shift_t": (b, 1, cfg.d_model), "shift_c": (b, 1, cfg.d_model),
              "wkv": (b, h, hd, hd)}
    return {k: rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def test_rwkv6_decode_step_matches(model):
    """One token through a layer with a random cache: its output, the new
    WKV state and both shifts (shift_c after the time-mix residual)."""
    rcfg, cfg, rp, tp = model(RWKV)
    cache = _rwkv_layer_cache(cfg, 2, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 1, cfg.d_model))
    x = x.astype(np.float32)
    want, wc = RM._rwkv_layer_impl(_first(rp["layers"]), jnp.asarray(x),
                                   rcfg, {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    got, gc = TM._rwkv_layer(TM._layer(tp["layers"], 0), torch.as_tensor(x),
                             cfg, {k: torch.as_tensor(v)
                                   for k, v in cache.items()})
    assert _rel(got, want) <= TOL
    assert sorted(gc) == sorted(wc) == ["shift_c", "shift_t", "wkv"]
    for k in gc:
        assert _rel(gc[k], wc[k]) <= TOL, k
    assert _rel(gc["shift_t"], x) == 0.0


@pytest.mark.parametrize("with_last", [False, True])
def test_rwkv6_channel_mix_matches(model, with_last):
    rcfg, cfg, rp, tp = model(RWKV)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    last = (rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            if with_last else None)
    want = RR.rwkv6_channel_mix(_first(rp["layers"]), jnp.asarray(x),
                                None if last is None else jnp.asarray(last))
    got = TR.rwkv6_channel_mix(TM._layer(tp["layers"], 0), torch.as_tensor(x),
                               None if last is None else torch.as_tensor(last))
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 24])
def test_cross_attention_matches(model, s):
    """Queries from x, keys and values from the 16 image tokens: no RoPE,
    not causal (S = 1 is the decode step's shape)."""
    rcfg, cfg, rp, tp = model(VLM)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    img = rng.standard_normal((2, cfg.num_image_tokens, cfg.d_model))
    img = img.astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
    want, _ = RA.attention_block(_first(rp["cross_layers"])["cross_attn"],
                                 jnp.asarray(x), cross_kv=jnp.asarray(img),
                                 **kw)
    got, cache = TA.attention_block(
        TM._layer(tp["cross_layers"], 0)["cross_attn"], torch.as_tensor(x),
        cross_kv=torch.as_tensor(img), **kw)
    assert cache is None and got.shape == (2, s, cfg.d_model)
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(model, arch):
    """The whole smoke model over S = 40 through prefill: logits and the
    last position's argmax."""
    rcfg, cfg, rp, tp = model(arch)
    batch = _inputs(cfg, 2, SEQ, seed=6)
    want, _, _ = _ref_forward(rcfg, rp, batch)
    nxt, got = prefill(tp, batch, cfg, device=CPU)
    assert got.dtype == torch.float32
    assert got.shape == (2, SEQ, cfg.padded_vocab)
    assert _rel(got, want) <= TOL
    assert nxt.tolist() == np.asarray(want)[:, -1].argmax(-1).tolist()


def _caches(rcfg, cfg, b, smax, length, seed):
    """The same random decode cache for both (`length` positions of a KV
    cache filled)."""
    rng = np.random.default_rng(seed)
    if cfg.rwkv:
        ref = RM.init_cache(rcfg, b, smax, jnp.float32)
        arrays = {k: rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in ref.items()}
        return ({k: jnp.asarray(v) for k, v in arrays.items()},
                {k: torch.as_tensor(v.copy()) for k, v in arrays.items()})
    kv = RM.init_cache(rcfg, b, smax, jnp.float32)["self"]
    k, v = (rng.standard_normal(kv[x].shape).astype(np.float32)
            for x in ("k", "v"))
    groups, per = k.shape[:2]
    ref = {"k": jnp.asarray(k), "v": jnp.asarray(v),
           "len": jnp.full((groups, per), length, jnp.int32)}
    port = {"k": torch.as_tensor(k.copy()), "v": torch.as_tensor(v.copy()),
            "len": [[length] * per for _ in range(groups)]}
    return {"self": ref}, {"self": port}


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches(model, arch):
    """One token through a random cache (the vlm's with 30 positions
    filled): the logits and every cache entry."""
    rcfg, cfg, rp, tp = model(arch)
    length = 30
    rc, tc = _caches(rcfg, cfg, 2, 36, length, seed=7)
    batch = _inputs(cfg, 2, 1, seed=8)
    want, wc, _ = _ref_forward(rcfg, rp, batch, cache=rc)
    got, gc, _ = _port_forward(cfg, tp, batch, cache=tc)
    assert gc is tc and got.shape == (2, 1, cfg.padded_vocab)
    assert _rel(got, want) <= TOL
    if cfg.rwkv:
        for k in ("shift_t", "shift_c", "wkv"):
            assert _rel(gc[k], wc[k]) <= TOL, k
        return
    g, w = gc["self"], wc["self"]
    assert np.asarray(w["len"]).tolist() == g["len"] == \
        [[length + 1] * len(g["len"][0])] * len(g["len"])
    assert _rel(g["k"], w["k"]) <= TOL and _rel(g["v"], w["v"]) <= TOL


@pytest.mark.parametrize("arch", DECODERS)
def test_generate_matches_reference_tokens(model, arch):
    rcfg, cfg, rp, tp = model(arch)
    batch = _inputs(cfg, 2, 8, seed=9)
    img = batch.get("image_embeds")
    want = ref_generate(rcfg, rp, jnp.asarray(batch["tokens"], jnp.int32), 6,
                        cache_len=15,
                        image_embeds=None if img is None else jnp.asarray(img))
    got = generate(cfg, tp, batch["tokens"], 6, cache_len=15, device=CPU,
                   image_embeds=img)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_through_the_cache_matches_the_prefill(model, arch):
    """Decode 17 tokens one by one; the last step's logits equal a prefill
    over the same tokens (17 is not a multiple of RWKV's chunk of 16, so
    its prefill pads)."""
    _, cfg, _, tp = model(arch)
    s = 17
    batch = {k: torch.as_tensor(v) for k, v in _inputs(cfg, 1, s,
                                                        seed=10).items()}
    _, full = prefill(tp, batch, cfg, device=CPU)
    cache = TM.init_cache(cfg, 1, s + 3, dtype=torch.float32, device=CPU)
    extra = {k: v for k, v in batch.items() if k == "image_embeds"}
    with torch.no_grad():
        for t in range(s):
            logits, cache, _ = TM.forward(
                tp, {"tokens": batch["tokens"][:, t:t + 1], **extra}, cfg,
                cache=cache)
    if cfg.cross_attn_period:
        assert cache["self"]["len"] == [[s]] * (cfg.n_layers // 2)
    assert _rel(logits[0, 0], full[0, -1]) <= TOL


# ---------------------------------------------------------------------------
# witnesses
# ---------------------------------------------------------------------------
# each feature: its arch, the parameters under which it binds (leaf and
# factor; none: the reference's own), and the leaf that scales it out. At
# the reference's embedding std of 0.02 the RWKV features move the logits
# by ~1e-4 (u) and ~3e-6 (the decay LoRA); at std 1 by ~0.15 and ~0.03.
WITNESSES = {
    "vlm_gate": (VLM, None, ("cross_layers", "gate")),
    "u_bonus": (RWKV, (("embed", "table"), 50.0), ("layers", "u_bonus")),
    "decay_lora": (RWKV, (("embed", "table"), 50.0),
                   ("layers", "w_lora_b")),
}


@pytest.mark.parametrize("feature", sorted(WITNESSES))
def test_features_are_witnessed(model, feature):
    """Under parameters where `feature` binds, the port matches the
    reference with it and without it, and taking it out moves the logits
    by more than WITNESS of their largest entry."""
    arch, binds, leaf = WITNESSES[feature]
    rcfg, cfg, rp, _ = model(arch)
    if binds:
        rp = _scaled(rp, *binds)
    off = _scaled(rp, leaf, 0.0)
    batch = _inputs(cfg, 2, SEQ, seed=11)
    want, _, _ = _ref_forward(rcfg, rp, batch)
    want_off, _, _ = _ref_forward(rcfg, off, batch)
    got = _port_forward(cfg, params_from_reference(rp, cfg, device=CPU),
                        batch)[0]
    got_off = _port_forward(cfg, params_from_reference(off, cfg, device=CPU),
                            batch)[0]
    assert _rel(got, want) <= TOL and _rel(got_off, want_off) <= TOL
    assert _rel(got_off, want) > WITNESS


def test_hubert_is_bidirectional(model):
    """Redrawing the last frame moves the first frame's logits, in the port
    as in the reference; a causal encoder would leave them unchanged."""
    rcfg, cfg, rp, tp = model(AUDIO)
    batch = _inputs(cfg, 2, SEQ, seed=12)
    moved = {"embeds": batch["embeds"].copy()}
    moved["embeds"][:, -1] = np.random.default_rng(13).standard_normal(
        (2, cfg.d_model))
    got, got_moved = (prefill(tp, b, cfg, device=CPU)[1]
                      for b in (batch, moved))
    want_moved = _ref_forward(rcfg, rp, moved)[0]
    assert _rel(got_moved, want_moved) <= TOL
    assert _rel(got_moved[:, 0], got[:, 0]) > 0
    causal = dataclasses.replace(cfg, encoder_only=False)
    first = [TM.forward(tp, {"embeds": torch.as_tensor(b["embeds"])},
                        causal)[0][:, 0] for b in (batch, moved)]
    assert torch.equal(*first)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def _refusals(model):
    """name -> (a call that must raise ValueError, the message)."""
    _, vcfg, _, vp = model(VLM)
    _, acfg, _, ap = model(AUDIO)
    _, rcfg, _, rp = model(RWKV)
    toks = _inputs(vcfg, 1, 4, seed=14)["tokens"]
    layer = TM._layer(rp["layers"], 0)
    rcache = {k: torch.as_tensor(v) for k, v in
              _rwkv_layer_cache(rcfg, 1, seed=15).items() if k != "shift_c"}
    return {
        "vlm prefill": (lambda: prefill(vp, {"tokens": toks}, vcfg,
                                        device=CPU), "image_embeds"),
        "vlm generate": (lambda: generate(vcfg, vp, toks, 2, 8, device=CPU),
                         "image_embeds"),
        "hubert generate": (lambda: generate(acfg, ap, toks, 2, 8,
                                             device=CPU), "encoder-only"),
        "hubert serve step": (lambda: make_serve_step(acfg),
                              "encoder-only"),
        "hubert init_cache": (lambda: TM.init_cache(acfg, 1, 8, device=CPU),
                              "encoder-only"),
        "hubert cached forward": (lambda: TM.forward(
            ap, {"embeds": torch.zeros(1, 1, acfg.d_model)}, acfg,
            cache={}), "encoder-only"),
        "rwkv6 cached S > 1": (lambda: TR.rwkv6_time_mix(
            layer, torch.zeros(1, 2, rcfg.d_model), rcfg.rwkv, rcache),
            "one token"),
    }


REFUSALS = ("vlm prefill", "vlm generate", "hubert generate",
            "hubert serve step", "hubert init_cache", "hubert cached forward",
            "rwkv6 cached S > 1")


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals(model, case):
    call, message = _refusals(model)[case]
    with pytest.raises(ValueError, match=message):
        call()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DECODERS)
def test_serve_cli_runs_each_decoder(capsys, arch):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--tokens", "3"])
    out = capsys.readouterr().out
    assert f"{arch} on cpu: generated 6 tokens" in out


def test_serve_cli_refuses_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO, "--device", "cpu"])
