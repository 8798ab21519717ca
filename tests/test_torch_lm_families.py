"""The dense, gemma2 and MoE families of the port against the JAX package on
the CPU, at smoke_config of each of their six architectures (qwen2-7b,
minicpm-2b, command-r-plus-104b, gemma2-27b, qwen3-moe-30b-a3b,
phi3.5-moe-42b-a6.6b: 4 layers, d_model 128, 4 heads of 32, vocab 512;
gemma2's window 64; MoE 4 experts, top 2).

Parameters come from the reference's init_params through
convert.params_from_reference; tokens, activations and caches are made with
numpy from a seed. Tolerances (f32 throughout; the same model summed in
another order):
  * logits, decode-step logits and caches, moe_layer's output: within 1e-4
    of the largest entry of the reference's;
  * the MoE metrics (aux_loss, router_li, drop_frac): within 1e-5;
  * sorted against onehot dispatch in the port: output within 1e-6 of the
    largest entry, the metrics equal;
  * decode through the cache against a prefill over the same tokens, in
    the port: within 1e-4 of the largest logit;
  * greedy generate: tokens identical to the reference's.
The gemma2 cases run prompts and caches longer than its window of 64, and
the embedding scale and both softcaps are each witnessed by parameters
under which removing it moves the logits by more than 1e-2.
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
from repro.models.layers import moe as RMOE
from repro.serving.decode import generate as ref_generate
from repro_torch.configs import registry
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models.layers import moe as TMOE
from repro_torch.serving.decode import generate, prefill

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-4
METRIC_TOL = 1e-5
DISPATCH_TOL = 1e-6
WITNESS = 1e-2
ARCHS = ("qwen2-7b", "minicpm-2b", "command-r-plus-104b", "gemma2-27b",
         "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
MOE = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
SEQ = 72        # past gemma2's smoke window of 64
METRICS = ("aux_loss", "router_li", "drop_frac")


@pytest.fixture(scope="module")
def model():
    """arch -> (reference cfg, port cfg, reference params, port params)."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg = ref_smoke_config(ref_registry.get(arch))
            cfg = smoke_config(registry.get(arch))
            rp = jax.device_get(RM.init_params(rcfg, jax.random.PRNGKey(0)))
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


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _scaled(tree, path, factor):
    """A copy of a numpy parameter tree with the leaf at `path` scaled."""
    out = jax.tree_util.tree_map(lambda a: a, tree)
    node = out
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]] * np.float32(factor)
    return out


def _ref_forward(rcfg, rp, toks, cache=None):
    logits, new_cache, metrics = RM.forward(
        rp, {"tokens": jnp.asarray(toks)}, rcfg, cache=cache)
    return logits, new_cache, metrics


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch):
    assert dataclasses.asdict(registry.get(arch)) == dataclasses.asdict(
        ref_registry.get(arch))
    assert dataclasses.asdict(smoke_config(registry.get(arch))) == \
        dataclasses.asdict(ref_smoke_config(ref_registry.get(arch)))


@pytest.mark.parametrize("arch", sorted(ref_registry.ARCHS))
def test_param_counts_are_the_references(arch):
    rcfg = ref_registry.get(arch)
    cfg = registry.get(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert (cfg.attention_free, cfg.sub_quadratic) == \
        (rcfg.attention_free, rcfg.sub_quadratic)


@pytest.mark.parametrize("arch", sorted(ref_registry.ARCHS))
def test_registry_holds_the_references_archs(arch):
    """The port's registry has the reference's ten keys, each with the
    reference's config, and its family runs: init_params at smoke size."""
    assert sorted(registry.ARCHS) == sorted(ref_registry.ARCHS)
    assert dataclasses.asdict(registry.get(arch)) == dataclasses.asdict(
        ref_registry.get(arch))
    params = TM.init_params(smoke_config(registry.get(arch)), device=CPU)
    assert "final_norm" in params and "layers" in params


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_layout(model, arch):
    rcfg, cfg, rp, _ = model(arch)
    tp = TM.init_params(cfg, seed=0, device=CPU)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    stacks = (tp["layers"]["local"], tp["layers"]["global"]) \
        if cfg.local_global_period else (tp["layers"],)
    per = cfg.n_layers // len(stacks)
    for stack in stacks:
        assert stack["attn"]["wq"]["w"].shape[0] == per
    if cfg.moe:
        assert tp["layers"]["moe"]["w_gate"].shape[:2] == \
            (cfg.n_layers, cfg.moe.num_experts)
    again = TM.init_params(cfg, seed=0, device=CPU)
    assert torch.equal(tp["embed"]["table"], again["embed"]["table"])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_checks_the_stacks(model, arch):
    _, cfg, rp, _ = model(arch)
    deeper = dataclasses.replace(cfg, n_layers=cfg.n_layers + 2)
    with pytest.raises(ValueError, match="layers"):
        params_from_reference(rp, deeper, device=CPU)
    if cfg.moe:
        more = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=cfg.moe.num_experts + 1))
        with pytest.raises(ValueError, match="moe"):
            params_from_reference(rp, more, device=CPU)


# ---------------------------------------------------------------------------
# forward, prefill and its metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(model, arch):
    """The whole smoke model over S = 72 through prefill(with_metrics=True):
    logits, the last position's argmax and, for MoE, the metrics."""
    rcfg, cfg, rp, tp = model(arch)
    toks = _tokens(cfg, 2, SEQ, seed=1)
    want, _, wm = _ref_forward(rcfg, rp, toks)
    nxt, got, metrics = prefill(tp, {"tokens": toks}, cfg, device=CPU,
                                with_metrics=True)
    assert got.dtype == torch.float32
    assert got.shape == (2, SEQ, cfg.padded_vocab)
    assert _rel(got, want) <= TOL
    assert nxt.tolist() == np.asarray(want)[:, -1].argmax(-1).tolist()
    assert sorted(metrics) == sorted(wm)
    for k in wm:
        assert abs(float(metrics[k]) - float(wm[k])) <= METRIC_TOL, k
    assert bool(cfg.moe) == bool(metrics)
    assert TM.forward(tp, {"tokens": torch.as_tensor(toks)}, cfg)[1] is None


def _caches(rcfg, cfg, b, smax, length, seed):
    """The same random KV cache, `length` positions filled, for both."""
    rc = RM.init_cache(rcfg, b, smax, jnp.float32)
    rng = np.random.default_rng(seed)

    def fill(ref_kv):
        k, v = (rng.standard_normal(ref_kv[x].shape).astype(np.float32)
                for x in ("k", "v"))
        n = k.shape[0]
        ref = {"k": jnp.asarray(k), "v": jnp.asarray(v),
               "len": jnp.full((n,), length, jnp.int32)}
        port = {"k": torch.as_tensor(k.copy()), "v": torch.as_tensor(v.copy()),
                "len": [length] * n}
        return ref, port

    if cfg.local_global_period:
        (rl, tl), (rg, tg) = fill(rc["local"]), fill(rc["global"])
        return {"local": rl, "global": rg}, {"local": tl, "global": tg}
    return fill(rc)


def _kv_parts(cache, cfg):
    return ([cache["local"], cache["global"]] if cfg.local_global_period
            else [cache])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches(model, arch):
    """One token through a cache of 70 filled positions (past gemma2's
    window of 64, so its local layers mask the oldest 7)."""
    rcfg, cfg, rp, tp = model(arch)
    length, smax = 70, 80
    rc, tc = _caches(rcfg, cfg, 2, smax, length, seed=2)
    tok = _tokens(cfg, 2, 1, seed=3)
    want, wc, wm = _ref_forward(rcfg, rp, tok, cache=rc)
    got, gc, gm = TM.forward(tp, {"tokens": torch.as_tensor(tok)}, cfg,
                             cache=tc)
    assert gc is tc and got.shape == (2, 1, cfg.padded_vocab)
    assert _rel(got, want) <= TOL
    for g, w in zip(_kv_parts(gc, cfg), _kv_parts(wc, cfg)):
        assert g["len"] == np.asarray(w["len"]).tolist() == \
            [length + 1] * len(g["len"])
        assert _rel(g["k"], w["k"]) <= TOL and _rel(g["v"], w["v"]) <= TOL
    for k in wm:
        assert abs(float(gm[k]) - float(wm[k])) <= METRIC_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_tokens(model, arch):
    rcfg, cfg, rp, tp = model(arch)
    prompt = _tokens(cfg, 2, 8, seed=4)
    want = ref_generate(rcfg, rp, jnp.asarray(prompt, jnp.int32), 6,
                        cache_len=15)
    got = generate(cfg, tp, prompt, 6, cache_len=15, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_through_the_cache_matches_the_prefill(model, arch):
    """Decode S tokens one by one; the last step's logits equal a prefill
    over the same tokens. S = 72 (past gemma2's window); for MoE, S = 8
    and drop_frac == 0 on both sides, asserted: the capacity counts the
    tokens of a call, so a prefill that drops differs from decode by
    design, and with n = 8 tokens no expert can get more assignments than
    its 8 slots (one a token at most)."""
    _, cfg, _, tp = model(arch)
    s = 8 if cfg.moe else SEQ
    toks = torch.as_tensor(_tokens(cfg, 1, s, seed=5))
    _, full, fm = prefill(tp, {"tokens": toks}, cfg, device=CPU,
                          with_metrics=True)
    cache = TM.init_cache(cfg, 1, s + 3, dtype=torch.float32, device=CPU)
    for t in range(s):
        logits, cache, sm = TM.forward(tp, {"tokens": toks[:, t:t + 1]}, cfg,
                                       cache=cache)
        if cfg.moe:
            assert float(sm["drop_frac"]) == 0.0
    if cfg.moe:
        assert float(fm["drop_frac"]) == 0.0
    for part in _kv_parts(cache, cfg):
        assert part["len"] == [s] * len(part["len"])
    assert _rel(logits[0, 0], full[0, -1]) <= TOL


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
def _moe_inputs(model, arch, capacity_factor, dispatch):
    rcfg, cfg, rp, tp = model(arch)
    x = np.random.default_rng(6).standard_normal((2, 24, cfg.d_model))
    x = x.astype(np.float32)
    rmoe = dataclasses.replace(rcfg.moe, capacity_factor=capacity_factor,
                               dispatch=dispatch)
    tmoe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor,
                               dispatch=dispatch)
    rl = jax.tree_util.tree_map(lambda a: a[0], rp["layers"]["moe"])
    tl = TM._layer(tp["layers"]["moe"], 0)
    return x, rl, tl, rmoe, tmoe


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("dispatch", ["sorted", "onehot"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches(model, arch, dispatch, capacity_factor):
    """At capacity factor 0.25 the 48 tokens get 8 slots an expert, and
    most assignments are dropped."""
    x, rl, tl, rmoe, tmoe = _moe_inputs(model, arch, capacity_factor,
                                        dispatch)
    want, wm = RMOE.moe_layer(rl, jnp.asarray(x), rmoe)
    got, gm = TMOE.moe_layer(tl, torch.as_tensor(x), tmoe)
    assert _rel(got, want) <= TOL
    for k in METRICS:
        assert abs(float(gm[k]) - float(wm[k])) <= METRIC_TOL, k
    if capacity_factor < 1:
        assert float(gm["drop_frac"]) > 0.5


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", MOE)
def test_sorted_and_onehot_agree(model, arch, capacity_factor):
    x = torch.as_tensor(_moe_inputs(model, arch, 1.25, "sorted")[0])
    _, _, tl, _, tmoe = _moe_inputs(model, arch, capacity_factor, "sorted")
    ys, ms = TMOE.moe_layer(tl, x, tmoe)
    yo, mo = TMOE.moe_layer(tl, x, dataclasses.replace(tmoe,
                                                       dispatch="onehot"))
    assert _rel(yo, ys) <= DISPATCH_TOL
    assert {k: float(v) for k, v in mo.items()} == \
        {k: float(v) for k, v in ms.items()}
    assert (float(ms["drop_frac"]) > 0) == (capacity_factor < 1)


def test_moe_layer_refuses_a_mesh(model):
    """A mesh that is not a DeviceMesh raises (the expert-parallel path
    itself is in test_torch_mesh_train.py)."""
    _, cfg, _, tp = model("qwen3-moe-30b-a3b")
    with pytest.raises(TypeError, match="not a mesh"):
        TMOE.moe_layer(TM._layer(tp["layers"]["moe"], 0),
                       torch.zeros(1, 2, cfg.d_model), cfg.moe, mesh=object())


def test_router_ties_go_to_the_lower_expert():
    """Equal router logits: the top k are the lowest indices, as
    jax.lax.top_k orders them."""
    params = {"router": {"w": torch.zeros(4, 6)}}
    gates, experts, _ = TMOE.route(params, torch.ones(3, 4), 6, 3)
    assert experts.tolist() == [[0, 1, 2]] * 3
    assert torch.allclose(gates, torch.full((3, 3), 1 / 3))


# ---------------------------------------------------------------------------
# gemma2: the window, the embedding scale and the softcaps
# ---------------------------------------------------------------------------
# each feature, the parameters under which it binds, and the config without it
WITNESSES = {
    "window": ((), 1.0, dict(sliding_window=None)),
    "embed_scale": ((), 1.0, dict(name="nogemma-27b")),
    "attn_softcap": (("layers", "local", "attn", "wq", "w"), 40.0,
                     dict(attn_softcap=None)),
    "final_softcap": (("embed", "table"), 200.0, dict(final_softcap=None)),
}


@pytest.mark.parametrize("feature", sorted(WITNESSES))
def test_gemma2_features_are_witnessed(model, feature):
    """Under parameters where `feature` binds, the port matches the
    reference with it, and the port without it moves the logits."""
    path, factor, without = WITNESSES[feature]
    rcfg, cfg, rp, _ = model("gemma2-27b")
    if path:
        rp = _scaled(rp, path, factor)
    tp = params_from_reference(rp, cfg, device=CPU)
    toks = _tokens(cfg, 2, SEQ, seed=7)
    want, _, _ = _ref_forward(rcfg, rp, toks)
    got = TM.forward(tp, {"tokens": torch.as_tensor(toks)}, cfg)[0]
    assert _rel(got, want) <= TOL
    off = TM.forward(tp, {"tokens": torch.as_tensor(toks)},
                     dataclasses.replace(cfg, **without))[0]
    assert _rel(off, want) > WITNESS


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_family(capsys, arch):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--tokens", "3"])
    out = capsys.readouterr().out
    assert f"{arch} on cpu: generated 6 tokens" in out
