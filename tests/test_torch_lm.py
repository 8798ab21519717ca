"""The Zamba2 serving path of the port against the JAX package on the CPU:
mamba2_block (prefill with S not a multiple of the chunk, and a decode
step), attention_block (prefill and decode), the whole forward of
smoke_config(zamba2-7b) (5 layers, period 3: one group, the shared block
and a tail of 2), prefill and greedy generate. Parameters come from the
reference's init_params through convert.params_from_reference; inputs and
caches are made with numpy from a seed. Float32 within 1e-4 of the largest
entry (same model, another summation order); generated tokens identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.models.layers import attention as RA
from repro.models.layers import mamba2 as RMB
from repro.serving.decode import generate as ref_generate
from repro_torch.configs import registry
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import mamba2 as TMB
from repro_torch.serving.decode import generate, make_serve_step, prefill

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-4


@pytest.fixture(scope="module")
def cfgs():
    return (ref_smoke_config(ref_registry.get("zamba2-7b")),
            smoke_config(registry.get("zamba2-7b")))


@pytest.fixture(scope="module")
def params(cfgs):
    """The reference's parameters with the embedding scaled from std 0.02 to
    std 1: at 0.02 the Mamba2 blocks (no residual) shrink the activations
    to ~1e-15 within five layers, and a relative comparison of the logits
    would measure rounding noise."""
    rp = jax.device_get(RM.init_params(cfgs[0], jax.random.PRNGKey(0)))
    rp["embed"] = {"table": rp["embed"]["table"] * np.float32(50.0)}
    return rp, params_from_reference(rp, cfgs[1], device=CPU)


def _rel(got, want):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _first(tree):
    return jax.tree_util.tree_map(lambda t: t[0], tree)


def test_config_is_the_references(cfgs):
    import dataclasses

    ref, port = (dataclasses.asdict(c) for c in cfgs)
    assert ref == port
    full = registry.get("zamba2-7b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        ref_registry.get("zamba2-7b"))
    assert (full.d_model, full.ssm.expand * full.d_model, full.n_layers) \
        == (3584, 7168, 81)


def test_registry_refuses_an_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch 'zamba3-7b'"):
        registry.get("zamba3-7b")


def test_init_params_has_the_references_layout(cfgs, params):
    tp = TM.init_params(cfgs[1], seed=0, device=CPU)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params[0])
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    again = TM.init_params(cfgs[1], seed=0, device=CPU)
    w = "layers", "in_proj", "w"
    assert torch.equal(tp[w[0]][w[1]][w[2]], again[w[0]][w[1]][w[2]])


@pytest.mark.parametrize("s", [40, 16])
def test_mamba2_prefill_matches(cfgs, params, s):
    """S = 40 pads to 48 (three chunks of 16); S = 16 is one whole chunk."""
    rcfg, cfg = cfgs
    x = np.random.default_rng(1).standard_normal((2, s, cfg.d_model))
    want, _ = RMB.mamba2_block(_first(params[0]["layers"]),
                               jnp.asarray(x, jnp.float32), rcfg.ssm)
    got, cache = TMB.mamba2_block(TM._layer(params[1]["layers"], 0),
                                  torch.as_tensor(x, dtype=torch.float32),
                                  cfg.ssm)
    assert cache is None and got.shape == (2, s, cfg.d_model)
    assert _rel(got, want) <= TOL


def test_mamba2_decode_step_matches(cfgs, params):
    rcfg, cfg = cfgs
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shapes = RMB.init_mamba2_cache(2, cfg.d_model, rcfg.ssm)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in shapes.items()}
    want, wc = RMB.mamba2_block(_first(params[0]["layers"]), jnp.asarray(x),
                                rcfg.ssm, {k: jnp.asarray(v)
                                           for k, v in cache.items()})
    got, gc = TMB.mamba2_block(TM._layer(params[1]["layers"], 0),
                               torch.as_tensor(x), cfg.ssm,
                               {k: torch.as_tensor(v)
                                for k, v in cache.items()})
    assert _rel(got, want) <= TOL
    for k in ("conv", "ssm"):
        assert _rel(gc[k], wc[k]) <= TOL


@pytest.mark.parametrize("kv_chunk", [1024, 16])
def test_attention_block_prefill_matches(cfgs, params, kv_chunk):
    """kv_chunk 16 over S = 40 runs three KV chunks, the last one short."""
    rcfg, cfg = cfgs
    kw = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
              kv_chunk=kv_chunk)
    x = np.random.default_rng(3).standard_normal((2, 40, cfg.d_model))
    want, _ = RA.attention_block(params[0]["shared_attn"]["attn"],
                                 jnp.asarray(x, jnp.float32), **kw)
    got, _ = TA.attention_block(params[1]["shared_attn"]["attn"],
                                torch.as_tensor(x, dtype=torch.float32), **kw)
    assert _rel(got, want) <= TOL


def test_attention_block_decode_matches(cfgs, params):
    rcfg, cfg = cfgs
    hd, smax, length = cfg.resolved_head_dim, 12, 7
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, smax, cfg.kv_heads, hd)).astype(np.float32)
          for _ in range(2)]
    kw = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=hd,
              rope_theta=cfg.rope_theta)
    want, wc = RA.attention_block(
        params[0]["shared_attn"]["attn"], jnp.asarray(x),
        cache={"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
               "len": jnp.int32(length)}, **kw)
    cache = {"k": torch.as_tensor(kv[0].copy()),
             "v": torch.as_tensor(kv[1].copy()), "len": length}
    got, gc = TA.attention_block(params[1]["shared_attn"]["attn"],
                                 torch.as_tensor(x), cache=cache, **kw)
    assert _rel(got, want) <= TOL
    assert gc["len"] == length + 1 and gc["k"] is cache["k"]
    assert _rel(gc["k"], wc["k"]) <= TOL and _rel(gc["v"], wc["v"]) <= TOL


def test_forward_matches(cfgs, params):
    """The whole smoke Zamba2 over S = 40: the group of 3, the shared
    attention block, the tail of 2, final norm and tied unembedding."""
    rcfg, cfg = cfgs
    toks = _tokens(cfg, 2, 40, seed=5)
    want, _, _ = RM.forward(params[0], {"tokens": jnp.asarray(toks)}, rcfg)
    got, cache, _ = TM.forward(params[1], {"tokens": torch.as_tensor(toks)},
                               cfg)
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 40, cfg.padded_vocab)
    assert float(got.abs().max()) > 1.0
    assert _rel(got, want) <= TOL
    ref_logits = TM.forward(params[1], {"tokens": torch.as_tensor(toks)},
                            cfg, use_kernel="ref")[0]
    assert torch.equal(got, ref_logits)


def test_prefill_is_the_last_positions_argmax(cfgs, params):
    rcfg, cfg = cfgs
    toks = _tokens(cfg, 2, 24, seed=6)
    want, _, _ = RM.forward(params[0], {"tokens": jnp.asarray(toks)}, rcfg)
    nxt, logits = prefill(params[1], {"tokens": toks}, cfg, device=CPU)
    assert _rel(logits, want) <= TOL
    assert nxt.tolist() == np.asarray(want)[:, -1].argmax(-1).tolist()


def test_generate_matches_reference_tokens(cfgs, params):
    rcfg, cfg = cfgs
    prompt = _tokens(cfg, 2, 8, seed=7)
    want = ref_generate(rcfg, params[0], jnp.asarray(prompt, jnp.int32), 6,
                        cache_len=15)
    got = generate(cfg, params[1], prompt, 6, cache_len=15, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    assert got.tolist() == np.asarray(want).tolist()


def test_decode_through_the_cache_matches_the_prefill_tail(cfgs, params):
    """Decode 17 tokens one by one through the cache; the last step's
    logits equal a prefill over the same 17 tokens (17 is not a multiple
    of the chunk, so the prefill pads), within the 2e-2 that the
    reference's own test uses."""
    _, cfg = cfgs
    toks = torch.as_tensor(_tokens(cfg, 1, 17, seed=8))
    _, full = prefill(params[1], {"tokens": toks}, cfg, device=CPU)
    cache = TM.init_cache(cfg, 1, 32, dtype=torch.float32, device=CPU)
    for t in range(17):
        logits, cache, _ = TM.forward(params[1], {"tokens": toks[:, t:t + 1]},
                                      cfg, cache=cache)
    assert cache["shared_attn"]["len"] == [17]
    np.testing.assert_allclose(logits[0, 0].numpy(), full[0, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_the_references_init_leaves_no_signal_at_depth(cfgs):
    """Why the tests and chip_smoke.py scale the embedding: at the
    reference's init (embedding std 0.02) the smoke model's logits are
    ~1e-15, because the Mamba2 blocks run with no residual and their gated
    norm sits under its eps; at std 1 they are O(10)."""
    _, cfg = cfgs
    params = TM.init_params(cfg, seed=0, device=CPU)
    toks = {"tokens": torch.as_tensor(_tokens(cfg, 1, 16, seed=9))}
    assert float(TM.forward(params, toks, cfg)[0].abs().max()) < 1e-9
    params["embed"]["table"].mul_(50.0)
    assert float(TM.forward(params, toks, cfg)[0].abs().max()) > 1.0


def test_serve_step_casts_only_when_needed(cfgs, params):
    _, cfg = cfgs
    step = make_serve_step(cfg, compute_dtype=torch.float32)
    cache = TM.init_cache(cfg, 2, 4, dtype=torch.float32, device=CPU)
    tok, cache = step(params[1], {"tokens": torch.zeros(2, 1,
                                                       dtype=torch.long)},
                      cache)
    assert tok.dtype == torch.int32 and cache["shared_attn"]["len"] == [1]


def test_bf16_params_from_reference(cfgs):
    rcfg, cfg = cfgs
    rp = jax.device_get(RM.init_params(rcfg, jax.random.PRNGKey(1),
                                       jnp.bfloat16))
    tp = params_from_reference(rp, cfg, device=CPU)
    w = tp["layers"]["in_proj"]["w"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.float().numpy(), np.asarray(
        rp["layers"]["in_proj"]["w"], np.float32))
    assert params_from_reference(rp, cfg, device=CPU, dtype=torch.float32)[
        "embed"]["table"].dtype == torch.float32


def test_params_from_reference_checks_the_layer_counts(cfgs, params):
    import dataclasses

    deeper = dataclasses.replace(cfgs[1], n_layers=8)
    with pytest.raises(ValueError, match="layers"):
        params_from_reference(params[0], deeper, device=CPU)


def test_pure_ssm_is_refused_and_dense_runs(cfgs):
    """A pure SSM config (Zamba2 without its attention period) is refused by
    the model, as the reference cannot run it; a dense config (Zamba2's
    widths without the SSM) runs."""
    import dataclasses

    pure = dataclasses.replace(cfgs[1], hybrid_attn_period=0, family="ssm")
    with pytest.raises(NotImplementedError, match="pure SSM"):
        TM.init_params(pure, device=CPU)
    with pytest.raises(NotImplementedError, match="pure SSM"):
        TM.forward({}, {"tokens": torch.zeros(1, 1, dtype=torch.long)},
                   pure)
    dense = dataclasses.replace(cfgs[1], ssm=None, hybrid_attn_period=0,
                                family="dense")
    params = TM.init_params(dense, device=CPU)
    logits, _, metrics = TM.forward(
        params, {"tokens": torch.zeros(1, 3, dtype=torch.long)}, dense)
    assert logits.shape == (1, 3, dense.padded_vocab) and metrics == {}
    assert bool(torch.isfinite(logits).all())


def test_serve_cli_on_the_cpu(capsys):
    serve.main(["--arch", "qwen2-7b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "qwen2-7b on cpu: generated 6 tokens" in out
    with pytest.raises(SystemExit, match="unknown arch"):
        serve.main(["--arch", "rwkv7-7b", "--device", "cpu"])
