"""The port's training forward against the JAX package on the CPU: the
cross-entropy, loss_fn and its gradients for all ten architectures, remat
(train=True) against the plain forward, and the differentiable SSD.

Parameters come from the reference's init_params through
convert.params_from_reference, batches from the reference's SyntheticLM
(numpy), at smoke_config sizes (4 layers, d_model 128; Zamba2 5 layers).
The vlm's gates are set to 0.5 (at 0, tanh(0) zeroes every
cross-attention gradient) and Zamba2's embedding is scaled by 10 (at the
reference's std 0.02 its activations vanish and every gradient is ~0);
the MoE aux term is in the loss. Tolerances, f32 throughout (the same
function summed in another order):
  * the loss within 1e-5 of the reference's, relative;
  * each gradient leaf within 1e-4 of that leaf's largest reference entry;
  * the SSD's gradients as the model's (1e-4 of each one's largest
    reference entry), and bit for bit autograd's through the plain scan
    alone;
  * train=True against train=False: the loss equal, each gradient leaf
    within 1e-6 of its largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.models.layers import common as RC
from repro.models.layers import mamba2 as RMB
from repro.training import data as RD
from repro_torch.configs import registry
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels.ssd_chunk.kernel import ssd_scan_plain
from repro_torch.models import model as TM
from repro_torch.models.layers import common as TC
from repro_torch.models.layers import mamba2 as TMB
from repro_torch.training.train_loop import batch_to_device, loss_and_grads
from repro_torch.training.tree import leaves_with_paths

torch.set_num_threads(1)

CPU = "cpu"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
VLM_GATE = 0.5
EMBED_SCALE = 10.0
ARCHS = ("qwen2-7b", "minicpm-2b", "command-r-plus-104b", "gemma2-27b",
         "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "zamba2-7b",
         "rwkv6-7b", "llama-3.2-vision-11b", "hubert-xlarge")
SEQ, BATCH = 40, 2


def _ref_params(rcfg):
    """The reference's parameters (numpy), with the vlm's gates at 0.5 and
    Zamba2's embedding scaled."""
    rp = jax.device_get(RM.init_params(rcfg, jax.random.PRNGKey(0)))
    if rcfg.cross_attn_period:
        rp["cross_layers"]["gate"] = np.full_like(rp["cross_layers"]["gate"],
                                                  VLM_GATE)
    if rcfg.ssm is not None:
        rp["embed"]["table"] = rp["embed"]["table"] * EMBED_SCALE
    return rp


@pytest.fixture(scope="module")
def model():
    """arch -> (reference cfg, port cfg, reference params, a batch)."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg = ref_smoke_config(ref_registry.get(arch))
            data = RD.SyntheticLM(RD.DataConfig(vocab=rcfg.vocab,
                                                seq_len=SEQ,
                                                global_batch=BATCH))
            built[arch] = (rcfg, smoke_config(registry.get(arch)),
                           _ref_params(rcfg), data.batch_for_model(0, rcfg))
        return built[arch]
    return get


def _ref_loss_and_grads(rcfg, rp, batch):
    """jax.value_and_grad of the reference's loss_fn(train=True): (loss,
    {keystr path: gradient})."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.value_and_grad(
        lambda p: RM.loss_fn(p, jbatch, rcfg, mesh=None, train=True),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, rp))
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(g))
    return float(loss), {jax.tree_util.keystr(p): np.asarray(v)
                         for p, v in flat}


def _leaf_err(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def test_softmax_cross_entropy_matches_reference_padded_columns_count():
    """Over a padded vocabulary (500 real columns of 512): the padded
    columns count in logsumexp, as in the reference."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 512)).astype(np.float32) * 3
    labels = rng.integers(0, 500, (3, 7)).astype(np.int32)
    want = float(RC.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = TC.softmax_cross_entropy(torch.as_tensor(logits),
                                   torch.as_tensor(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= LOSS_TOL * abs(want)
    unpadded = TC.softmax_cross_entropy(torch.as_tensor(logits[..., :500]),
                                        torch.as_tensor(labels))
    assert abs(float(unpadded) - want) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(model, arch):
    rcfg, cfg, rp, batch = model(arch)
    want_loss, want = _ref_loss_and_grads(rcfg, rp, batch)
    params = params_from_reference(rp, cfg, device=CPU)
    loss, metrics, grads = loss_and_grads(params,
                                          batch_to_device(batch, CPU), cfg)
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["ce_loss"]) == float(loss)
    got = dict(leaves_with_paths(grads))
    assert sorted(got) == sorted(want)
    errs = {path: _leaf_err(g, want[path]) for path, g in got.items()}
    bad = {p: e for p, e in errs.items() if not e <= GRAD_TOL}
    assert not bad, bad
    # the checks see real gradients: none of them is all zeros
    assert all(float(g.abs().max()) > 0 for g in got.values())
    if cfg.moe is not None:
        assert float(metrics["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ("qwen2-7b", "zamba2-7b"))
def test_remat_matches_the_plain_forward(model, arch):
    rcfg, cfg, rp, batch = model(arch)
    tb = batch_to_device(batch, CPU)
    out = {}
    for train in (True, False):
        params = params_from_reference(rp, cfg, device=CPU)
        flat = [leaf.requires_grad_() for _, leaf in
                leaves_with_paths(params)]
        loss, _ = TM.loss_fn(params, tb, cfg, train=train)
        out[train] = (loss.detach(), torch.autograd.grad(loss, flat))
    assert float(out[True][0]) == float(out[False][0])
    for g_remat, g_plain in zip(out[True][1], out[False][1]):
        assert _leaf_err(g_remat, g_plain.numpy()) <= REMAT_TOL


def _ssd_inputs(rng, b=2, s=48, h=3, p=8, n=4):
    return {"xh": rng.standard_normal((b, s, h, p)),
            "dt": np.abs(rng.standard_normal((b, s, h))) * 0.5,
            "a_log": np.log(np.linspace(1.0, 4.0, h)),
            "b_mat": rng.standard_normal((b, s, n)),
            "c_mat": rng.standard_normal((b, s, n)),
            "init_state": rng.standard_normal((b, h, n, p)) * 0.5}


def test_ssd_grad_matches_reference_across_chunks():
    """The port's _ssd_chunked (SSDScan) against jax.grad through the
    reference's _ssd_chunked, over 3 chunks of 16 from a nonzero state,
    with respect to every input."""
    rng = np.random.default_rng(1)
    ins = {k: v.astype(np.float32) for k, v in _ssd_inputs(rng).items()}
    wy = rng.standard_normal(ins["xh"].shape).astype(np.float32)
    ws = rng.standard_normal(ins["init_state"].shape).astype(np.float32)
    names = list(ins)

    def ref_obj(*args):
        kw = dict(zip(names, args))
        y, final = RMB._ssd_chunked(kw["xh"], kw["dt"], kw["a_log"],
                                    kw["b_mat"], kw["c_mat"], 16,
                                    init_state=kw["init_state"])
        return jnp.sum(y * wy) + jnp.sum(final * ws)

    want = jax.grad(ref_obj, argnums=tuple(range(len(names))))(
        *(jnp.asarray(ins[k]) for k in names))
    t = {k: torch.tensor(v, requires_grad=True) for k, v in ins.items()}
    y, final = TMB._ssd_chunked(t["xh"], t["dt"], t["a_log"], t["b_mat"],
                                t["c_mat"], 16, init_state=t["init_state"])
    obj = (y * torch.as_tensor(wy)).sum() + (final * torch.as_tensor(ws)).sum()
    got = torch.autograd.grad(obj, [t[k] for k in names])
    for name, g, w in zip(names, got, want):
        assert _leaf_err(g, w) <= GRAD_TOL, name


def test_ssd_grad_matches_reference_padded():
    """A Mamba2 block over 40 steps (padded to 3 chunks of 16): gradients
    of every parameter and of the input against the reference's."""
    rcfg = ref_smoke_config(ref_registry.get("zamba2-7b"))
    cfg = smoke_config(registry.get("zamba2-7b"))
    rp = jax.device_get(RMB.init_mamba2(jax.random.PRNGKey(3), rcfg.d_model,
                                        rcfg.ssm))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, rcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def ref_obj(p, xx):
        return jnp.sum(RMB.mamba2_block(p, xx, rcfg.ssm)[0] * w)

    gp, gx = jax.grad(ref_obj, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, rp), jnp.asarray(x))
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(gp))[0]}
    params = _mamba_params(rp)
    xt = torch.tensor(x, requires_grad=True)
    flat = leaves_with_paths(params)
    for _, leaf in flat:
        leaf.requires_grad_()
    obj = (TMB.mamba2_block(params, xt, cfg.ssm)[0]
           * torch.as_tensor(w)).sum()
    got = torch.autograd.grad(obj, [xt] + [leaf for _, leaf in flat])
    assert _leaf_err(got[0], gx) <= GRAD_TOL
    for (path, _), g in zip(flat, got[1:]):
        assert _leaf_err(g, want[path]) <= GRAD_TOL, path


def _mamba_params(rp):
    """One Mamba2 block's reference parameters as tensors."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node))
    return walk(rp)


def test_ssd_grad_is_autograd_through_the_plain_scan():
    """SSDScan's backward is the vector-Jacobian product of ssd_scan_plain:
    bit for bit what autograd gives through the plain scan alone."""
    rng = np.random.default_rng(4)
    b, s, h, p, n = 2, 48, 3, 8, 4
    la = -np.abs(rng.standard_normal((b, s, h))) * 0.3
    ins = [la, rng.standard_normal((b, s, h, p)),
           rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
           rng.standard_normal((b, h, n, p))]
    wy = torch.as_tensor(rng.standard_normal((b, s, h, p)),
                         dtype=torch.float32)
    ws = torch.as_tensor(rng.standard_normal((b, h, n, p)),
                         dtype=torch.float32)
    grads = []
    for fn in (lambda *a: TMB.SSDScan.apply(*a, 16, "auto"),
               lambda *a: ssd_scan_plain(*a, 16)):
        t = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
             for a in ins]
        y, final = fn(*t)
        grads.append(torch.autograd.grad((y * wy).sum() + (final * ws).sum(),
                                         t))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_train_with_a_cache_raises(model):
    _, cfg, rp, _ = model("qwen2-7b")
    params = params_from_reference(rp, cfg, device=CPU)
    cache = TM.init_cache(cfg, 1, 8, dtype=torch.float32, device=CPU)
    tokens = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="train"):
        TM.forward(params, {"tokens": tokens}, cfg, cache=cache, train=True)
