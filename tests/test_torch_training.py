"""The port's training stack against the JAX package on the CPU: the
synthetic batches, the schedules, AdamW, the train step, checkpoints (and
their on-disk layout across both packages), the config hash, the training
driver with a crash and a resume, its CLI and the training example.

Models are at smoke_config sizes with the reference's parameters
(params_from_reference / state_from_reference). Tolerances:
  * batches bit for bit; WSD's rate bit for bit, cosine's within 1 ulp of
    f32 (the two packages' f32 cosines can differ by one);
  * adamw_update over 3 steps: each leaf within 1e-6 of its largest entry;
  * the f32 train step (microbatches 1 and 2) against the reference's:
    loss and grad_norm within 1e-5 relative, lr equal; mu and nu (the
    clipped gradient and its square, scaled) within 1e-4 of each leaf's
    largest entry, the gradients' own tolerance; each new parameter within
    1e-4 of its leaf's largest entry plus lr * |d g| / eps, what the first
    Adam step makes of the clipped gradients' difference d g = d mu / (1 -
    b1) (its update g / (|g| + eps) moves by up to |d g| / eps: a gradient
    entry near eps, such as the K bias's, turns rounding into a visible
    step);
  * a bf16-compute step against the reference's bf16 step: the loss
    within 1e-2 relative, the parameters as above with 1e-2; each mu and
    nu leaf within 1e-2 of its largest entry, or within twice the
    reference's own bf16 error on that leaf (its bf16 step against its
    f32 step) where that is larger. Two bf16 steps that round at
    different points lie as far apart as either lies from the f32 step:
    at this size the port's reads 0.60-1.51 times the reference's own
    error, leaf by leaf (6.5e-3 to 5.1e-2 of the leaf's largest entry);
  * checkpoints across packages and a resumed run: bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as ref_registry
from repro.configs.base import smoke_config as ref_smoke_config
from repro.launch import train as ref_launch_train
from repro.training import checkpoint as RCK
from repro.training import data as RD
from repro.training import optimizer as RO
from repro.training import train_loop as RTL
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, smoke_config
from repro_torch.convert import state_from_reference
from repro_torch.launch import train as TT
from repro_torch.training import checkpoint as CK
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves, leaves_with_paths

torch.set_num_threads(1)

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAM_TOL = 1e-6
STEP_TOL = 1e-4
SCALAR_TOL = 1e-5
BF16_TOL = 1e-2
BF16_REF_FACTOR = 2.0            # x the reference's own bf16 moment error
SEQ, BATCH = 16, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _leaf_err(got, want) -> float:
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def dense():
    """(reference cfg, port cfg, reference train state as numpy, batch)."""
    rcfg = ref_smoke_config(ref_registry.get("qwen2-7b"))
    state = _np_tree(RTL.init_state(rcfg, jax.random.PRNGKey(0)))
    batch = RD.SyntheticLM(RD.DataConfig(
        vocab=rcfg.vocab, seq_len=SEQ, global_batch=BATCH)).batch_for_model(
        0, rcfg)
    return rcfg, smoke_config(registry.get("qwen2-7b")), state, batch


# -- data ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ("qwen2-7b", "hubert-xlarge",
                                  "llama-3.2-vision-11b"))
def test_synthetic_batches_match_reference(arch):
    rcfg = ref_smoke_config(ref_registry.get(arch))
    cfg = smoke_config(registry.get(arch))
    kw = dict(vocab=rcfg.vocab, seq_len=24, global_batch=3, seed=5)
    ref = RD.SyntheticLM(RD.DataConfig(**kw))
    port = TD.SyntheticLM(TD.DataConfig(**kw))
    for step in (0, 7):
        assert np.array_equal(port.batch(step)["tokens"],
                              ref.batch(step)["tokens"])
        want, got = ref.batch_for_model(step, rcfg), port.batch_for_model(
            step, cfg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


# -- optimizer ----------------------------------------------------------------
@pytest.mark.parametrize("schedule", ("cosine", "wsd"))
def test_lr_at_matches_reference(schedule):
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
              schedule=schedule, wsd_decay_frac=0.2, min_lr_frac=0.1)
    want = np.array([np.float32(RO.lr_at(RO.OptConfig(**kw), s))
                     for s in range(101)])
    got = [TO.lr_at(TO.OptConfig(**kw), s) for s in range(101)]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    got = np.array([np.float32(g) for g in got])
    ulps = np.abs(got - want) / np.spacing(want)
    assert ulps.max() <= (0 if schedule == "wsd" else 1)
    assert got[5] < got[10] and got[30] > got[95]


def _opt_tree(rng):
    """A tree with a matrix, a stacked norm scale [L, d] and a vector."""
    return {"layers": {"w": rng.standard_normal((3, 4, 5)),
                       "norm": {"scale": 1 + rng.standard_normal((2, 6))}},
            "bias": rng.standard_normal(7)}


def test_adamw_matches_reference_over_three_steps():
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                    _opt_tree(rng))
    kw = dict(warmup_steps=1, total_steps=5)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = RO.init_opt_state(rp)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    ts = TO.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
            params)
        rp, rs, rm = RO.adamw_update(RO.OptConfig(**kw), rp,
                                     jax.tree_util.tree_map(jnp.asarray, g),
                                     rs)
        tp, ts, tm = TO.adamw_update(TO.OptConfig(**kw), tp,
                                     jax.tree_util.tree_map(torch.tensor, g),
                                     ts)
        for k in ("lr", "grad_norm"):
            assert abs(float(tm[k]) - float(rm[k])) <= ADAM_TOL * float(rm[k])
        want = _ref_leaves({"p": rp, "mu": rs["mu"], "nu": rs["nu"]})
        got = dict(leaves_with_paths({"p": tp, "mu": ts["mu"],
                                      "nu": ts["nu"]}))
        for path, w in want.items():
            assert _leaf_err(got[path], w) <= ADAM_TOL, path
    assert int(ts["step"]) == int(rs["step"]) == 3


def test_grad_clip_engaged():
    """A huge gradient is clipped to norm 1 before the moments take it (mu
    = (1 - b1) * g / |g|), and the raw norm is reported."""
    cfg = TO.OptConfig(grad_clip=1.0, warmup_steps=0, total_steps=10)
    p = {"w": torch.zeros(3)}
    _, state, m = TO.adamw_update(cfg, p, {"w": torch.full((3,), 1e6)},
                                  TO.init_opt_state(p))
    assert abs(float(m["grad_norm"]) - 1e6 * 3 ** 0.5) <= 1
    want = (1 - cfg.b1) / 3 ** 0.5
    assert torch.allclose(state["mu"]["w"], torch.full((3,), want),
                          rtol=1e-6)


def test_weight_decay_goes_by_rank_stacked_norm_scale_decays():
    """With a zero gradient only weight decay moves a leaf: the reference's
    ndim >= 2 rule decays a stacked norm scale [L, d] and leaves a vector
    alone."""
    cfg = TO.OptConfig(warmup_steps=0, total_steps=10, weight_decay=0.1)
    p = {"norm": {"scale": torch.ones(2, 6)}, "bias": torch.ones(6)}
    grads = {"norm": {"scale": torch.zeros(2, 6)}, "bias": torch.zeros(6)}
    _, _, m = TO.adamw_update(cfg, p, grads, TO.init_opt_state(p))
    assert torch.equal(p["bias"], torch.ones(6))
    assert torch.allclose(p["norm"]["scale"],
                          (1 - m["lr"] * 0.1) * torch.ones(2, 6))
    assert float(p["norm"]["scale"].max()) < 1


# -- the train step -----------------------------------------------------------
def _ref_step(rcfg, opt_kw, microbatches, state, batch):
    """The reference's f32 step: mesh=None, or at microbatches > 1 a
    one-device mesh (its microbatch path needs one)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = jax.tree_util.tree_map(jnp.asarray, state)
    if microbatches == 1:
        step, _, _ = RTL.make_train_step(rcfg, RO.OptConfig(**opt_kw),
                                         mesh=None, dp_axes=(),
                                         compute_dtype=jnp.float32)
        return step(js, jb)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    step, _, _ = RTL.make_train_step(rcfg, RO.OptConfig(**opt_kw), mesh,
                                     ("data",), microbatches=microbatches,
                                     compute_dtype=jnp.float32)
    with mesh:
        return step(js, jb)


OPT_KW = dict(warmup_steps=1, total_steps=4)


def _check_step(got: dict, want: dict, lr: float, tol: float,
                moment_tol: dict | None = None) -> None:
    """got, want: {keystr path: new state leaf} after one step from one
    state. mu and nu within `tol` of each leaf's largest entry, or within
    `moment_tol[path]` where given; each parameter within `tol` of its
    leaf's largest entry plus lr times what Adam's first update u(g) = g /
    (|g| + eps) makes of the clipped gradients' difference, d g = |d mu| /
    (1 - b1) around the wanted g = mu / (1 - b1): max |u(g +- d g) -
    u(g)|. A gradient entry
    near eps (the K bias's) or under its own rounding turns that rounding
    into a step of up to 2 lr."""
    cfg = TO.OptConfig()
    moment_tol = moment_tol or {}
    assert sorted(got) == sorted(want)

    def u(x):
        return x / (np.abs(x) + cfg.eps)

    bad = {}
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        if path.startswith("['params']"):
            mu = path.replace("['params']", "['opt']['mu']", 1)
            ghat = np.asarray(want[mu], np.float64) / (1 - cfg.b1)
            dg = np.abs(np.asarray(got[mu], np.float64) - want[mu]) / (
                1 - cfg.b1)
            du = np.maximum(np.abs(u(ghat + dg) - u(ghat)),
                            np.abs(u(ghat - dg) - u(ghat)))
            if not (np.abs(g - w) <= tol * np.abs(w).max() + lr * du).all():
                bad[path] = _leaf_err(g, w)
        elif path == "['opt']['step']":
            assert np.array_equal(g, w)
        elif not _leaf_err(g, w) <= moment_tol.get(path, tol):
            bad[path] = _leaf_err(g, w)
    assert not bad, bad


@pytest.mark.parametrize("microbatches", (1, 2))
def test_train_step_matches_reference(dense, microbatches):
    rcfg, cfg, state, batch = dense
    rs, rm = _ref_step(rcfg, OPT_KW, microbatches, state, batch)
    step, none1, none2 = TL.make_train_step(
        cfg, TO.OptConfig(**OPT_KW), microbatches=microbatches,
        compute_dtype=torch.float32, device=CPU)
    assert none1 is None and none2 is None
    ts, tm = step(state_from_reference(state, cfg, device=CPU), batch)
    assert {"loss", "lr", "grad_norm", "ce_loss"} <= set(tm)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(rm[k])) <= SCALAR_TOL * float(rm[k])
    assert float(tm["lr"]) == float(rm["lr"])
    assert int(ts["opt"]["step"]) == 1
    _check_step({p: v.numpy() for p, v in leaves_with_paths(ts)},
                _ref_leaves(rs), float(rm["lr"]), STEP_TOL)


def _port_step(cfg, state, batch, **kw):
    step, _, _ = TL.make_train_step(cfg, TO.OptConfig(**OPT_KW), device=CPU,
                                    **kw)
    return step(state_from_reference(state, cfg, device=CPU), batch)


def test_grad_compression_bf16(dense):
    """bf16-compressed gradients: the step's norm is the norm of the
    gradients rounded to bf16, and the state lands near the f32 step's (as
    a bf16 step does) but not on it."""
    _, cfg, state, batch = dense
    plain, pm = _port_step(cfg, state, batch, compute_dtype=torch.float32)
    comp, cm = _port_step(cfg, state, batch, compute_dtype=torch.float32,
                          grad_compression="bf16")
    _, _, grads = TL.loss_and_grads(
        state_from_reference(state, cfg, device=CPU)["params"],
        TL.batch_to_device(batch, CPU), cfg)
    rounded = TO.global_norm(TL.cast_tree(grads, torch.bfloat16))
    assert float(cm["grad_norm"]) == float(rounded)
    assert float(cm["grad_norm"]) != float(pm["grad_norm"])
    _check_step({p: v.numpy() for p, v in leaves_with_paths(comp)},
                {p: v.numpy() for p, v in leaves_with_paths(plain)},
                float(pm["lr"]), BF16_TOL)
    with pytest.raises(ValueError, match="grad_compression"):
        TL.make_train_step(cfg, TO.OptConfig(), grad_compression="int8")


def test_bf16_compute_step_matches_reference(dense):
    rcfg, cfg, state, batch = dense
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step, _, _ = RTL.make_train_step(rcfg, RO.OptConfig(**OPT_KW), mesh=None,
                                     dp_axes=(), compute_dtype=jnp.bfloat16)
    rs, rm = step(jax.tree_util.tree_map(jnp.asarray, state), jb)
    ts, tm = _port_step(cfg, state, batch, compute_dtype=torch.bfloat16)
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= BF16_TOL * float(
        rm["loss"])
    assert ts["params"]["embed"]["table"].dtype == torch.float32
    want, want32 = _ref_leaves(rs), _ref_leaves(
        _ref_step(rcfg, OPT_KW, 1, state, batch)[0])
    own = {p: BF16_REF_FACTOR * _leaf_err(w, want32[p])
           for p, w in want.items() if p.startswith("['opt']['mu']")
           or p.startswith("['opt']['nu']")}
    _check_step({p: v.numpy() for p, v in leaves_with_paths(ts)}, want,
                float(rm["lr"]), BF16_TOL,
                {p: max(BF16_TOL, e) for p, e in own.items()})


def test_a_mesh_raises(dense):
    """A mesh that is not a DeviceMesh raises (the mesh step itself is in
    test_torch_mesh_train.py)."""
    _, cfg, _, _ = dense
    with pytest.raises(TypeError, match="not a mesh"):
        TL.make_train_step(cfg, TO.OptConfig(), mesh=object(), device=CPU)


# -- checkpoints (the reference's five cases) ---------------------------------
class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        ck = CK.Checkpointer(str(tmp_path), async_save=False)
        tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3)),
                                              "h": torch.randn(4).bfloat16()}}
        ck.save(7, tree, extra={"foo": 1}, cfg_hash="h")
        got, extra = ck.restore(7, tree, cfg_hash="h")
        for a, b in zip(leaves(got), leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert extra == {"foo": 1}

    def test_latest_and_gc(self, tmp_path):
        ck = CK.Checkpointer(str(tmp_path), keep=2, async_save=False)
        tree = {"a": torch.zeros(2)}
        for s in (1, 2, 3, 4):
            ck.save(s, tree)
        assert ck.latest_step() == 4
        steps = sorted(n for n in os.listdir(tmp_path)
                       if n.startswith("step"))
        assert steps == ["step_00000003", "step_00000004"]

    def test_config_hash_mismatch_refuses(self, tmp_path):
        ck = CK.Checkpointer(str(tmp_path), async_save=False)
        tree = {"a": torch.zeros(2)}
        ck.save(1, tree, cfg_hash="AAA")
        with pytest.raises(ValueError, match="hash"):
            ck.restore(1, tree, cfg_hash="BBB")

    def test_partial_tmp_ignored(self, tmp_path):
        ck = CK.Checkpointer(str(tmp_path), async_save=False)
        ck.save(1, {"a": torch.zeros(2)})
        os.makedirs(tmp_path / "step_00000002.tmp")  # crashed mid-write
        ck2 = CK.Checkpointer(str(tmp_path), async_save=False)
        assert ck2.latest_step() == 1
        assert not (tmp_path / "step_00000002.tmp").exists()

    def test_async_save(self, tmp_path):
        """The write runs on a thread, from a host copy taken at save():
        updating the tensor in place at once does not reach the file."""
        ck = CK.Checkpointer(str(tmp_path), async_save=True)
        t = torch.arange(4.0)
        ck.save(3, {"a": t})
        t.add_(100)
        ck.wait()
        got, _ = ck.restore(3, {"a": torch.zeros(4)})
        assert torch.equal(got["a"], torch.arange(4.0))


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_checkpoint_restores_across_packages(dense, tmp_path, writer):
    """A train state written by either package's Checkpointer restores bit
    for bit in the other's, with the reference's leaf index."""
    rcfg, cfg, state, _ = dense
    port_state = state_from_reference(state, cfg, device=CPU)
    want = _ref_leaves(state)
    if writer == "port":
        CK.Checkpointer(str(tmp_path), async_save=False).save(
            5, port_state, cfg_hash="h")
        got, _ = RCK.Checkpointer(str(tmp_path)).restore(
            5, jax.tree_util.tree_map(jnp.asarray, state), cfg_hash="h")
        got = _ref_leaves(got)
    else:
        RCK.Checkpointer(str(tmp_path), async_save=False).save(
            5, jax.tree_util.tree_map(jnp.asarray, state), cfg_hash="h")
        like = jax.tree_util.tree_map(torch.zeros_like, port_state)
        tree, _ = CK.Checkpointer(str(tmp_path)).restore(5, like,
                                                         cfg_hash="h")
        got = {p: v.numpy() for p, v in leaves_with_paths(tree)}
        assert tree["opt"]["step"].dtype == torch.int32
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        assert json.load(f)["index"] == list(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and np.array_equal(got[path], w)


def test_config_hash_matches_reference():
    for arch in ("minicpm-2b", "qwen3-moe-30b-a3b", "zamba2-7b"):
        cfg, rcfg = registry.get(arch), ref_registry.get(arch)
        assert repr(cfg) == repr(rcfg)
        opt = dataclasses.asdict(TO.OptConfig(schedule="wsd"))
        assert opt == dataclasses.asdict(RO.OptConfig(schedule="wsd"))
        assert CK.config_hash((cfg, opt)) == RCK.config_hash((rcfg, opt))
    assert CK.config_hash((TT.small_lm_config(), opt)) == RCK.config_hash(
        (ref_launch_train.small_lm_config(), opt))


# -- the driver ---------------------------------------------------------------
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            kv_heads=2, d_ff=128, vocab=256, head_dim=16)


def test_train_crash_resume_matches_uninterrupted(tmp_path):
    """The reference test's model and bar: crash at 30, resume to 60; the
    losses bit for bit those of an uninterrupted run, and the final loss
    below the first by more than 0.3. The last checkpoint restores the
    final state bit for bit."""
    cfg = ModelConfig(**TINY)
    kw = dict(batch=4, seq=64, ckpt_every=10, log_every=100, device=CPU)
    out1 = TT.train(cfg, 60, str(tmp_path / "a"), crash_at=30, **kw)
    assert out1["crashed_at"] == 30 and len(out1["losses"]) == 30
    out2 = TT.train(cfg, 60, str(tmp_path / "a"), **kw)
    assert out2["steps"] == 60 and len(out2["losses"]) == 30
    whole = TT.train(cfg, 60, str(tmp_path / "b"), **kw)
    assert out1["losses"] + out2["losses"] == whole["losses"]
    assert out2["final_loss"] < out1["losses"][0] - 0.3
    step, saved, _ = CK.Checkpointer(str(tmp_path / "a")).restore_latest(
        out2["state"])
    assert step == 60
    for a, b in zip(leaves(saved), leaves(whole["state"])):
        assert torch.equal(a, b)


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    return proc.stdout


def test_train_cli_on_the_cpu(tmp_path):
    out = _run(["repro_torch.launch.train", "--arch", "qwen2-7b", "--steps",
                "6", "--batch", "2", "--seq", "32", "--ckpt-dir",
                str(tmp_path), "--device", "cpu"])
    assert "'steps': 6" in out and "[train] step 0 loss" in out
    assert os.path.isdir(tmp_path / "step_00000006")


def test_train_example_small_crash_demo_on_the_cpu():
    out = _run(["repro_torch.examples.train_small_lm", "--small",
                "--crash-demo", "--steps", "40", "--device", "cpu"])
    assert "crashed: {'crashed_at': 16}" in out
    first, final = out.split("loss: ")[1].split(" over")[0].split(" -> ")
    assert float(final) < float(first)


def test_state_from_reference_refuses_a_wrong_stack(dense):
    _, cfg, state, _ = dense
    short = jax.tree_util.tree_map(lambda a: a, state)
    short["opt"]["mu"]["layers"] = jax.tree_util.tree_map(
        lambda a: a[:2], state["opt"]["mu"]["layers"])
    with pytest.raises(ValueError, match="layers"):
        state_from_reference(short, cfg, device=CPU)
    bad_step = jax.tree_util.tree_map(lambda a: a, state)
    bad_step["opt"]["step"] = np.zeros((), np.int64)
    with pytest.raises(ValueError, match="step"):
        state_from_reference(bad_step, cfg, device=CPU)
    port = state_from_reference(state, cfg, device=CPU)
    assert len(leaves(port)) == len(jax.tree_util.tree_leaves(state))
