"""End-to-end training driver: the reference's loop with checkpointing,
auto-resume and fault injection, on the card unless `--device cpu`:
`python -m repro_torch.launch.train --steps 300`.

The default model is a ~100M-parameter qwen2-family LM (GQA + SwiGLU);
`--arch` takes a registered arch at its smoke size instead. Compute is in
f32, as in the reference's driver.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import registry
from ..configs.base import ModelConfig, smoke_config
from ..device import resolve_device
from ..training import checkpoint as CKPT
from ..training import data as DATA
from ..training import optimizer as OPT
from ..training import train_loop as TL


def small_lm_config(vocab: int = 2048) -> ModelConfig:
    """~100M params, qwen2-like (GQA + SwiGLU)."""
    return ModelConfig(
        name="small-lm-100m", family="dense", n_layers=8, d_model=768,
        n_heads=12, kv_heads=4, d_ff=2048, vocab=vocab, head_dim=64)


def train(cfg: ModelConfig, steps: int, ckpt_dir: str, batch: int = 8,
          seq: int = 256, ckpt_every: int = 50, crash_at: int | None = None,
          lr: float = 3e-4, log_every: int = 10,
          wsd: bool | None = None, device=None) -> dict:
    """Train `cfg` to `steps` steps from the latest checkpoint in
    `ckpt_dir` (or from init, seed 0), saving every `ckpt_every` steps and
    at the end; with `crash_at`, stop once step `crash_at` is done and its
    checkpoint written. Returns the losses of the steps run, and "state",
    the last state (on `device`, None: the card)."""
    dev = resolve_device(device)
    opt_cfg = OPT.OptConfig(
        peak_lr=lr, warmup_steps=min(50, steps // 4), total_steps=steps,
        schedule="wsd" if (wsd if wsd is not None else cfg.wsd_schedule)
        else "cosine")
    step_fn, _, _ = TL.make_train_step(cfg, opt_cfg, microbatches=1,
                                       compute_dtype=torch.float32,
                                       device=dev)
    data = DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    ckpt = CKPT.Checkpointer(ckpt_dir, keep=2)
    cfg_hash = CKPT.config_hash((cfg, dataclasses.asdict(opt_cfg)))

    state = TL.init_state(cfg, seed=0, device=dev)
    start_step = 0
    restored = ckpt.restore_latest(state, cfg_hash)
    if restored is not None:
        start_step, state, extra = restored
        print(f"[train] resumed from step {start_step}", flush=True)

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        state, metrics = step_fn(state, data.batch_for_model(step, cfg))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            ckpt.save(step + 1, state, extra={"losses_tail": losses[-5:]},
                      cfg_hash=cfg_hash)
        if crash_at is not None and step + 1 >= crash_at:
            ckpt.wait()
            print(f"[train] simulated crash at step {step + 1}", flush=True)
            return {"crashed_at": step + 1, "losses": losses, "state": state}
    ckpt.wait()
    return {"final_loss": losses[-1], "first_loss": losses[0],
            "losses": losses, "steps": steps, "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="small-lm-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.arch == "small-lm-100m":
        cfg = small_lm_config()
    else:
        try:
            cfg = smoke_config(registry.get(args.arch))
        except KeyError as e:
            raise SystemExit(str(e.args[0]))
    out = train(cfg, args.steps, args.ckpt_dir, batch=args.batch,
                seq=args.seq, crash_at=args.crash_at, device=args.device)
    print({k: v for k, v in out.items() if k not in ("losses", "state")})
    return out


if __name__ == "__main__":
    main()
