"""Train a ~100M-param LM for a few hundred steps, with a mid-run
simulated crash and auto-resume (the fault-tolerance demo), on the card
unless `--device cpu`:

    python -m repro_torch.examples.train_small_lm [--steps 200] [--small]
        [--crash-demo] [--device cpu]

The checkpoints go to a fresh temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

from ..launch.train import small_lm_config, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true",
                    help="~1M-param reduced config (CI / quick sanity run)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--crash-demo", action="store_true",
                    help="crash at 40%% and auto-resume")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)

    cfg = small_lm_config()
    if args.small:
        cfg = dataclasses.replace(cfg, name="small-lm-ci", n_layers=2,
                                  d_model=128, n_heads=4, kv_heads=2,
                                  d_ff=256, vocab=512, head_dim=32)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_example_ckpt_")
    try:
        kw = dict(ckpt_every=20, batch=args.batch, seq=args.seq,
                  device=args.device)
        if args.crash_demo:
            out = train(cfg, args.steps, ckpt_dir,
                        crash_at=int(args.steps * 0.4), **kw)
            print("crashed:", {k: v for k, v in out.items()
                               if k not in ("losses", "state")})
        out = train(cfg, args.steps, ckpt_dir, **kw)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"over {args.steps} steps")
    if not out["final_loss"] < out["first_loss"]:
        raise SystemExit("loss must decrease")
    return out


if __name__ == "__main__":
    main()
