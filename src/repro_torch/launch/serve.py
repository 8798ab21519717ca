"""Serving entry point: batched greedy decoding with a KV/state cache —
`python -m repro_torch.launch.serve --arch qwen2-7b --tokens 32`.

Runs the smoke-size config of the chosen arch, on the card unless
`--device cpu` is given; the vlm's image embeddings are drawn from the
prompts' generator, as the reference draws them. An unknown arch exits
with the registry's message; an encoder-only arch (hubert) has no decode
path: its forward entry is `serving.decode.prefill`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..configs.base import smoke_config
from ..device import resolve_device
from ..models import model as MDL
from ..serving.decode import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    try:
        cfg = smoke_config(registry.get(args.arch))
    except KeyError as e:
        raise SystemExit(str(e.args[0]))
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    dev = resolve_device(args.device)
    params = MDL.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (args.batch, args.prompt_len)))
    img = None
    if cfg.cross_attn_period:
        img = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.num_image_tokens, cfg.d_model)),
            dtype=torch.float32)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.tokens,
                   cache_len=args.prompt_len + args.tokens + 1, device=dev,
                   image_embeds=img)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {args.arch} on {where}: generated {total} tokens in "
          f"{dt:.1f}s ({total / dt:.1f} tok/s, batch {args.batch})")
    print("[serve] sample:", out[0].cpu()[:16].tolist())


if __name__ == "__main__":
    main()
