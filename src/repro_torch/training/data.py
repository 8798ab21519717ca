"""Deterministic synthetic token pipeline: a copy of the reference's
`repro/training/data.py`, numpy only, whose batches are the reference's
bit for bit.

Produces reproducible batches from a (seed, step) pair: the pipeline state
is just the step counter, so a checkpoint stores one integer and a restart
resumes mid-epoch exactly.

The token stream is a mixture of Zipf-distributed unigrams and short
repeated motifs, so the CE loss has learnable structure (pure uniform
tokens would pin the loss at ln(V))."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


class SyntheticLM:
    """Stateless batch generator: batch(step) is pure in (config, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.probs = probs / probs.sum()
        # fixed motif table: 64 motifs of motif_len tokens
        self.motifs = rng.integers(0, cfg.vocab,
                                   size=(64, cfg.motif_len)).astype(np.int32)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = rng.choice(cfg.vocab, p=self.probs,
                          size=(cfg.global_batch, cfg.seq_len)).astype(np.int32)
        # paste motifs at random positions (learnable bigram structure)
        n_paste = int(cfg.motif_prob * cfg.global_batch * cfg.seq_len
                      / cfg.motif_len / 4)
        rows = rng.integers(0, cfg.global_batch, n_paste)
        cols = rng.integers(0, max(cfg.seq_len - cfg.motif_len, 1), n_paste)
        ids = rng.integers(0, 64, n_paste)
        for r, c, i in zip(rows, cols, ids):
            toks[r, c:c + cfg.motif_len] = self.motifs[i]
        return {"tokens": toks}

    def batch_for_model(self, step: int, model_cfg) -> dict:
        """Adds the fields the arch needs: hubert's frame embeddings and
        labels (in place of the tokens), the vlm's image embeddings."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 1))
        out = self.batch(step)
        if not model_cfg.embed_inputs:  # hubert: frame embeddings + labels
            out = {
                "embeds": rng.standard_normal(
                    (cfg.global_batch, cfg.seq_len, model_cfg.d_model)
                ).astype(np.float32),
                "labels": out["tokens"] % model_cfg.vocab,
            }
        if model_cfg.cross_attn_period:
            out["image_embeds"] = rng.standard_normal(
                (cfg.global_batch, model_cfg.num_image_tokens,
                 model_cfg.d_model)).astype(np.float32)
        return out
