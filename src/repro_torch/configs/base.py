"""Model configuration: frozen dataclasses, data only.

The port's own copy of the reference's `configs/base.py`: ModelConfig holds
everything the architectures need as data (and the parameter counts derived
from it), ShapeConfig the input-shape cells, and smoke_config() the reduced
same-family configuration the CPU tests run. Every field is the
reference's, so a configuration reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dispatch: str = "sorted"  # "sorted" | "onehot"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block."""
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = True
    encoder_only: bool = False
    embed_inputs: bool = True
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_period: int = 0
    post_block_norm: bool = False
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid_attn_period: int = 0      # zamba2: shared attn block every k layers
    cross_attn_period: int = 0
    num_image_tokens: int = 0
    wsd_schedule: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as the reference pads it."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.rwkv is not None or (
            self.ssm is not None and self.hybrid_attn_period == 0)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (decode-time state/cache is O(1) or the
        arch is hybrid with O(S) decode attention)."""
        return self.ssm is not None or self.rwkv is not None

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), the
        reference's formula."""
        d, l = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        total = self.vocab * d  # embed (tied)
        attn = (d * hd * self.n_heads + 2 * d * hd * self.kv_heads
                + hd * self.n_heads * d)
        ffn_dense = 3 * d * self.d_ff
        for i in range(l):
            if self.ssm is not None and not self._is_hybrid_attn_layer(i):
                di = self.ssm.expand * d
                total += 2 * d * di + di * d + d * self.ssm.d_state * 2
                continue
            if self.rwkv is not None:
                # 5 square mats (r,k,v,g,o) + decay LoRA + 2-mat channel-mix
                total += (5 * d * d + 2 * d * self.rwkv.decay_lora
                          + 2 * d * self.d_ff)
                continue
            total += attn
            if self.moe is not None and (i % self.moe_every == 0):
                total += self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                total += d * self.moe.num_experts
            else:
                total += ffn_dense
        if self.hybrid_attn_period:
            total += attn + ffn_dense  # one shared block
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        moe_layers = len([i for i in range(self.n_layers)
                          if i % self.moe_every == 0])
        per_expert = 3 * d * self.moe.d_ff_expert
        return total - moe_layers * per_expert * (self.moe.num_experts
                                                  - self.moe.top_k)

    def _is_hybrid_attn_layer(self, i: int) -> bool:
        return (bool(self.hybrid_attn_period)
                and (i + 1) % self.hybrid_attn_period == 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's values)."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4 if not cfg.hybrid_attn_period else 5),
        d_model=128,
        n_heads=4,
        kv_heads=min(cfg.kv_heads, 4) if cfg.kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        num_image_tokens=16 if cfg.cross_attn_period else 0,
        sliding_window=64 if cfg.sliding_window else None,
    )
    if cfg.moe:
        changes["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                                   dispatch=cfg.moe.dispatch)
    if cfg.ssm:
        changes["ssm"] = SSMConfig(d_state=16, head_dim=32, chunk=16)
    if cfg.rwkv:
        changes["rwkv"] = RWKVConfig(head_dim=32, decay_lora=16, chunk=16)
    if cfg.hybrid_attn_period:
        changes["hybrid_attn_period"] = 3
    if cfg.cross_attn_period:
        changes["cross_attn_period"] = 2
    if cfg.local_global_period:
        changes["local_global_period"] = 2
    return dataclasses.replace(cfg, **changes)
