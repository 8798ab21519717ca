"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, per-expert d_ff=768
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128, rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)
