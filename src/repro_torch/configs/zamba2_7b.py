"""zamba2-7b [hybrid]: 81 Mamba2 layers + shared attention block every 6
[arXiv:2411.15242; unverified]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
    hybrid_attn_period=6,
)
