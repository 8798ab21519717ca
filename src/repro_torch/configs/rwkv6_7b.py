"""rwkv6-7b (Finch) [ssm]: attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, kv_heads=64,
    d_ff=14336, vocab=65536, head_dim=64,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk=32),
)
