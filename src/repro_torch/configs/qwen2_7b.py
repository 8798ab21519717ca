"""qwen2-7b [dense]: GQA kv=4, QKV bias [arXiv:2407.10671; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6,
)
