"""minicpm-2b [dense]: llama-like MHA, WSD schedule [arXiv:2404.06395; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, kv_heads=36,
    d_ff=5760, vocab=122753, head_dim=64,
    wsd_schedule=True,
)
