"""gemma2-27b [dense]: local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, kv_heads=16,
    d_ff=36864, vocab=256000, head_dim=128,
    attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global_period=2,  # even layers local
    post_block_norm=True,
)
