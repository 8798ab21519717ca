"""command-r-plus-104b [dense]: GQA kv=8, no bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128,
)
