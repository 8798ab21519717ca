"""llama-3.2-vision-11b [vlm]: cross-attn image layers every 5; the vision
frontend is a stub — callers pass patch embeddings as `image_embeds`
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128, rope_theta=5e5,
    cross_attn_period=5, num_image_tokens=1600,
)
