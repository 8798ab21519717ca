"""hubert-xlarge [audio]: encoder-only; the frontend is a stub — callers
pass precomputed frame embeddings as `embeds` [arXiv:2106.07447;
unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, kv_heads=16,
    d_ff=5120, vocab=504, head_dim=80,
    encoder_only=True, embed_inputs=False, tie_embeddings=False,
)
