"""Assigned architecture: gemma3-4b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- gemma3
# 5 local (window 1024) : 1 global per 6-layer period; 34 = 5*6 + 4 tail.
CONFIG = ModelConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256, qk_norm=True,
    pattern=("attn",) * 6,
    windows=(1024, 1024, 1024, 1024, 1024, None),
    tie_embeddings=True, rope_theta=1_000_000.0)
