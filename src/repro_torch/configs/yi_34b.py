"""Assigned architecture: yi-34b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- yi
CONFIG = ModelConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128, rope_theta=5_000_000.0)
