"""Assigned architecture: qwen3-14b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- qwen3
CONFIG = ModelConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1_000_000.0)
