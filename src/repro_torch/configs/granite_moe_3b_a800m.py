"""Assigned architecture: granite-moe-3b-a800m."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- granite-moe
CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    moe_experts=40, moe_top_k=8, moe_positions=(True,))
