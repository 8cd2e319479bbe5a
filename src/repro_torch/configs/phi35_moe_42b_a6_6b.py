"""Assigned architecture: phi3.5-moe-42b-a6.6b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- phi3.5-moe
CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    kv_heads=8, d_ff=6400, vocab=32064, head_dim=128,
    moe_experts=16, moe_top_k=2, moe_positions=(True,))
