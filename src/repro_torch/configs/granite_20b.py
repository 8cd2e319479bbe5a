"""Assigned architecture: granite-20b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- granite-20b
# GPT-BigCode lineage: MQA (kv=1) + non-gated GELU MLP (that is what puts
# 52 layers of d_ff=24576 at ~20B total)
CONFIG = ModelConfig(
    name="granite-20b", n_layers=52, d_model=6144, n_heads=48, kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128, act="gelu", gated_mlp=False)
