"""Assigned architecture: jamba-1.5-large-398b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- jamba
# [hybrid] 1:7 attn:mamba per 8-layer period (attn at position 4, as in the
# Jamba paper), MoE (16e top-2) on alternate layers.
CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
    kv_heads=8, d_ff=24576, vocab=65536, head_dim=128,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
             "mamba"),
    windows=(None,) * 8,
    moe_experts=16, moe_top_k=2,
    moe_positions=(False, True, False, True, False, True, False, True),
    ssm_state=16,
    ssm_chunk=2048, ssm_scan_dtype="bfloat16")
