"""Assigned architecture: internvl2-26b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- internvl2
# [vlm] InternViT frontend is a stub supplying patch embeddings; backbone is
# the InternLM2-20B-style GQA decoder.
CONFIG = ModelConfig(
    name="internvl2-26b", n_layers=48, d_model=6144, n_heads=48,
    kv_heads=8, d_ff=16384, vocab=92553, head_dim=128,
    frontend="vision", frontend_len=256)
