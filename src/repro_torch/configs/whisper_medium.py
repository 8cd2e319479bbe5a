"""Assigned architecture: whisper-medium."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- whisper
# [audio] enc-dec, conv frontend (stub).  Whisper uses learned absolute
# positions + non-gated GELU MLPs; backbone here keeps GELU and substitutes
# RoPE (the positional scheme is not the paper's subject).
CONFIG = ModelConfig(
    name="whisper-medium", n_layers=24, d_model=1024, n_heads=16,
    kv_heads=16, d_ff=4096, vocab=51865, head_dim=64,
    enc_dec=True, n_enc_layers=24, frontend="audio",
    act="gelu", gated_mlp=False)
