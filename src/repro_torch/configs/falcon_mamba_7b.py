"""Assigned architecture: falcon-mamba-7b."""

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------- falcon-mamba
CONFIG = ModelConfig(
    name="falcon-mamba-7b", n_layers=64, d_model=4096, n_heads=0,
    kv_heads=0, d_ff=0, vocab=65024,
    pattern=("mamba",), windows=(None,), ssm_state=16,
    ssm_chunk=4096, ssm_scan_dtype="bfloat16")
