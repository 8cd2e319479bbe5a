"""Aggregates the per-arch config modules + reduced SMOKE variants.

Each assigned architecture lives in its own ``configs/<id>.py`` (exact
dimensions from the assignment); this module collects them and derives the
reduced smoke configs that preserve family traits (pattern, MoE placement,
enc-dec, frontends, qk-norm, windows) at toy size.
"""

from __future__ import annotations

from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.gemma3_4b import CONFIG as GEMMA3_4B
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.phi35_moe_42b_a6_6b import CONFIG as PHI35_MOE
from repro_torch.configs.qwen3_14b import CONFIG as QWEN3_14B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM
from repro_torch.configs.yi_34b import CONFIG as YI_34B
from repro_torch.models.config import ModelConfig

# re-exported for the registry (repro_torch.configs.registry reads these)
__all__ = [
    "FALCON_MAMBA_7B", "GEMMA3_4B", "GRANITE_20B", "GRANITE_MOE_3B",
    "INTERNVL2_26B", "JAMBA_1_5_LARGE", "PHI35_MOE", "QWEN3_14B",
    "WHISPER_MEDIUM", "YI_34B", "SMOKE_OVERRIDES",
]


def _smoke(cfg: ModelConfig, **extra) -> ModelConfig:
    kw = dict(
        n_layers=max(len(cfg.pattern), 2), d_model=64,
        n_heads=4 if cfg.n_heads else 0, kv_heads=2 if cfg.kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0, vocab=512, head_dim=16,
        attn_chunk_min_seq=64, attn_chunk_kv=32, ssm_chunk=16,
        ssm_scan_dtype="float32",   # numeric tests; prod configs pick bf16
        frontend_len=8, remat=False)
    if cfg.moe_experts:
        kw.update(moe_experts=4, moe_top_k=min(2, cfg.moe_top_k))
    if cfg.enc_dec:
        kw.update(n_enc_layers=2)
    if cfg.windows and any(w for w in cfg.windows):
        kw.update(windows=tuple(16 if w else None for w in cfg.windows))
    kw.update(extra)
    return cfg.with_(**kw)


SMOKE_OVERRIDES = {
    # gemma3 smoke keeps a non-divisible tail (10 = 6 + 4) to exercise the
    # unrolled-tail path
    "gemma3-4b": dict(n_layers=10),
    # jamba smoke: two full periods
    "jamba-1.5-large-398b": dict(n_layers=16),
    "falcon-mamba-7b": dict(n_layers=4),
}
