"""Architecture & shape registry: ``--arch`` / ``--shape`` resolution."""

from __future__ import annotations

from repro_torch.configs import archs
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: F401
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        archs.WHISPER_MEDIUM, archs.JAMBA_1_5_LARGE, archs.PHI35_MOE,
        archs.GRANITE_MOE_3B, archs.INTERNVL2_26B, archs.FALCON_MAMBA_7B,
        archs.GEMMA3_4B, archs.QWEN3_14B, archs.YI_34B, archs.GRANITE_20B)
}

# archs with sub-quadratic long-context paths (SSM / hybrid / local:global)
LONG_CONTEXT_OK = {"falcon-mamba-7b", "jamba-1.5-large-398b", "gemma3-4b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    return archs._smoke(cfg, **archs.SMOKE_OVERRIDES.get(name, {}))


def shape_supported(arch: str, shape: str) -> bool:
    return skip_reason(arch, shape) is None


def skip_reason(arch: str, shape: str) -> str | None:
    cfg = get_config(arch)
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return ("pure full-attention arch: 500k-token decode has no "
                "sub-quadratic path (DESIGN.md §4)")
    if shape in ("decode_32k", "long_500k") and cfg.enc_dec is False \
            and cfg.n_heads == 0 and cfg.pattern == ("attn",):
        return "encoder-only arch has no decode step"
    return None
