"""Model configuration for the assigned architecture zoo.

One ``ModelConfig`` describes any member of the zoo: dense / GQA / MQA
transformers, sliding-window:global interleaves (gemma3), MoE FFNs
(phi3.5 / granite / jamba), Mamba-1 SSM stacks (falcon-mamba), hybrid
attn+mamba (jamba), encoder-decoder with stub frontend (whisper), and
VLM backbones with stub vision frontends (internvl2).

Layers are organized in repeating *periods* (``pattern``): the parameter
tree stacks one subtree per period position over ``n_layers // period``
repeats, and the forward pass loops over the periods (the JAX package's
``lax.scan``).  A non-divisible tail (``gemma3``: 34 = 5*6 + 4) runs
separately.  The dataclass is the JAX package's, field for field, so a
config compares equal across the two packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None     # default: d_model // n_heads

    # layer pattern, one entry per period position
    pattern: tuple[str, ...] = ("attn",)         # "attn" | "mamba"
    windows: tuple[int | None, ...] = (None,)    # sliding window per pos

    # MoE (applies to positions where moe_positions[pos] is True)
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_positions: tuple[bool, ...] = ()
    moe_d_ff: int | None = None
    capacity_factor: float = 1.25

    # SSM (mamba-1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # structure flags
    qk_norm: bool = False
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str | None = None      # "audio" | "vision" | None
    frontend_len: int = 256          # vision prefix length (vlm)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    logit_softcap: float | None = None

    # numerics / execution
    dtype: str = "bfloat16"          # compute dtype
    remat: bool = True
    attn_chunk_q: int = 2048         # flash-style chunking thresholds
    attn_chunk_kv: int = 2048
    attn_chunk_min_seq: int = 8192   # chunk only above this seq len
    ssm_chunk: int = 128
    ssm_scan_dtype: str = "float32"   # state-scan element type; bf16 halves
                                      # the dominant [B,c,di,ds] traffic
    seq_parallel: bool = True         # SP: residual stream sharded over the
                                      # model axis on the seq dim (Megatron
                                      # SP); activations shrink 1/tp and TP
                                      # all-reduces become rs/ag pairs
                                      # (measured 5.2x peak on granite-20b;
                                      # auto-dropped when seq % tp != 0,
                                      # e.g. decode steps)

    def __post_init__(self):
        assert len(self.pattern) == len(self.windows)
        if self.moe_experts:
            assert len(self.moe_positions) == len(self.pattern)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_periods * self.period

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return -(-self.d_model // 16)

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6*N*D bookkeeping)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Active-per-token parameters (MoE: top_k of experts)."""
        return _count_params(self, active_only=True)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _ffn_params(cfg: ModelConfig, pos: int, active_only: bool) -> int:
    d = cfg.d_model
    is_moe = bool(cfg.moe_experts and cfg.moe_positions and
                  cfg.moe_positions[pos % cfg.period])
    if is_moe:
        ff = cfg.moe_d_ff or cfg.d_ff
        n_mats = 3 if cfg.gated_mlp else 2
        per_expert = n_mats * d * ff
        router = d * cfg.moe_experts
        n_experts = cfg.moe_top_k if active_only else cfg.moe_experts
        return per_expert * n_experts + router
    n_mats = 3 if cfg.gated_mlp else 2
    return n_mats * d * cfg.d_ff


def _layer_params(cfg: ModelConfig, pos: int, active_only: bool) -> int:
    d = cfg.d_model
    kind = cfg.pattern[pos % cfg.period]
    if kind == "mamba":
        di, ds, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        p = d * 2 * di                    # in_proj
        p += cfg.ssm_conv * di            # conv1d (depthwise)
        p += di * (dr + 2 * ds)           # x_proj
        p += dr * di + di                 # dt_proj
        p += di * ds + di                 # A_log, D
        p += di * d                       # out_proj
        p += d                            # norm
        # hybrid archs (jamba) attach an FFN/MoE to mamba layers too
        p += _ffn_params(cfg, pos, active_only)
        if _ffn_params(cfg, pos, active_only):
            p += d                        # norm2
        return p
    hd = cfg.resolved_head_dim
    p = d * cfg.n_heads * hd              # q
    p += 2 * d * cfg.kv_heads * hd        # k, v
    p += cfg.n_heads * hd * d             # o
    p += 2 * d                            # norms
    if cfg.qk_norm:
        p += 2 * hd
    p += _ffn_params(cfg, pos, active_only)
    return p


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab * cfg.d_model       # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab * cfg.d_model  # lm head
    for layer in range(cfg.n_layers):
        total += _layer_params(cfg, layer, active_only)
    if cfg.enc_dec:
        for layer in range(cfg.n_enc_layers):
            total += _layer_params(cfg, layer, active_only)
            # cross attention approximately mirrors self attention
            hd = cfg.resolved_head_dim
            total += 2 * cfg.d_model * cfg.kv_heads * hd \
                + 2 * cfg.d_model * cfg.n_heads * hd
    total += cfg.d_model                  # final norm
    return total
