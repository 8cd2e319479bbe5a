"""Mamba-1 selective SSM layer (falcon-mamba), the JAX package's
``repro.models.mamba``.

Prefill path (``mamba_forward``): the projections and the causal conv in
the compute dtype, then one ``ops.selective_scan`` over the whole sequence
-- the hand-written CUDA kernel on the card, its plain version on the CPU
-- where JAX runs a chunked ``associative_scan``.  The kernel scans in fp32
whatever ``cfg.ssm_scan_dtype`` says (as the TPU kernel does), so at
``ssm_scan_dtype="bfloat16"`` the port is more exact than JAX's bf16 scan,
not identical to it; ``cfg.ssm_chunk`` (JAX's memory knob) is not needed,
since the kernel keeps the state on chip.

Decode path (``mamba_step``): one token, plain PyTorch (JAX has no kernel
for it either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.annotate import constrain
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

#: Leaves that every use casts to the compute dtype (the rest are used in
#: fp32), so a copy cast once gives the same results.
COMPUTE_DTYPE_LEAVES = ("in_proj", "conv_w", "x_proj", "dt_w", "out_proj")


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, ds, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dev = gen.device
    f32 = torch.float32
    A = torch.arange(1, ds + 1, dtype=f32, device=dev).repeat(di, 1)
    return {
        "in_proj": layers.dense_init(gen, d, 2 * di),
        "conv_w": torch.randn((cfg.ssm_conv, di), generator=gen, dtype=f32,
                              device=dev) * 0.1,
        "x_proj": layers.dense_init(gen, di, dr + 2 * ds),
        "dt_w": layers.dense_init(gen, dr, di),
        "dt_b": torch.zeros((di,), dtype=f32, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": layers.dense_init(gen, di, d),
    }


def _ssm_inputs(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The input projection: returns ``(u, z)``, each ``[B, S, di]``."""
    xz = torch.matmul(x, params["in_proj"].to(x.dtype))
    u, z = xz.chunk(2, dim=-1)
    return constrain(u, "dp", None, "tp"), constrain(z, "dp", None, "tp")


def _post_conv(params: dict, u: torch.Tensor, cfg: ModelConfig):
    """Returns ``(u, dt, B, C)``: ``u`` in the compute dtype, the rest
    fp32."""
    dr, ds = cfg.dt_rank, cfg.ssm_state
    dt_ = u.dtype
    u = F.silu(u)
    # the product sums over d_inner, sharded over a mesh's model axis: its
    # partial sums are reduced here, whole on every model rank (the scan
    # takes B and C so), and the gradient comes back whole too, which
    # DTensor can flatten into the product's backward
    xdbc = constrain(torch.matmul(u, params["x_proj"].to(dt_)),
                     "dp", None, None)
    dt_r, B, C = torch.split(xdbc, [dr, ds, ds], dim=-1)
    dt = F.softplus(torch.matmul(dt_r, params["dt_w"].to(dt_))
                    .to(torch.float32) + params["dt_b"])   # [B, S, di]
    return u, dt, B.to(torch.float32), C.to(torch.float32)


def _causal_conv(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv of width ``ssm_conv``, as a sum of shifted
    products (not ``F.conv1d``, which cuDNN would run in TF32 at fp32).
    With ``conv_state`` (``[B, w-1, di]``, the previous inputs) it runs in
    streaming mode.  Returns ``(out, new_state)``."""
    w = cfg.ssm_conv
    cw = params["conv_w"].to(u.dtype)          # [w, di]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], w - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)          # [B, S+w-1, di]
    out = sum(full[:, i:i + u.shape[1]] * cw[i] for i in range(w))
    new_state = full[:, -(w - 1):] if w > 1 else pad
    return out, new_state


def mamba_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  return_state: bool = False):
    """Full-sequence (prefill) forward.  ``x``: ``[B, S, d]``.  With
    ``return_state`` also returns ``{"conv": ..., "ssm": h_last}``."""
    u, z = _ssm_inputs(params, x, cfg)
    u, conv_state = _causal_conv(params, u, cfg)
    u, dt, B, C = _post_conv(params, u, cfg)
    # y carries the D * u skip already (JAX adds it after its scan)
    y, h_last = ops.selective_scan(u, dt, B, C, params["A_log"],
                                   params["D"])
    y = y.to(x.dtype) * F.silu(z)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    if return_state:
        return out, {"conv": conv_state, "ssm": h_last}
    return out


# ---------------------------------------------------------------------------
# decode (streaming) path
# ---------------------------------------------------------------------------


# each leaf's value in an empty state
STATE_FILL = {"conv": 0, "ssm": 0}


def mamba_state_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> dict:
    leaves = {"conv": ((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype),
              "ssm": ((batch, cfg.d_inner, cfg.ssm_state), torch.float32)}
    return {name: torch.full(shape, STATE_FILL[name], dtype=dt,
                             device=device)
            for name, (shape, dt) in leaves.items()}


def mamba_step(params: dict, x: torch.Tensor, cfg: ModelConfig,
               state: dict):
    """Single-token decode.  ``x``: ``[B, 1, d]``.  Returns
    ``(y, new_state)``."""
    u, z = _ssm_inputs(params, x, cfg)
    u, conv_new = _causal_conv(params, u, cfg, conv_state=state["conv"])
    u, dt, B, C = _post_conv(params, u, cfg)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A)                  # [B, di, ds]
    dBu = (dt[:, 0] * u[:, 0].to(torch.float32))[..., None] \
        * B[:, 0, None, :]
    h = dA * state["ssm"] + dBu
    y = torch.einsum("bis,bs->bi", h, C[:, 0])[:, None, :]
    y = y + u.to(torch.float32) * params["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    return out, {"conv": conv_new, "ssm": h}
