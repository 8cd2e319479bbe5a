"""AdamW with global-norm clipping (the JAX package's
``repro.training.optimizer``), plain PyTorch on trees of tensors.

The optimizer state has the params' tree structure.  Every update runs in
fp32 whatever ``state_dtype`` stores the moments in, with JAX's order of
operations.  This is not a kernel: JAX computes it outside any Pallas
kernel too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.convert import tree_leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"   # m/v storage; "bfloat16" halves the
    #                                optimizer's memory (the math stays fp32)


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor   # int32, 0-dim


def init(params, cfg: AdamWConfig | None = None) -> OptState:
    """Zero moments (fp32 leaves stored in ``state_dtype``, the others in
    their own dtype) and step 0, on the params' device."""
    dt = getattr(torch, (cfg or AdamWConfig()).state_dtype)

    def zeros(tree):
        return tree_map(lambda p: torch.zeros(
            p.shape, dtype=dt if p.dtype == _F32 else p.dtype,
            device=p.device), tree)

    device = tree_leaves(params)[0].device
    return OptState(m=zeros(params), v=zeros(params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; fp32."""
    step = step.to(_F32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(_F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def update(cfg: AdamWConfig, grads, opt: OptState, params):
    """Returns ``(new_params, new_opt, metrics)``; nothing is updated in
    place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=_F32, device=step.device),
                       step.to(_F32))
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=_F32, device=step.device),
                       step.to(_F32))

    def upd(p, g, m, v):
        sdt = m.dtype
        g = g.to(_F32) * scale
        m = b1 * m.to(_F32) + (1 - b1) * g
        v = b2 * v.to(_F32) + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:   # decay matrices only (norms and biases exempt)
            delta = delta + cfg.weight_decay * p.to(_F32)
        return ((p.to(_F32) - lr * delta).to(p.dtype), m.to(sdt),
                v.to(sdt))

    out = tree_map(upd, params, grads, opt.m, opt.v)

    def part(k):   # the k-th of each leaf's (param, m, v), as a tree
        return tree_map(lambda _, t: t[k], params, out)

    return part(0), OptState(part(1), part(2), step), {
        "grad_norm": gnorm, "lr": lr}
