"""The training step: loss -> grads -> AdamW (the JAX package's
``repro.training.train_step``), on one device.

``shard_train_step`` (JAX's sharded, jitted step over a mesh) waits for the
distributed slice (ROADMAP A15).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_leaves, tree_map
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: dict
    opt: opt.OptState


def init_state(seed: int, cfg: ModelConfig,
               opt_cfg: opt.AdamWConfig | None = None, *,
               device=None) -> TrainState:
    """fp32 params (``model.init``) and zero moments.  ``device`` None
    means ``cuda``."""
    params = model.init(seed, cfg, device=device)
    return TrainState(params=params, opt=opt.init(params, opt_cfg))


def abstract_state(cfg: ModelConfig,
                   opt_cfg: opt.AdamWConfig | None = None) -> TrainState:
    """The state's structure, shapes and dtypes on the ``meta`` device (no
    allocation), as JAX's ``eval_shape`` gives them: the init is traced
    with fake tensors."""
    with FakeTensorMode():
        fake = init_state(0, cfg, opt_cfg, device="cpu")
    return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device="meta"), fake)


def working_copy(params: dict, cfg: ModelConfig) -> dict:
    """JAX's cast rule for the step's one working copy: every fp32 leaf
    of two or more dimensions in the compute dtype (a stacked leaf counts
    its layer axis, so the stacked norm scales, ``A_log``, ``D`` and
    ``dt_b`` are cast too, and so is the untied head); the rest as it
    is.  Not ``model.cast_params``, which keeps the leaves used in fp32."""
    cdt = getattr(torch, cfg.dtype)
    return tree_map(lambda p: p.to(cdt)
                    if p.dtype == torch.float32 and p.dim() >= 2 else p,
                    params)


def train_step(state: TrainState, batch: dict, *, cfg: ModelConfig,
               opt_cfg: opt.AdamWConfig, cast_params_once: bool = True):
    """One step: ``lm_loss`` of ``batch`` (tensors on the params' device),
    its gradient with respect to the fp32 params (through the working copy
    when ``cast_params_once``), then ``opt.update``.  Returns ``(new_state,
    metrics)`` with ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` as
    0-dim tensors; ``state`` is not written."""
    params = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    with torch.enable_grad():
        work = working_copy(params, cfg) if cast_params_once else params
        loss, parts = model.lm_loss(work, batch, cfg)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    new_params, new_opt, om = opt.update(opt_cfg, grads, state.opt,
                                         state.params)
    metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
               "aux": parts["aux"].detach(), **om}
    return TrainState(new_params, new_opt), metrics


def make_batch_struct(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``(shape, dtype)`` of each tensor of one training batch (the stub
    frontends take embeddings)."""
    out = {}
    if cfg.frontend == "vision":
        out["tokens"] = ((batch, seq - cfg.frontend_len), torch.int32)
        out["patches"] = ((batch, cfg.frontend_len, cfg.d_model),
                          torch.bfloat16)
    else:
        out["tokens"] = ((batch, seq), torch.int32)
    if cfg.enc_dec:
        out["frames"] = ((batch, seq, cfg.d_model), torch.bfloat16)
    out["labels"] = (out["tokens"][0], torch.int32)
    return out


def shard_train_step(*args, **kw):
    raise NotImplementedError(
        "shard_train_step builds the step over a device mesh: it waits for "
        "the distributed slice (ROADMAP A15); train_step runs on one device")
