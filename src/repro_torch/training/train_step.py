"""The training step: loss -> grads -> AdamW (the JAX package's
``repro.training.train_step``), on one device or, through
``shard_train_step``, over a ``DeviceMesh``.

Over a mesh the state is a tree of DTensors placed by
``distributed.partition`` (Megatron TP over "model", ZeRO-3 FSDP over the
data axes), the batch is sharded over the data axes, and the model runs on
DTensors under ``annotate.mesh_annotations``: its ``constrain`` hints
redistribute the activations as JAX's do, and the few ops without a
DTensor rule (the embedding gather, the label pick, the selective scan)
run on local shards with their placements written out.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.distributed import annotate, partition
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


@contextlib.contextmanager
def mesh_context(mesh):
    """The model's context over ``mesh``: its ``constrain`` hints on, and
    plain tensors made inside (positions, masks, zeros) taken as
    replicated DTensors.  Nothing when ``mesh`` is None."""
    if mesh is None:
        yield
        return
    with annotate.mesh_annotations(mesh), \
            annotate.replicate_plain_tensors():
        yield


def _like(t, ref):
    """``t`` with ``ref``'s placements when ``ref`` is a DTensor."""
    if isinstance(ref, DTensor):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def replicated(t):
    """A metric as a plain tensor: a DTensor's full value on every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def train_step(state: TrainState, batch: dict, *, cfg: ModelConfig,
               opt_cfg: opt.AdamWConfig, mesh=None,
               cast_params_once: bool = True):
    """One step: ``lm_loss`` of ``batch`` (tensors on the params' device),
    its gradient with respect to the fp32 params (through the working copy
    when ``cast_params_once``), then ``opt.update``.  Returns ``(new_state,
    metrics)`` with ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` as
    0-dim tensors; ``state`` is not written.  With ``mesh`` (a state and
    batch of DTensors placed on it, as ``shard_train_step`` places them)
    each gradient and each new leaf keeps its param's placements, and the
    metrics come back replicated, as plain tensors."""
    with mesh_context(mesh):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state.params)
        with torch.enable_grad():
            work = working_copy(params, cfg) if cast_params_once else params
            loss, parts = model.lm_loss(work, batch, cfg)
            leaves = tree_leaves(params)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        it = iter(_like(g, p) for g, p in zip(grads, leaves))
        grads = tree_map(lambda _: next(it), params)
        new_params, new_opt, om = opt.update(opt_cfg, grads, state.opt,
                                             state.params)
        if mesh is not None:
            new_params = tree_map(_like, new_params, state.params)
            new_opt = opt.OptState(tree_map(_like, new_opt.m, state.opt.m),
                                   tree_map(_like, new_opt.v, state.opt.v),
                                   _like(new_opt.step, state.opt.step))
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), **om}
        if mesh is not None:
            metrics = {k: replicated(torch.as_tensor(v))
                       for k, v in metrics.items()}
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


def state_shardings(state_struct: TrainState, cfg: ModelConfig, mesh, *,
                    fsdp: bool = True) -> TrainState:
    """The state's ``partition.NamedSharding``s: the params by
    ``partition.param_specs``, the moments as their params, the step
    replicated."""
    ps = partition.param_shardings(state_struct.params, cfg, mesh,
                                   fsdp=fsdp)
    return TrainState(params=ps, opt=opt.OptState(
        m=ps, v=ps, step=partition.named_sharding(mesh, ())))


def place_state(state: TrainState, cfg: ModelConfig, mesh, *,
                fsdp: bool = True) -> TrainState:
    """``state`` (whole tensors, the same shapes on every rank) as
    DTensors on ``mesh``, each rank's shards taken from rank 0's values.
    A collective: every rank calls it."""
    return partition.place(state, state_shardings(state, cfg, mesh,
                                                  fsdp=fsdp))


def shard_train_step(cfg: ModelConfig, mesh, batch: int, seq: int,
                     opt_cfg: opt.AdamWConfig | None = None, *,
                     fsdp: bool = True):
    """Build ``(fn, state_struct, batch_struct)`` for ``mesh``, as JAX's.
    ``fn(state, batch) -> (new_state, metrics)`` runs ``train_step`` over
    the mesh; it places a plain-tensor state or batch first (the batch
    sharded over the data axes by ``partition.batch_specs``, each rank's
    rows taken from rank 0's batch).  ``fn.shardings`` is the state's
    ``state_shardings``.  Every rank calls ``fn`` (its collectives)."""
    opt_cfg = opt_cfg or opt.AdamWConfig()
    state_struct = abstract_state(cfg, opt_cfg)
    shardings = state_shardings(state_struct, cfg, mesh, fsdp=fsdp)
    batch_struct = make_batch_struct(cfg, batch, seq)
    bshard = partition.map_specs(
        lambda s: partition.named_sharding(mesh, s),
        partition.batch_specs(batch_struct, mesh))

    def fn(state: TrainState, batch: dict):
        state = partition.place(state, shardings)
        batch = partition.place(batch, {k: bshard[k] for k in batch})
        return train_step(state, batch, cfg=cfg, opt_cfg=opt_cfg, mesh=mesh)

    fn.shardings = shardings
    return fn, state_struct, batch_struct
