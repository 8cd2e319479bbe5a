"""The training loop (the JAX package's ``repro.training.train_loop``):
the step loop, checkpoints through the port's LSM store, and restart.

Fault-tolerance contract, as JAX's:
* checkpoints are written every ``ckpt_every`` steps (and at the end), the
  newest ``keep_ckpts`` kept, the rest ``gc``'d into tombstones that the
  store's compactions reclaim;
* data is a function of the step index (``data.tokens``);
* on a failure the supervisor (``distributed.fault_tolerance``) builds a new
  ``Trainer``, which restores the newest step -- possibly onto a
  *different* mesh (elastic restart) -- and resumes; within one process
  the resumed run equals an uninterrupted one bit for bit.

Over a mesh (``Trainer(..., mesh=)``) every rank of the world runs the
loop.  Rank 0 owns the checkpoint store (it writes whole tensors, each
gathered in its turn while the others send their shards, and reads them
back, the others receiving their shards), and each
step's batch is rank 0's: ``data.tokens`` seeds from Python's salted
``hash``, so each process would make its own.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import CheckpointStore, receive, send
from repro_torch.data.tokens import BigramStream, make_train_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import partition
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as optim
from repro_torch.training import train_step as ts


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 20
    keep_ckpts: int = 2
    log_every: int = 10
    seed: int = 0
    fsdp: bool = True
    opt: optim.AdamWConfig = dataclasses.field(
        default_factory=lambda: optim.AdamWConfig(lr=1e-3, warmup_steps=20))


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list
    restarts: int = 0


class Trainer:
    """``device`` None means ``cuda``; the checkpoint store at
    ``ckpt_dir`` runs on the same device.  ``mesh`` (a keyword here, where
    JAX's takes it third) trains over a ``DeviceMesh`` with
    ``train_step.shard_train_step`` (fsdp as ``loop.fsdp``) on the mesh's
    device type, and restores onto the mesh's shardings.  After ``run``
    the last state is ``self.state``."""

    def __init__(self, cfg: ModelConfig, loop: TrainLoopConfig,
                 ckpt_dir: str, *, device=None, mesh=None,
                 fail_at_step: int | None = None):
        self.cfg = cfg
        self.loop = loop
        self.mesh = mesh
        # the one process that prints and owns the store: rank 0 of a mesh
        self.lead = mesh is None or dist.get_rank() == 0
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
        self.ckpt_dir = ckpt_dir
        self.stream = BigramStream(cfg.vocab, seed=loop.seed)
        self.fail_at_step = fail_at_step
        if mesh is None:
            self.step_fn = functools.partial(ts.train_step, cfg=cfg,
                                             opt_cfg=loop.opt)
            self.state_struct = ts.abstract_state(cfg, loop.opt)
        else:
            self.step_fn, self.state_struct, _ = ts.shard_train_step(
                cfg, mesh, batch=loop.batch, seq=loop.seq,
                opt_cfg=loop.opt, fsdp=loop.fsdp)
        self.state: ts.TrainState | None = None

    def _store(self) -> CheckpointStore | None:
        return CheckpointStore(self.ckpt_dir, device=self.device) \
            if self.lead else None

    def init_or_restore(self) -> tuple[ts.TrainState, int]:
        store = self._store()
        try:
            steps = [store.steps() if store is not None else None]
            if self.mesh is not None:
                dist.broadcast_object_list(steps, src=0)
            steps = steps[0]
            if self.mesh is None:
                if steps:
                    return store.restore(steps[-1],
                                         like=self.state_struct), steps[-1]
                return ts.init_state(self.loop.seed, self.cfg,
                                     self.loop.opt, device=self.device), 0
            shardings = self.step_fn.shardings
            if steps:
                if store is not None:
                    state = store.restore(steps[-1], like=self.state_struct,
                                          shardings=shardings)
                else:
                    state = receive(self.state_struct, shardings,
                                    self.device)
                return state, steps[-1]
            state = ts.init_state(self.loop.seed, self.cfg, self.loop.opt,
                                  device=self.device)
            return partition.place(state, shardings), 0
        finally:
            if store is not None:
                store.close()

    def run(self) -> TrainResult:
        state, start = self.init_or_restore()
        losses = []
        t0 = time.time()
        for step in range(start, self.loop.steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                self.fail_at_step = None  # fail once
                raise RuntimeError(f"injected failure at step {step}")
            batch = make_train_batch(self.cfg, self.stream, step,
                                     self.loop.batch, self.loop.seq)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append((step, loss))
            if step % self.loop.log_every == 0 and self.lead:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({time.time()-t0:.1f}s)", flush=True)
            if (step + 1) % self.loop.ckpt_every == 0 or \
                    step + 1 == self.loop.steps:
                self._checkpoint(state, step + 1)
        self.state = state
        return TrainResult(final_step=self.loop.steps, losses=losses)

    def _checkpoint(self, state, step):
        store = self._store()
        try:
            if store is not None:
                store.save(step, state)
                keep = store.steps()[-self.loop.keep_ckpts:]
                store.gc(keep)
            elif self.mesh is not None:
                send(state)
        finally:
            if store is not None:
                store.close()
            if self.mesh is not None:
                dist.barrier()
