"""The training loop (the JAX package's ``repro.training.train_loop``):
the step loop, checkpoints through the port's LSM store, and restart.

Fault-tolerance contract, as JAX's:
* checkpoints are written every ``ckpt_every`` steps (and at the end), the
  newest ``keep_ckpts`` kept, the rest ``gc``'d into tombstones that the
  store's compactions reclaim;
* data is a function of the step index (``data.tokens``);
* on a failure the supervisor (``distributed.fault_tolerance``) builds a new
  ``Trainer``, which restores the newest step and resumes; within one
  process the resumed run equals an uninterrupted one bit for bit.

``Trainer`` runs on one device (JAX's takes a mesh; ``loop.fsdp`` has no
effect here, as on JAX's 1 x 1 mesh).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.tokens import BigramStream, make_train_batch
from repro_torch.device import resolve_device
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
    ``ckpt_dir`` runs on the same device.  After ``run`` the last state is
    ``self.state``."""

    def __init__(self, cfg: ModelConfig, loop: TrainLoopConfig,
                 ckpt_dir: str, *, device=None,
                 fail_at_step: int | None = None):
        self.cfg = cfg
        self.loop = loop
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.stream = BigramStream(cfg.vocab, seed=loop.seed)
        self.fail_at_step = fail_at_step
        self.step_fn = functools.partial(ts.train_step, cfg=cfg,
                                         opt_cfg=loop.opt)
        self.state_struct = ts.abstract_state(cfg, loop.opt)
        self.state: ts.TrainState | None = None

    def init_or_restore(self) -> tuple[ts.TrainState, int]:
        store = CheckpointStore(self.ckpt_dir, device=self.device)
        try:
            steps = store.steps()
            if steps:
                step = steps[-1]
                return store.restore(step, like=self.state_struct), step
            return ts.init_state(self.loop.seed, self.cfg, self.loop.opt,
                                 device=self.device), 0
        finally:
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
            if step % self.loop.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({time.time()-t0:.1f}s)", flush=True)
            if (step + 1) % self.loop.ckpt_every == 0 or \
                    step + 1 == self.loop.steps:
                self._checkpoint(state, step + 1)
        self.state = state
        return TrainResult(final_step=self.loop.steps, losses=losses)

    def _checkpoint(self, state, step):
        store = CheckpointStore(self.ckpt_dir, device=self.device)
        try:
            store.save(step, state)
            keep = store.steps()[-self.loop.keep_ckpts:]
            store.gc(keep)
        finally:
            store.close()
