"""Failure supervision and restart (the JAX package's
``repro.distributed.fault_tolerance``).

``Supervisor`` runs a trainer, catches a worker's failure and builds a new
trainer from its factory, which restores the newest checkpoint and
resumes -- possibly on another mesh (the factory may build the new
trainer over a different ``DeviceMesh``: the elastic restart).  A
heartbeat file records liveness for an outside watchdog.
"""

from __future__ import annotations

import dataclasses
import json
import time

from repro_torch.training.train_loop import TrainResult


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 3
    heartbeat_path: str | None = None


class Supervisor:
    def __init__(self, make_trainer, cfg: SupervisorConfig | None = None):
        """``make_trainer(attempt) -> Trainer``."""
        self.make_trainer = make_trainer
        self.cfg = cfg or SupervisorConfig()

    def heartbeat(self, step: int, attempt: int):
        if self.cfg.heartbeat_path:
            with open(self.cfg.heartbeat_path, "w") as f:
                json.dump({"time": time.time(), "step": step,
                           "attempt": attempt}, f)

    def run(self) -> TrainResult:
        attempt = 0
        restarts = 0
        while True:
            trainer = self.make_trainer(attempt)
            try:
                self.heartbeat(-1, attempt)
                result = trainer.run()
                result.restarts = restarts
                return result
            except Exception as e:  # worker died
                restarts += 1
                attempt += 1
                if restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}"
                    ) from e
                print(f"[supervisor] worker failed ({e}); restart "
                      f"#{restarts} from last checkpoint", flush=True)
