"""Training launcher: supervised, checkpointed, restartable (the JAX
package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
        --smoke --steps 200 --ckpt /tmp/ckpt [--fail-at 120] [--device cpu]

``--smoke`` runs the arch's reduced config; without it the full config.
Checkpoints go through the port's LSM store at ``--ckpt`` (a new temporary
directory by default).  The supervisor restarts from the newest
checkpoint on failure.  With no ``--device`` it runs on ``cuda`` (the
model and the store) and fails where CUDA is absent.  ``--mesh-shape``
waits for the distributed slice (ROADMAP A15).
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.fault_tolerance import (
    Supervisor, SupervisorConfig)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer, TrainLoopConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--mesh-shape", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"))
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh_shape:
        raise NotImplementedError(
            "--mesh-shape trains over a device mesh: it waits for the "
            "distributed slice (ROADMAP A15)")

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix=f"ckpt-{args.arch}-")
    loop = TrainLoopConfig(
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_every=args.ckpt_every,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps))

    def make_trainer(attempt):
        return Trainer(cfg, loop, ckpt, device=args.device,
                       fail_at_step=args.fail_at if attempt == 0 else None)

    result = Supervisor(make_trainer,
                        SupervisorConfig(max_restarts=args.max_restarts)
                        ).run()
    print(f"finished: step={result.final_step} restarts={result.restarts} "
          f"final-loss={result.losses[-1][1]:.4f} ckpt={ckpt}")
    return result


if __name__ == "__main__":
    main()
