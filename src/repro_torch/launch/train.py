"""Training launcher: supervised, checkpointed, restartable (the JAX
package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
        --smoke --steps 200 --ckpt /tmp/ckpt [--fail-at 120] [--device cpu]

``--smoke`` runs the arch's reduced config; without it the full config.
Checkpoints go through the port's LSM store at ``--ckpt`` (a new temporary
directory by default).  The supervisor restarts from the newest
checkpoint on failure.  With no ``--device`` it runs on ``cuda`` (the
model and the store) and fails where CUDA is absent.

``--mesh-shape DATA MODEL`` trains over a ``("data", "model")`` mesh of
every rank of the world that a launcher set up in the environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun``
sets them): ``nccl`` on the card, ``gloo`` with ``--device cpu``.  It
raises when ``DATA x MODEL`` is not the world size.  Pass a different
``--mesh-shape`` on resume for elastic re-meshing:

    torchrun --nproc-per-node 1 -m repro_torch.launch.train \
        --arch falcon-mamba-7b --smoke --mesh-shape 1 1
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
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
    mesh = None
    started = False
    if args.mesh_shape:
        mesh, started = _mesh(tuple(args.mesh_shape), args.device)

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix=f"ckpt-{args.arch}-")
    loop = TrainLoopConfig(
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_every=args.ckpt_every,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps))

    if mesh is not None:   # one directory for the world: rank 0's
        box = [ckpt]
        dist.broadcast_object_list(box, src=0)
        ckpt = box[0]

    def make_trainer(attempt):
        return Trainer(cfg, loop, ckpt, device=args.device, mesh=mesh,
                       fail_at_step=args.fail_at if attempt == 0 else None)

    lead = mesh is None or dist.get_rank() == 0
    try:
        result = Supervisor(make_trainer,
                            SupervisorConfig(max_restarts=args.max_restarts)
                            ).run()
    finally:
        if started:
            dist.destroy_process_group()
    if lead:
        print(f"finished: step={result.final_step} "
              f"restarts={result.restarts} "
              f"final-loss={result.losses[-1][1]:.4f} ckpt={ckpt}")
    return result


def _mesh(shape: tuple[int, int], device):
    """The ``("data", "model")`` mesh of ``shape`` over the launcher's
    world (started here from the environment when it is not yet), and
    whether this call started it."""
    from repro_torch.launch.mesh import build_mesh
    dev = resolve_device(device)
    started = not dist.is_initialized()
    if started:
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local)
            dist.init_process_group(
                "nccl", device_id=torch.device("cuda", local))
        else:
            dist.init_process_group("gloo")
    try:
        return build_mesh(shape, ("data", "model"), dev), started
    except Exception:
        if started:
            dist.destroy_process_group()
        raise


if __name__ == "__main__":
    main()
