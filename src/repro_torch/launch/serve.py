"""Serving launcher: batched greedy generation (the JAX package's
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        [--smoke] --batch 4 --prompt-len 12 --max-new 16 [--device cpu]

With no ``--device`` it runs on ``cuda`` and fails where CUDA is absent.
Paging the session to the LSM store waits for ROADMAP A11; the launcher
says so and pages nothing.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    eng = ServeEngine(cfg, model.init(args.seed, cfg, device=args.device),
                      max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    out, _, _ = eng.generate(prompts, max_new=args.max_new)
    for i, row in enumerate(out):
        print(f"req{i}: {row.tolist()}")
    print("session not paged: the LSM session store is not ported yet "
          "(ROADMAP A11)")


if __name__ == "__main__":
    main()
