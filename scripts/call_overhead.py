"""Host cost of the port's kernel wrappers on the card: one call of each
wrapper that a compaction job or an LM step reaches, one compaction job of
each sort mode and one train step, timed by CUDA events.

Run it once per tree to compare two trees of the port on one card, in one
session (the tree's package first on the path):

    PYTHONPATH=<tree>/src python3 scripts/call_overhead.py --label NAME \\
        [--out FILE] [--job-reps N] [--no-train]

It prints one JSON object (appended to ``--out`` too): each time is the
median of its repetitions in ms, with the card's name and power limit.
Shapes are ``chip_smoke.py``'s phase 2 (a 4-SST L0 job of the paper
geometry: 4,096 blocks, 65,536 rows), phase 5's scan (4 x 512 tokens at
falcon-mamba-7b's widths) and phase 13 (a)'s train step (falcon-mamba-7b
at full width, 4 layers, 4 x 512 tokens).  It refuses to run without a
card.  It uses only wrappers that every tree of the port since PR 30 has.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch


def event_ms(fn, reps: int, warm: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn`` in ms; for a small
    kernel mostly the host's launch path."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def i32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


def wrapper_calls(dev, reps: int) -> dict:
    from repro_torch.configs.luda_paper import PAPER
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    g = PAPER.geometry(256)
    B, K, L, Vw = 4096, g.block_kvs, g.key_lanes, g.value_words
    n = B * K
    sections = [i32(rng.integers(0, 2**32, (B, w), dtype=np.uint32), dev)
                for w in (1, K * L, K, K * Vw, K)]
    keys = np.zeros((n, L), dtype=np.uint32)      # sorted, one prefix
    keys[:, 0] = 0x6B657900
    keys[:, L - 1] = np.sort(rng.choice(2 * n, n, replace=False))
    keys[61_440:] = 0                             # the pack's survivors
    keys_c = i32(keys, dev)
    count = torch.tensor(61_440, dtype=torch.int64, device=dev)
    bkeys = i32(rng.integers(0, 2**32, (B, K, L), dtype=np.uint32), dev)
    valid = torch.from_numpy(rng.random((B, K)) < 0.94).to(dev)
    rows = rng.integers(0, 2**32, (n, L + 2), dtype=np.uint32)
    rows[:, -1] = rng.permutation(n)          # a unique index lane
    rows = i32(rows, dev)
    di, ds = 8192, 16

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    scan = (normal(4, 512, di).to(torch.bfloat16),
            torch.nn.functional.softplus(normal(4, 512, di) - 2.0),
            normal(4, 512, ds), normal(4, 512, ds),
            torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=dev).repeat(di, 1)),
            normal(di))
    calls = {
        "crc32_sections": lambda: ops.crc32_sections(sections),
        "prefix_encode_wire": lambda: ops.prefix_encode_wire(
            keys_c, count, restart_interval=16),
        "bloom_build": lambda: ops.bloom_build(
            bkeys, valid, n_words=g.bloom_words(K), n_probes=g.bloom_probes),
        "bitonic_sort/65536": lambda: ops.bitonic_sort(rows),
        "selective_scan/4x512": lambda: ops.selective_scan(*scan),
    }
    return {name: event_ms(fn, reps) for name, fn in calls.items()}


def compaction_jobs(dev, reps: int) -> dict:
    """One L0 job of four sorted runs of 1,024 blocks each (65,536 rows)
    over one key space, a tenth tombstones, at ``PAPER.geometry(256)``."""
    from repro_torch.configs.luda_paper import PAPER
    from repro_torch.core import compaction, formats, offload
    rng = np.random.default_rng(1)
    g = PAPER.geometry(256)
    rows = 1024 * g.block_kvs
    images = []
    for r in range(4):
        ids = np.sort(rng.choice(2 * rows, rows, replace=False))
        keys = np.zeros((rows, g.key_lanes), dtype=np.uint32)
        keys[:, 0] = 0x6B657900
        keys[:, g.key_lanes - 1] = ids.astype(np.uint32)
        is_value = (rng.random(rows) >= 0.1).astype(np.uint32)
        meta = (((np.arange(rows, dtype=np.uint32) + 1 + r * rows) << 1)
                | is_value).astype(np.uint32)
        vals = rng.integers(0, 2**32, (rows, g.value_words), dtype=np.uint32)
        k, m, v = formats.words_to_tensors([keys, meta, vals], dev)
        images.append(offload.build_image(k, m, v, geom=g))
    img, runs = formats.concat_images(images, with_runs=True)
    return {f"compact/{mode}": event_ms(
        lambda m=mode: compaction.compact(img, geom=g, sort_mode=m,
                                          run_lens=runs), reps)
        for mode in ("device", "merge")}


def train_steps(dev, reps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import BigramStream, make_train_batch
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_step as ts
    cfg = get_config("falcon-mamba-7b").with_(n_layers=4)
    opt_cfg = optim.AdamWConfig(total_steps=reps + 2, lr=1e-3,
                                warmup_steps=2)
    state = ts.init_state(0, cfg, opt_cfg, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(
        cfg, BigramStream(cfg.vocab, seed=0), 0, 4, 512).items()}
    box = [state]

    def step():
        box[0], _ = ts.train_step(box[0], batch, cfg=cfg, opt_cfg=opt_cfg)
    return {"train_step/4x512": event_ms(step, reps, warm=1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--label", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--job-reps", type=int, default=20)
    p.add_argument("--no-train", action="store_true",
                   help="skip the train step (the wrappers and jobs only)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("call_overhead: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    rec = {"label": args.label, "card": card, "torch": torch.__version__}
    rec.update(wrapper_calls(dev, args.reps))
    rec.update(compaction_jobs(dev, args.job_reps))
    if not args.no_train:
        rec.update(train_steps(dev, 5))
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
