"""Serving launcher: batched greedy generation with LSM-paged sessions
(the JAX package's ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        [--smoke] --batch 4 --prompt-len 12 --max-new 16 \
        [--page-dir /tmp/pages] [--device cpu]

Every arch whose prompts are tokens alone is served; whisper-medium
(``frames``) and internvl2-26b (``patches``) are refused before the model
is built, as JAX's launcher fails on them at ``generate``.  The session
``(cache, pos)`` is paged out to an ``LsmDB`` at 4 KiB values
and 32 KiB blocks.  With no ``--device`` it runs on ``cuda`` (the model
and the store) and fails where CUDA is absent.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.formats import SSTGeometry
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.models import model
from repro_torch.serving.engine import ServeEngine, check_servable


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    check_servable(cfg)
    params = model.init(args.seed, cfg, device=args.device)
    page_dir = args.page_dir or tempfile.mkdtemp(prefix="kv-pages-")
    store = LsmDB(page_dir, DBConfig(
        geom=SSTGeometry(key_bytes=16, value_bytes=4096,
                         block_bytes=32 * 1024, sst_bytes=512 * 1024),
        engine="device", memtable_bytes=256 * 1024), device=args.device)
    try:
        eng = ServeEngine(cfg, params, max_len=args.max_len,
                          device=args.device, page_store=store)
        del params   # the engine keeps its cast copy only
        rng = np.random.default_rng(args.seed)
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)
                               ).astype(np.int32)
        out, cache, pos = eng.generate(prompts, max_new=args.max_new)
        for i, row in enumerate(out):
            print(f"req{i}: {row.tolist()}")
        n = eng.save_session("serve-cli", cache, pos)
        print(f"session paged to LSM store ({n} records, dir={page_dir})")
    finally:
        store.close()


if __name__ == "__main__":
    main()
