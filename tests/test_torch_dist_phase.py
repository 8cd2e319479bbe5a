"""``chip_smoke.py`` phase 14 (the distributed layer on the card, ROADMAP
A15) rehearsed on the CPU at small sizes: (a) in a world of this process
alone (gloo here, NCCL on the card) the sharded step against
``train_step``, the sharded serving steps against ``ServeEngine``'s
tokens and one job through ``sharded_compact``; (b) four gloo ranks with
the range shards, the scan's DTensor wrapper, EP MoE and the compressed
mean.  Every check of the phase runs and its report has its lines; the
device times and the kernel launches only happen on the card.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.formats import SSTGeometry
from repro_torch.models import model as lm
from repro_torch.serving.engine import ServeEngine
from repro_torch.testing.world import TEST_NICE

REPO = Path(__file__).resolve().parents[1]
GEOM = SSTGeometry(key_bytes=16, value_bytes=32, block_bytes=1024,
                   sst_bytes=8192)


def _chip_smoke():
    # the ranks import the script by name, so its directory is on the path
    # they inherit
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def p14():
    cs = _chip_smoke()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serve_cfg = get_smoke_config(cs.FALCON)
        eng = ServeEngine(serve_cfg, lm.init(0, serve_cfg, device="cpu"),
                          max_len=8 + 3, device="cpu")
        prompts = np.random.default_rng(0).integers(
            0, serve_cfg.vocab, (2, 8)).astype(np.int32)
        want, _, _ = eng.generate(torch.from_numpy(prompts), 3)
        lines = []
        sizes = {"train": dict(batch=2, seq=16),
                 "serve": dict(batch=2, prompt_len=8, max_new=3),
                 "compact": dict(geom=GEOM, rows=256),
                 "ranks": dict(geom=GEOM, rows=256,
                               scan=dict(batch=4, seq=16, di=64),
                               moe=dict(tokens=(4, 16), cfg_kw=dict(
                                   d_model=64, moe_d_ff=32)))}
        out = cs.dist_phase(
            torch.device("cpu"), want,
            configs={"train": get_config(cs.FALCON).with_(
                n_layers=2, d_model=64, vocab=512), "serve": serve_cfg},
            sizes=sizes, nice=TEST_NICE, report=lambda part, r: lines.extend(
                cs.dist_part_lines(part, r, "CPU")))
    finally:
        torch.set_num_threads(threads)
    return out, lines


def test_a_sharded_step_equals_train_step(p14):
    r, _ = p14
    t = r["train"]
    assert t["bitwise"] and t["losses"] == t["plain"]
    assert np.isfinite(t["losses"]).all()


def test_a_serving_and_compaction(p14):
    r, _ = p14
    assert r["serve"]["tokens"].shape == (2, 3)
    st = r["compact"]["stats"]
    assert st[0] == 1024 and 0 < st[1] < st[0] and st[3]


def test_b_ranks_agree_with_one_device(p14):
    r, _ = p14
    ranks = r["ranks"]
    assert len(ranks) == 4
    assert all(x["stats"] == ranks[0]["stats"] for x in ranks)
    for x in ranks:
        assert x["scan"]["equal"]["y"] and x["scan"]["equal"]["du"]
        assert x["moe"]["errs"]["y"] <= 2e-4
        assert x["compressed"]["rel"] < 0.05


def test_report_lines(p14):
    _, lines = p14
    text = "\n".join(lines)
    for part in ("[14] (a) shard_train_step", "[14] (a) shard_prefill",
                 "[14] (a) place_sharded", "[14] (b) 4 ranks",
                 "[14] (b) the scan's DTensor wrapper", "[14] (b) EP MoE",
                 "[14] (b) compressed mean"):
        assert part in text, part
