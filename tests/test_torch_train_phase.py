"""``chip_smoke.py`` phase 13 (training on the card, ROADMAP A14) rehearsed
on the CPU at the smoke config: (a) train steps with remat, the scan's
forward and backward counted and the backward held against the plain one
on its kept inputs; (b) the ``Trainer`` uninterrupted and under the
``Supervisor`` through the checkpoint store, with its checks; (c) the
launcher as a subprocess.  Every check of (a)-(c) runs and the report has
its lines; the device times, the peak memory and the kernel launches only
happen on the card (on the CPU the scan's calls are counted instead).

(b) runs at a quarter of the checkpoint store's geometry (16 KiB blocks,
512 KiB memtables and SSTs) and d_model 32: the plain CRC on the CPU costs
~32 int64 passes a word, which at the card's geometry would take minutes.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_store_config(engine="device"):
    cfg = REAL_CONFIG(engine)
    return dataclasses.replace(cfg, memtable_bytes=512 * 1024,
                               geom=dataclasses.replace(
                                   cfg.geom, block_bytes=16 * 1024,
                                   sst_bytes=512 * 1024))


REAL_CONFIG = store.checkpoint_db_config


@pytest.fixture(scope="module")
def p13(tmp_path_factory):
    """Phase 13 once.  One intra-op thread here and in the launcher's
    process: the store's plain versions are many small int64 passes, and
    the suite's other workers share the cores."""
    cs = _chip_smoke()
    mp = pytest.MonkeyPatch()
    mp.setattr(store, "checkpoint_db_config", small_store_config)
    mp.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    smoke = get_smoke_config(cs.FALCON)
    # (a) wider than the smoke config, so that a few steps at a high rate
    # show the loss falling; (b) narrower; the launcher (its own process,
    # the store's real geometry) 4 steps with a failure at step 3
    configs = {"full": smoke.with_(remat=True, d_model=512, n_layers=2),
               "ckpt": smoke.with_(d_model=32)}
    reported = []
    try:
        out = cs.train_phase(
            str(tmp_path_factory.mktemp("p13")), "cpu", configs=configs,
            full_sizes=dict(batch=4, seq=32, steps=4,
                            opt=dict(lr=1e-2, warmup_steps=1)),
            ckpt_loop=dict(steps=8, batch=2, seq=16, ckpt_every=3,
                           keep_ckpts=2, log_every=100),
            launcher_args=("--arch", cs.FALCON, "--smoke", "--steps", "4",
                           "--ckpt-every", "2", "--fail-at", "3",
                           "--batch", "2", "--seq", "16"),
            report=lambda part, r: reported.append(
                (part, cs.train_part_lines(part, r, "cpu"))))
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return cs, out, reported


def test_chip_smoke_train_phase_rehearsal(p13):
    cs, out, reported = p13
    assert [part for part, _ in reported] == ["a", "b", "c"]
    assert all(lines and all(line.startswith("[13] (") for line in lines)
               for _, lines in reported)
    assert out["launches"] == {"selective_scan": 0, "selective_scan_bwd": 0}


def test_rehearsal_a_train_steps(p13):
    _, out, _ = p13
    a = out["a"]
    # 2 layers x 4 steps, the forward twice a layer (remat)
    assert a["calls"] == {"selective_scan": 16, "selective_scan_bwd": 8}
    assert a["launches"] == {"selective_scan": 0, "selective_scan_bwd": 0}
    assert a["losses"][-1] < a["losses"][0]
    assert a["kept_shape"] == (4, 32, 1024)
    assert all(e == 0.0 for e in a["bwd_err"].values())   # cpu vs cpu
    assert a["mean_ms"] is None and a["peak"] is None
    assert set(a["bound"]["parts"]) == {"layers", "head", "optimizer"}


def test_rehearsal_b_checkpoint_failure_restart(p13):
    _, out, _ = p13
    b = out["b"]
    # resumed at 3, the losses after it equal, steps() [6, 8]
    assert b["restarts"] == 1 and b["resumed"][0][0] == 3
    assert dict(b["resumed"]) == {s: x for s, x in b["plain"] if s >= 3}
    assert b["steps"] == [6, 8]
    assert len(b["saves"]) == 6 and b["deletes"] > 0 and b["dropped"] > 0
    assert b["jobs"] and b["flushes_checked"] and b["twin_files"] > 0
    assert b["geom"].block_bytes == 16 * 1024


def test_rehearsal_c_launcher(p13):
    _, out, _ = p13
    c = out["c"]
    assert c["restarts"] == 1 and c["line"].startswith("finished: step=4")
    assert len(c["supervisor"]) == 1
