"""``chip_smoke.py`` phase 9 (the async write path, ROADMAP A8) rehearsed on
the CPU at 1/64 of the paper's SST and L1 sizes, with falcon-mamba-7b's
smoke config serving (f): every check of (a)-(f) runs, CPU tensors launch
no kernel, and the report has its lines.  The capture in (f) and the
launch checks of (a) and (c) only happen on the card."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm.db import DBConfig
from repro_torch.models import model
from repro_torch.serving.engine import ServeEngine

REPO = Path(__file__).resolve().parents[1]
DIV = 64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def geometry(v):
    return SSTGeometry(key_bytes=16, value_bytes=v + 16, block_bytes=4096,
                       sst_bytes=4 * 1024 * 1024 // DIV,
                       bloom_bits_per_key=10)


@pytest.fixture(scope="module")
def p9(tmp_path_factory):
    cs = _chip_smoke()
    cfg = get_smoke_config("falcon-mamba-7b")
    eng = ServeEngine(cfg, model.init(0, cfg, device="cpu"), max_len=32,
                      device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 12)).astype(np.int32))
    session_cfg = DBConfig(geom=SSTGeometry(
        key_bytes=16, value_bytes=256, block_bytes=4096, sst_bytes=8192),
        memtable_bytes=4096)
    sched = SchedulerConfig(l0_trigger=4, base_bytes=32 * 1024 * 1024 // DIV)
    work = tmp_path_factory.mktemp("p9")
    out = cs.async_phase(str(work), "cpu", eng, prompts,
                         geom=geometry(cs.ASYNC_VALUE), sched=sched,
                         geometry=geometry, session_cfg=session_cfg,
                         mix_ops=2000, sample=300)
    return cs, out, work


def test_async_phase_files_and_ycsb(p9):
    cs, out, work = p9
    a, b = out["a"], out["b"]
    recs = cs.memtable_records(geometry(1024), 1024)
    assert recs == 64   # 64 KiB memtables of 1,040-byte records
    assert a["ops"] == 8 * recs * 5 // 4
    assert a["sync"]["flushes"] == a["async"]["flushes"] >= 8
    assert a["sync"]["l0_files"] == a["async"]["l0_files"] > 0
    assert a["async"]["compactions"] >= 1
    assert not a["async"]["workers"]   # CPU tensors launch none
    assert a["jobs_seen"] and all(n == 0 for _, n, _ in a["jobs_seen"])
    assert len(a["job_checks"]) == len(a["jobs_seen"])
    assert len(a["flush_checks"]) == cs.KEPT_FLUSHES
    assert {w for w, _ in a["wave_checks"]} == set(cs.WAVE_WRAPPERS)
    assert a["async"]["drain_device_ms"] is None   # CUPTI only on the card
    assert a["behind"]["l0"] >= 4 and a["behind"]["wait_ms"] >= 0
    for mode in ("sync", "async"):
        r = b[mode]
        assert r["mode"] == mode and r["reads"] > 0
        assert r["records"] == r["operations"] == 9 * (65_536 // 1040)
        assert r["compactions"] >= 1 and r["jobs_run"] >= 1
        assert not r["reader_launches"] and r["compact_device_s"] is None
        assert r["gets_after_drain"] == r["scan_rows"] > 0
    assert {w for w, _ in b["async"]["wave_checks"]} == set(cs.WAVE_WRAPPERS)
    assert b["async"]["write_stalls"] >= 0
    assert sorted(p.name for p in work.iterdir()) == []


def test_async_phase_halt_sharded_and_capture(p9):
    cs, out, _ = p9
    d, e, f = out["d"], out["e"], out["f"]
    assert "injected build failure" in d["wait_idle"]
    assert "BackgroundError" in d["rotation"]
    assert d["queued"] == cs.HALT_MEMTABLES - 1 and d["resumed"] is True
    assert d["l0_halted"] >= 1 and d["files"] > d["l0_halted"]
    assert d["failed_on"].startswith("flush-")
    assert e["counts"]["stats"].compactions >= 1 and e["reads"] > 0
    assert e["scan_rows"] >= 4 * e["per_shard"]
    assert f["queued"] == 1 and f["flushes"] >= 1
    assert f["inside"] is None   # no capture on the CPU
    assert f["tokens"].shape == (cs.CAPTURE_BATCH, cs.SERVE_NEW)
    assert not any(out["launches"].values())
    lines = cs.async_lines(out, "card").splitlines()
    assert len(lines) == 13 and all(ln.startswith("[9] ") for ln in lines)
    assert "async / sync p99 put" in lines[6]
    assert "[card]" in lines[5] and "byte-identical" in lines[0]
    assert "behind a running compaction" in lines[2]
