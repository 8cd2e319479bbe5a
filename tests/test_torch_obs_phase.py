"""``chip_smoke.py`` phase 11 (metrics and tracing, ROADMAP A10) rehearsed
on the CPU at 1/64 of the paper's SST and L1 sizes, with falcon-mamba-7b's
smoke config serving (d): every check of (a)-(e) runs, the child phases
on the host clock, CPU tensors launch no kernel, and the report has its
lines.  The CUDA-event checks (children against
``compact_device_seconds``, the shared stream, the capture) only happen on
the card."""

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


@pytest.fixture(scope="module")
def p11(tmp_path_factory):
    cs = _chip_smoke()
    cfg = get_smoke_config("falcon-mamba-7b")
    eng = ServeEngine(cfg, model.init(0, cfg, device="cpu"), max_len=32,
                      device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 12)).astype(np.int32))
    geom = SSTGeometry(key_bytes=16, value_bytes=cs.OBS_VALUE + 16,
                       block_bytes=4096, sst_bytes=4 * 1024 * 1024 // DIV,
                       bloom_bits_per_key=10)
    sched = SchedulerConfig(l0_trigger=4, base_bytes=32 * 1024 * 1024 // DIV)
    session_cfg = DBConfig(geom=SSTGeometry(
        key_bytes=16, value_bytes=256, block_bytes=4096, sst_bytes=8192),
        memtable_bytes=4096)
    reported = []
    out = cs.obs_phase(str(tmp_path_factory.mktemp("p11")), "cpu", eng,
                       prompts, geom=geom, sched=sched,
                       session_cfg=session_cfg,
                       report=lambda part, r: reported.append(part))
    return cs, out, reported


def test_chip_smoke_obs_phase_rehearsal(p11):
    cs, out, reported = p11
    assert reported == ["a", "b", "c", "d", "held", "e"]
    assert not any(out["launches"].values())   # CPU tensors launch none
    a, b, c, d, e = (out[k] for k in "abcde")
    assert a["counters"] == len(a["row"]["db_stats"]) >= 30
    assert a["launch"]["launches"] == a["row"]["compactions"] >= 2
    assert a["launch"]["scaled"] == 0 and a["events"] > a["spans"]
    assert a["names"]["db.put"] == a["row"]["db_stats"]["puts"]
    assert b["gets"] > 0 and b["multi_gets"] > 0
    assert b["launch"]["launches"] >= 1 and b["launch"]["shared"] == 0
    assert {"flush.build", "flush.install_l0", "memtable.rotate",
            "read.bloom_probe", "read.block_gather"} <= set(b["names"])
    assert c["launch"]["max_jobs"] == cs.OBS_SHARDS and c["batch"][0] >= 1
    assert {name for name, _, _ in c["batched"]} >= {"merge_runs",
                                                     "prefix_encode_wire"}
    assert d["hists"] == {"generate": 1, "page_out": 1, "page_in": 1}
    assert d["captures"] == []   # eager decode on the CPU
    assert out["held"]["jobs"] and len(out["held"]["flushes"]) == \
        cs.KEPT_FLUSHES
    assert e["events"] == [0] and set(e["puts"]) == {"untraced", "traced"}
    assert e["job"]["traced"][0] == e["job"]["untraced"][0] == 0.0


def test_chip_smoke_obs_phase_lines(p11):
    cs, out, reported = p11
    lines = [ln for part in reported
             for ln in cs.obs_part_lines(part, out[part], "card")]
    assert len(lines) == 8 and all(ln.startswith("[11] ") for ln in lines)
    assert "lsm.* counters equal DBStats" in lines[0] and "[card]" in lines[0]
    assert "obs.report exit 0" in lines[2]
    assert "the cost of tracing" in lines[-2]
