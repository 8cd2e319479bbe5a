"""``chip_smoke.py`` phase 12 (the attention, MoE and encoder-decoder
archs, ROADMAP A12) rehearsed on the CPU at the smoke configs: gemma3 and
granite-moe served (their windows of 16 slots wrapped by the ring check),
a gemma3 session paged through a small store, card against CPU (here CPU
against CPU), and every other arch once.  Every check of (a)-(e) runs and
the report has its lines; the captures and the device times only happen
on the card."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core.formats import SSTGeometry
from repro_torch.lsm.db import DBConfig

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def p12(tmp_path_factory):
    cs = _chip_smoke()
    smoke = get_smoke_config
    configs = {
        "serve": (smoke(cs.GEMMA), smoke(cs.GRANITE_MOE)),
        "xdev": tuple(smoke(n).with_(n_layers=min(k, smoke(n).n_layers))
                      for n, k in cs.XDEV),
        "once": tuple(smoke(n).with_(n_layers=2) for n in cs.CUT_ARCHS)
        + (smoke(cs.WHISPER), smoke(cs.JAMBA))}
    reported = []
    out = cs.archs_phase(
        str(tmp_path_factory.mktemp("p12")), "cpu", configs=configs,
        serve_sizes=dict(batch=2, prompt_len=12, max_new=4),
        ring=dict(prompt_len=12, steps=8), xdev_tokens=16,
        once_sizes=dict(batch=2, prompt_len=24, steps=8, frames=20),
        session_prompt=8,
        db_cfg=DBConfig(geom=SSTGeometry(key_bytes=16, value_bytes=256,
                                         block_bytes=4096, sst_bytes=8192),
                        memtable_bytes=4096),
        report=lambda part, r: reported.append(
            (part, cs.archs_part_lines(part, r, "cpu"))))
    return cs, out, reported


def test_chip_smoke_archs_phase_rehearsal(p12):
    cs, out, reported = p12
    assert [part for part, _ in reported] == ["a", "e", "b", "c", "d"]
    assert all(lines and all(line.startswith("[12] (") for line in lines)
               for _, lines in reported)
    a, b = out["a"], out["b"]
    assert a["ring"]["wrapped"] == 4 and a["ring"]["slots"] == 16
    assert a["ring"]["worst"] <= cs.LOGIT_TOL
    assert a["tokens"].shape == b["tokens"].shape == (2, 4)
    assert a["weight_bytes"] > 0 and b["cache_bytes"] > 0
    # the step's bound reads only the experts its routing hits: 2 requests
    # x top-2 of 4 experts reach at most 4 in each of the 2 MoE layers
    assert a["experts_hit"] == [] and len(b["experts_hit"]) == 2
    assert all(1 <= n <= 4 for n in b["experts_hit"])
    assert "drops" not in a and len(b["drops"]) == 2
    # 2 x 12 tokens, top-2 of 4 experts at a factor of 1.25: 16 slots each
    assert all(n == 48 and c == 16 for _, n, c in b["drops"])
    assert [x["name"] for x in out["c"]] == [n for n, _ in cs.XDEV]
    assert all(x["forward_gap"] == 0.0 for x in out["c"])   # cpu vs cpu
    assert out["c"][1]["routes"] == 6   # forward, prefill, step x 2 layers
    rows = {x["name"]: x for x in out["d"]}
    assert set(rows) == set(cs.CUT_ARCHS) | {cs.WHISPER, cs.JAMBA}
    assert not rows[cs.WHISPER]["served"] and \
        not rows["internvl2-26b"]["served"]
    assert rows[cs.JAMBA]["served"] and rows[cs.JAMBA]["bitwise"]
    assert all(x["decode_gap"][0] <= cs.LOGIT_TOL for x in out["d"])
    # CPU tensors launch no kernel
    assert not any(out["launches"].values())
    assert out["e"]["resume"] == cs.SESSION_RESUME
