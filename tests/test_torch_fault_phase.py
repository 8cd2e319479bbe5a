"""``chip_smoke.py`` phase 10 (the store's fault paths, ROADMAP A9)
rehearsed on the CPU: the crash matrix at half its operations, the fault
workload at 300 puts, the LUDA store on the kernels' plain versions.
Every check of (a)-(g) runs; CPU tensors launch no kernel, so the launch
checks of (a) only happen on the card."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.lsm import faults

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def p10(tmp_path_factory):
    cs = _chip_smoke()
    work = tmp_path_factory.mktemp("p10")
    reported = []
    out = cs.fault_phase(str(work), "cpu", n=300, ops_n=300,
                         report=lambda part, r: reported.append(part))
    faults.FAILPOINTS.clear()
    return cs, out, work, reported


def test_chip_smoke_fault_phase_rehearsal(p10):
    cs, out, work, reported = p10
    assert reported == list("acdefg")
    a = out["a"]
    assert a["cells"] == 26 and a["engines"] >= 26 and a["checked"] > 0
    assert {m: len(c) for m, c in a["by_mode"].items()} == \
        {"sync": 8, "async": 8, "sharded": 10}
    assert all(acked > 0 for m, cells in a["by_mode"].items()
               for p, acked, _ in cells if p != "shards.write")
    assert [m for m, _, _ in a["sabotage"]] == ["sync", "async", "sharded"]
    assert not any(a["launched"].values())   # CPU tensors launch none
    assert not any(out["launches"].values())
    c, d, e, f, g = (out[k] for k in "cdefg")
    assert c["fault_retries"] == 1 and c["files"] > 0
    assert c["round_fault"]["retries"] == 1
    assert c["round_clean"]["stacked"] >= 1
    for r in (c["round_clean"], c["round_fault"]):
        assert {name for name, _, _ in r["batched_calls"]} == \
            {"merge_runs", "prefix_encode_wire"}
    for part in (a, c, d, e, f):   # read waves held against ``ref``
        assert {name for name, _ in part["waves"]} == \
            set(cs.WAVE_WRAPPERS)
    assert d["async_clean_launch_retries"] == 0
    assert e["sync_launch_retries"] == e["async_launch_retries"] == 0
    assert f["launch_retries"] == 0
    assert d["sync_fired"] == 2 and d["async_fired"] == 8
    assert d["async_error"][0] == "transient" and d["resumed"] is True
    assert e["async_retries"] == 2 and e["files"] > 1
    assert f["checked"] > f["shed_at"] > 0 and f["stalls"] == 0
    assert g["jobs"] and len(g["flushes"]) >= 26
    # the matrix's stores are gone; the kept jobs' links stay for the run
    kept = [p.name for p in work.iterdir()]
    assert len(kept) > a["engines"] and all(
        n.startswith("keep-") for n in kept)


def test_chip_smoke_fault_phase_lines(p10):
    cs, out, _, _ = p10
    lines = [ln for part in "acdefg"
             for ln in cs.fault_part_lines(part, out[part], "card")]
    assert len(lines) == 11 and all(ln.startswith("[10] ") for ln in lines)
    assert "26 cells crashed" in lines[0] and "[card]" in lines[0]
    assert "(b) sabotage failed" in lines[4]
    assert "byte-identical" in lines[-1]
