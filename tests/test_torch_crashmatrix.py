"""The port's crash-consistency matrix on the CPU (ROADMAP A9; the twin of
``repro.testing.crashmatrix``).

Every ``MODE_POINTS`` cell runs on the LUDA store (``engine="device"``) on
``device="cpu"``, where the kernels' plain versions stand in for the
card, at the matrix's ``n = 600``: each must crash at its point and pass.
Sabotage must fail in every mode.  In sync mode a cell is deterministic,
so its crash image (the SST and WAL bytes the dead store left) and the
recovered store's scan must equal JAX's ``run_cell`` at the same point,
whose store runs JAX's numpy CPU engine.
"""

import os

import pytest

from repro.lsm import faults as jfaults
from repro.testing import crashmatrix as jcm
from repro_torch.lsm import faults
from repro_torch.testing import crashmatrix as cm

CELLS = [(m, p) for m in cm.MODES for p in cm.MODE_POINTS[m]]


@pytest.fixture(autouse=True)
def _clean_failpoints(monkeypatch):
    # a JAX registry of the test's own: its fire counts live as long as
    # the registry, and the JAX package's tests read them from theirs
    monkeypatch.setattr(jfaults, "FAILPOINTS", jfaults.FailpointRegistry())
    for mod in (jfaults, faults):
        mod.FAILPOINTS.clear()
    yield
    for mod in (jfaults, faults):
        mod.FAILPOINTS.clear()


def test_matrix_shape_as_jax():
    assert cm.MODES == jcm.MODES
    assert cm.MODE_POINTS == jcm.MODE_POINTS
    assert cm.DEFAULT_SPECS == jcm.DEFAULT_SPECS
    assert len(CELLS) == 26
    assert set(cm.DEFAULT_SPECS) <= set(faults.KNOWN_POINTS)


@pytest.mark.parametrize("mode,point", CELLS,
                         ids=[f"{m}-{p}" for m, p in CELLS])
def test_cell_crashes_and_recovers(tmp_path, mode, point):
    checked = []

    def verify(db, acked):
        keys = sorted(acked)
        got = db.multi_get(keys)
        assert got == [db.get(k) for k in keys]
        assert got == [acked[k] for k in keys]
        checked.append(len(keys))

    res = cm.run_cell(point, mode, n=600, device="cpu",
                      workdir=str(tmp_path), verify=verify)
    assert res.crashed, res.line()
    assert res.ok, res.line()
    assert len(checked) == 1   # verify ran on the recovered store
    if point != "shards.write":
        assert res.acked > 0 and checked[0] > 0


@pytest.mark.parametrize("mode,point", [("sync", "compact.install"),
                                        ("async", "compact.install"),
                                        ("sharded", "compact.round")])
def test_sabotage_fails(mode, point):
    res = cm.run_cell(point, mode, n=600, sabotage=True, device="cpu")
    assert res.crashed
    assert not res.ok, "a sabotaged image passed: the checks check nothing"


def _watch(module, seen: dict):
    """Wrap ``module._open_store`` so that the recovery's open records the
    crash image's SST and WAL bytes (before repair) and the recovered
    store's full scan."""
    real = module._open_store

    def open_store(path, mode, **kw):
        if not kw.get("repair"):
            return real(path, mode, **kw)
        files = {}
        for root, _, names in os.walk(path):
            for n in names:
                if n.endswith((".sst", ".log")):
                    p = os.path.join(root, n)
                    files[os.path.relpath(p, path)] = open(p, "rb").read()
        seen["image"] = files
        db = real(path, mode, **kw)
        seen["scan"] = db.scan(b"", b"\xff" * 8)
        return db

    return open_store


@pytest.mark.parametrize("point", cm.MODE_POINTS["sync"])
def test_sync_cell_image_and_recovery_as_jax(tmp_path, monkeypatch, point):
    want, got = {}, {}
    monkeypatch.setattr(jcm, "_open_store", _watch(jcm, want))
    monkeypatch.setattr(cm, "_open_store", _watch(cm, got))
    j = jcm.run_cell(point, "sync", n=600, workdir=str(tmp_path / "j"))
    t = cm.run_cell(point, "sync", n=600, device="cpu",
                    workdir=str(tmp_path / "t"))
    assert j.ok and t.ok and j.crashed and t.crashed
    assert t.acked == j.acked
    assert got["image"] == want["image"] and got["image"]
    assert got["scan"] == want["scan"] and got["scan"]


def test_run_matrix_and_cli(capsys):
    res = cm.run_matrix(["wal.append", "shards.write"], ["sync", "sharded"],
                        n=300, device="cpu")
    assert [(r.mode, r.point) for r in res] == [
        ("sync", "wal.append"), ("sharded", "wal.append"),
        ("sharded", "shards.write")]
    assert all(r.ok and r.crashed and r.seconds > 0 for r in res)
    out = capsys.readouterr().out
    assert out.count("PASS") == 3
    assert cm.main(["--points", "db.write_batch", "--modes", "async",
                    "--n", "300", "--device", "cpu"]) == 0
    assert "1/1 cells green" in capsys.readouterr().out
    assert cm.main(["--points", "compact.install", "--modes", "sync",
                    "--device", "cpu", "--sabotage"]) == 1
    with pytest.raises(SystemExit):
        cm.main(["--modes", "nope", "--device", "cpu"])
