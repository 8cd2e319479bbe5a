"""The port's offline repair against the JAX package's, on the CPU (ROADMAP
A9; the twin of ``repro.lsm.repair``).

Stores are written by JAX (``engine="cpu"``) and by the port (the torch
engine's plain versions, ``device="cpu"``) with the same operations, and
damaged the same way: a manifest torn at its failpoint, a corrupt SST, a
missing manifest, a WAL torn at its failpoint, orphans, and all of them at
once.  Each is repaired by its own package, and a second JAX-written copy
by the port's ``repair``.  The three ``RepairReport``s must be equal
(paths by basename), the surviving SSTs (quarantined ones too) and WAL
segments byte-identical, and the MANIFEST records equal up to the
directory.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.lsm import faults as jfaults
from repro.lsm import repair as jrepair
from repro.lsm.db import DBConfig as JConfig
from repro.lsm.db import LsmDB as JDB
from repro.lsm.sharded import ShardedDB as JShardedDB
from repro.testing import crashmatrix as jcrashmatrix
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm import faults, repair
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.lsm.sharded import ShardedDB
from repro_torch.testing import crashmatrix

KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 240          # puts; the last 20 stay in the WAL


def tcfg(**kw):
    return DBConfig(geom=SSTGeometry(**KW), engine="device",
                    memtable_bytes=600, auto_compact=False,
                    scheduler=SchedulerConfig(l0_trigger=3,
                                              base_bytes=40_000), **kw)


def jcfg(**kw):
    return JConfig(geom=JGeometry(**KW), engine="cpu", memtable_bytes=600,
                   auto_compact=False,
                   scheduler=JScheduler(l0_trigger=3, base_bytes=40_000),
                   **kw)


PACKAGES = {
    "jax": (jfaults, lambda p: JDB(p, jcfg(sync_writes=True)), jcrashmatrix),
    "port": (faults, lambda p: LsmDB(p, tcfg(sync_writes=True),
                                     device="cpu"), crashmatrix),
}


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


def write_store(pkg: str, path: str, crash_spec: str | None = None) -> dict:
    """The same puts, flushes and compactions through ``pkg``'s store;
    ``crash_spec`` arms a failpoint that kills it (then the store is left
    as a dead process leaves it).  Returns the acknowledged writes; a
    write in flight at the kill may land new or old, so it is left out
    with its key."""
    mod, make, cm = PACKAGES[pkg]
    db = make(path)
    if crash_spec:
        mod.FAILPOINTS.install(crash_spec)
    acked = {}
    try:
        for i in range(N):
            k, v = b"key%03d" % ((i * 7) % 150), b"val%05d" % i
            acked.pop(k, None)
            db.put(k, v)
            acked[k] = v
            if i in (119, 179):
                db.compact_once()
            if i == N - 21:
                db.flush()
    except mod.SimulatedCrash:
        mod.FAILPOINTS.clear()
        cm._abandon(db)
        return acked
    mod.FAILPOINTS.clear()
    db.close()
    return acked


def live_ssts(path):
    with open(os.path.join(path, "MANIFEST")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    live = set()
    for r in recs:
        if r["op"] == "add":
            live.add(os.path.basename(r["file"]["path"]))
        elif r["op"] == "del":
            live.discard("%06d.sst" % r["file_no"])
    return sorted(live)


def corrupt(path, name):
    p = os.path.join(path, name)
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(8)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def add_orphans(path):
    with open(os.path.join(path, "999999.sst.tmp"), "wb") as f:
        f.write(b"junk")
    first = sorted(n for n in os.listdir(path) if n.endswith(".sst"))[0]
    shutil.copyfile(os.path.join(path, first),
                    os.path.join(path, "999998.sst"))


CRASHES = {"torn_manifest": "manifest.append=torn:a5:x1",
           "torn_wal": "wal.append=torn:a230:x1"}


def damage(pkg: str, path: str, how: str) -> dict:
    """Write ``pkg``'s store at ``path`` and damage it ``how``."""
    acked = write_store(pkg, path, CRASHES.get(how))
    if how in ("corrupt_sst", "all"):
        corrupt(path, live_ssts(path)[0])
    if how in ("orphans", "all"):
        add_orphans(path)
    if how in ("missing_manifest", "all"):
        os.remove(os.path.join(path, "MANIFEST"))
    if how == "all":
        with open(os.path.join(path, "wal.log"), "ab") as f:
            f.write(b"\x07\x00\x00\x00torn")
    return acked


def report_key(rep):
    base = os.path.basename
    return (sorted(base(p) for p in rep.quarantined),
            sorted((base(p), n) for p, n in rep.wal_truncated),
            sorted(base(p) for p in rep.orphans_removed),
            rep.manifest_rebuilt, [base(p) for p in rep.adopted],
            rep.dry_run, rep.changed)


def dir_state(path):
    """The SSTs (``lost/`` too) and WAL segments by relative path, and the
    MANIFEST's records with every file path cut to its basename."""
    files = {}
    for root, _, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            rel = os.path.relpath(p, path)
            if n.endswith((".sst", ".log")) or "lost" in rel or \
                    n.endswith(".tmp"):
                files[rel] = open(p, "rb").read()
    recs = []
    mp = os.path.join(path, "MANIFEST")
    if os.path.exists(mp):
        with open(mp) as f:
            for ln in f:
                try:
                    r = json.loads(ln)
                except json.JSONDecodeError:
                    recs.append(("torn", ln))
                    continue
                if r.get("op") == "add":
                    r["file"]["path"] = os.path.basename(r["file"]["path"])
                recs.append(r)
    return files, recs


HOWS = ["torn_manifest", "corrupt_sst", "missing_manifest", "torn_wal",
        "orphans", "all"]


@pytest.mark.parametrize("how", HOWS)
def test_repair_same_as_jax(tmp_path, how):
    j, j2, t = (str(tmp_path / n) for n in ("j", "j2", "t"))
    acked = damage("jax", j, how)
    assert damage("jax", j2, how) == acked
    assert damage("port", t, how) == acked
    assert dir_state(j) == dir_state(j2) == dir_state(t)   # same damage
    want = jrepair.repair(j)
    got_j2 = repair.repair(j2)
    got_t = repair.repair(t)
    assert want.changed
    assert report_key(got_j2) == report_key(got_t) == report_key(want)
    assert dir_state(j2) == dir_state(t) == dir_state(j)
    if how in ("corrupt_sst", "all"):
        assert want.quarantined and os.listdir(os.path.join(t, "lost"))
    if how == "torn_wal":
        assert got_t.wal_truncated
    if how == "missing_manifest":
        assert got_t.adopted and got_t.manifest_rebuilt
    # idempotent: a second repair finds nothing to do
    assert not repair.repair(t).changed
    assert report_key(repair.repair(j2)) == report_key(jrepair.repair(j))
    # the repaired stores open in the port and read back the same
    lost = set()
    if how in ("corrupt_sst", "all"):
        lost = set(acked)   # rows of the quarantined file may go
    for path in (t, j2):
        db = LsmDB(path, tcfg(), device="cpu")
        jdb = JDB(j, jcfg())
        keys = sorted(acked)
        assert db.multi_get(keys) == [db.get(k) for k in keys] == \
            [jdb.get(k) for k in keys]
        for k, v in acked.items():
            if k not in lost:
                assert db.get(k) == v, (path, k)
        assert db.scan(b"", b"\xff") == jdb.scan(b"", b"\xff")
        db.put(b"zz.post-repair", b"ok")
        assert db.get(b"zz.post-repair") == b"ok"
        db.close()
        jdb.close()


def test_dry_run_touches_nothing_as_jax(tmp_path):
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    damage("jax", j, "all")
    damage("port", t, "all")
    before = dir_state(t)
    names = sorted(os.listdir(t))
    want = jrepair.repair(j, dry_run=True)
    got = repair.repair(t, dry_run=True)
    assert got.dry_run and got.changed
    assert report_key(got) == report_key(want)
    assert dir_state(t) == before and sorted(os.listdir(t)) == names
    assert got.summary().replace(t, "D") == want.summary().replace(j, "D")
    assert "would quarantine" in got.summary()


def test_cli_as_jax(tmp_path, capsys):
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    damage("jax", j, "all")
    damage("port", t, "all")
    assert jrepair.main([j, "--dry-run"]) == 0
    want = capsys.readouterr().out.replace(j, "D")
    assert repair.main([t, "--dry-run"]) == 0
    assert capsys.readouterr().out.replace(t, "D") == want
    assert jrepair.main([j]) == 0
    want = capsys.readouterr().out.replace(j, "D")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.lsm.repair", t],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.replace(t, "D") == want
    assert "rewrite MANIFEST" in want
    assert repair.main([t]) == 0
    assert "clean (nothing to do)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        repair.main([str(tmp_path / "missing")])


def test_open_with_repair(tmp_path, monkeypatch):
    """``LsmDB.open(path, repair=True)`` repairs before it opens (a torn
    WAL tail is cut); without ``repair`` it opens as it is."""
    t = str(tmp_path / "t")
    acked = damage("port", t, "torn_wal")
    calls = []
    real = repair.repair
    monkeypatch.setattr(repair, "repair",
                        lambda p, **kw: calls.append(p) or real(p, **kw))
    db = LsmDB.open(t, tcfg(), device="cpu")
    assert calls == []
    db.close()
    db = LsmDB.open(t, tcfg(), repair=True, device="cpu")
    assert calls == [t]
    assert all(db.get(k) == v for k, v in acked.items())
    db.close()


def sharded_store(pkg, path):
    if pkg == "jax":
        db = JShardedDB(path, jcfg(), boundaries=[b"key075"])
    else:
        db = ShardedDB(path, tcfg(), boundaries=[b"key075"], device="cpu")
    for i in range(N):
        db.put(b"key%03d" % ((i * 7) % 150), b"val%05d" % i)
    db.flush()
    db.close()


def test_repair_sharded_as_jax(tmp_path):
    """``repair_sharded`` over a torn ``SHARDS.json.tmp`` and a corrupt SST
    in shard 1: the same reports and files as JAX's, and the CLI detects
    the sharded store; ``ShardedDB.open(..., repair=True)`` reopens it."""
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    for pkg, path in (("jax", j), ("port", t)):
        sharded_store(pkg, path)
        with open(os.path.join(path, "SHARDS.json.tmp"), "w") as f:
            f.write('{"boundaries": ["6b')
        shard = os.path.join(path, "shard-0001")
        corrupt(shard, live_ssts(shard)[0])
    assert dir_state(j) == dir_state(t)
    want = jrepair.repair_sharded(j)
    got = repair.repair_sharded(t)
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    assert len(got) == 2 and got[1].quarantined and not got[0].changed
    assert not os.path.exists(os.path.join(t, "SHARDS.json.tmp"))
    assert dir_state(t) == dir_state(j)
    assert repair._is_sharded(t) and not repair._is_sharded(
        os.path.join(t, "shard-0000"))
    db = ShardedDB.open(t, tcfg(), repair=True, device="cpu")
    jdb = JShardedDB.open(j, jcfg(), repair=True)
    assert db.boundaries == [b"key075"]
    assert db.scan(b"", b"\xff") == jdb.scan(b"", b"\xff")
    assert len(db.scan(b"", b"\xff")) > 100
    db.close()
    jdb.close()
