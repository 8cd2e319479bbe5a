"""Crash-consistency matrix on the LUDA store (the port of
``repro.testing.crashmatrix``): kill the store at every failpoint, reopen,
check the acknowledged-write invariant.

For each cell of ``failpoint x {sync, async, sharded}`` the harness runs a
scripted write workload against a live store armed with one failpoint (a
``torn`` or ``crash`` action, one fire), treats the resulting
:class:`~repro_torch.lsm.faults.SimulatedCrash` as process death,
snapshots the directory *as the dead process left it*, reopens the
snapshot with ``repair=True``, and checks:

* **durability** -- every acknowledged ``put`` survives with its exact
  value (the one in-flight write may land old or new, never partial);
* **batch atomicity** -- the workload issues a 3-op ``write_batch`` every
  9 ops; an in-flight batch must land all or none (every key old, or
  every key new: a mix is a torn batch).  In sharded mode the batch keys
  sort below the boundary, so each batch goes to one shard
  (``write_batch`` is atomic a shard);
* **integrity** -- a full scan returns strictly increasing unique keys,
  each acknowledged or in flight (no duplicate or resurrected row);
* **liveness** -- the reopened store accepts new writes.

Cells whose failpoint cannot fire in a mode (``compact.round`` and
``shards.write`` without the sharded queue) are not in ``MODE_POINTS``.

The one difference from the JAX matrix, whose stores run the numpy CPU
engine: every store here is the LUDA store, ``DBConfig(engine="device")``
on ``device`` (``cuda`` unless the caller passes ``"cpu"``), so each
flush and compaction of a cell runs the store's kernels, and the
recovered store's reads run the read kernels.  The configuration, the
workload and the checks are the JAX matrix's.

CLI::

    python -m repro_torch.testing.crashmatrix                 # full matrix
    python -m repro_torch.testing.crashmatrix --points wal.append,sst.write
    python -m repro_torch.testing.crashmatrix --modes sync --n 300
    python -m repro_torch.testing.crashmatrix --device cpu
    python -m repro_torch.testing.crashmatrix --sabotage      # MUST fail

``--sabotage`` corrupts a referenced SST in the crash image before
recovery; repair quarantines it, acknowledged rows vanish, and the run
must exit non-zero: the proof that the checks check something.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

from repro_torch.device import resolve_device
from repro_torch.lsm import faults
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.lsm.sharded import ShardedDB

MODES = ("sync", "async", "sharded")

#: Per-point armed spec: one fire, placed so acked data already exists.
DEFAULT_SPECS = {
    "wal.append": "torn:a150:x1",
    "wal.fsync": "crash:a150:x1",
    "sst.write": "torn:a1:x1",
    "sst.rename": "crash:a1:x1",
    "manifest.append": "torn:a1:x1",
    "flush.build": "crash:a1:x1",
    "compact.install": "crash:x1",
    "compact.round": "crash:a1:x1",
    "shards.write": "torn:x1",
    "db.write_batch": "crash:a2:x1",
}

#: Points that can fire per mode (compact.round / shards.write need the
#: sharded queue; everything else fires in any mode).
MODE_POINTS = {
    "sync": ["wal.append", "wal.fsync", "sst.write", "sst.rename",
             "manifest.append", "flush.build", "compact.install",
             "db.write_batch"],
    "async": ["wal.append", "wal.fsync", "sst.write", "sst.rename",
              "manifest.append", "flush.build", "compact.install",
              "db.write_batch"],
    "sharded": ["wal.append", "wal.fsync", "sst.write", "sst.rename",
                "manifest.append", "flush.build", "compact.install",
                "compact.round", "shards.write", "db.write_batch"],
}


@dataclasses.dataclass
class CellResult:
    point: str
    mode: str
    crashed: bool = False       # the injected kill actually happened
    acked: int = 0              # puts acknowledged before death
    errors: list[str] = dataclasses.field(default_factory=list)
    seconds: float = 0.0        # the cell's wall time (run_matrix)

    @property
    def ok(self) -> bool:
        return not self.errors

    def line(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        crash = "crashed" if self.crashed else "no-fire"
        msg = f"{status}  {self.mode:8s} {self.point:18s} " \
              f"[{crash}, {self.acked} acked]"
        for e in self.errors:
            msg += f"\n        - {e}"
        return msg


def _open_store(path: str, mode: str, *, device=None, failpoints=None,
                repair=False):
    """The LUDA store of ``mode`` on ``device`` (None: ``cuda``)."""
    device = resolve_device(device)
    cfg = DBConfig(engine="device", sync_writes=True, memtable_bytes=640,
                   async_compaction=(mode == "async"),
                   failpoints=failpoints)
    if mode == "sharded":
        return ShardedDB.open(path, cfg, repair=repair, device=device,
                              boundaries=None if os.path.exists(
                                  os.path.join(path, "SHARDS.json"))
                              else [b"k00300"])
    return LsmDB.open(path, cfg, repair=repair, device=device)


def _quiesce(db) -> None:
    """Best-effort: let surviving background workers finish so the crash
    image is a settled disk state (a real kill freezes every thread at
    once; here only the injected one died)."""
    execs = []
    for holder in [db] + list(getattr(db, "shards", [])):
        for name in ("_flush_exec", "_compact_exec"):
            ex = getattr(holder, name, None)
            if ex is not None:
                execs.append(ex)
    queue = getattr(db, "queue", None)
    if queue is not None:
        execs.append(queue._exec)
    for ex in execs:
        try:
            ex.wait_idle(timeout=10.0)
        except BaseException:   # noqa: BLE001 - includes the crash itself
            pass


def _abandon(db) -> None:
    """Drop a 'dead' store without close() (close would wait for its
    background work and write -- a dead process cannot).  Only releases
    file handles, stops threads and closes the engine's pinned staging
    (a matrix opens about 60 stores in one process)."""
    for holder in [db] + list(getattr(db, "shards", [])):
        for name in ("_flush_exec", "_compact_exec"):
            ex = getattr(holder, name, None)
            if ex is not None:
                try:
                    ex.shutdown(wait=False)
                except BaseException:   # noqa: BLE001
                    pass
        w = getattr(holder, "_wal", None)
        if w is not None:
            try:
                w.close()
            except BaseException:   # noqa: BLE001
                pass
    queue = getattr(db, "queue", None)
    if queue is not None:
        try:
            queue.close()
        except BaseException:   # noqa: BLE001
            pass
    try:
        db.engine.close()
    except BaseException:   # noqa: BLE001
        pass


def _corrupt_one_sst(image: str) -> str | None:
    """Sabotage helper: flip bytes in the middle of the first SST found
    (recursing into shard dirs).  Returns the path, or None."""
    for root, _, files in os.walk(image):
        for name in sorted(files):
            if name.endswith(".sst"):
                p = os.path.join(root, name)
                size = os.path.getsize(p)
                with open(p, "r+b") as f:
                    f.seek(size // 2)
                    chunk = f.read(8)
                    f.seek(size // 2)
                    f.write(bytes(b ^ 0xFF for b in chunk))
                return p
    return None


def run_cell(point: str, mode: str, *, n: int = 600,
             sabotage: bool = False, workdir: str | None = None,
             device=None, verify=None) -> CellResult:
    """One matrix cell: workload + injected kill + snapshot + recovery
    + invariant checks, on the LUDA store on ``device`` (None: ``cuda``).
    ``verify(db, acked)``, if given, is one more check of the recovered
    store (``acked``: the acknowledged writes, in-flight keys left out);
    an exception it raises fails the cell."""
    device = resolve_device(device)
    res = CellResult(point=point, mode=mode)
    spec = {point: DEFAULT_SPECS[point]}
    top = workdir or tempfile.mkdtemp(prefix=f"crashmatrix-{mode}-")
    live = os.path.join(top, "live")
    image = os.path.join(top, "image")

    oracle: dict[bytes, bytes] = {}
    inflight: tuple[bytes, bytes] | None = None
    inflight_batch: list[tuple[bytes, bytes]] | None = None
    db = None
    try:
        db = _open_store(live, mode, device=device, failpoints=spec)
        for i in range(n):
            # coprime stride interleaves the key space so successive
            # memtables overlap -- compactions are real merges, not
            # trivial moves (which would bypass compact.install)
            j = (i * 7919) % n
            if i % 9 == 4 and i >= 20:
                # atomic group write: two fresh keys + an overwrite of a
                # prior batch key, ONE WAL record.  All keys sort below
                # the sharded boundary (b"k00300"), so the batch routes
                # to one shard -- the session-store contract.
                jp = ((i - 9) * 7919) % n
                batch = [(b"a%05d" % j, b"av%05d" % i),
                         (b"b%05d" % j, b"bv%05d" % i),
                         (b"a%05d" % jp, b"a2v%05d.%d" % (jp, i))]
                inflight_batch = batch
                db.write_batch([("put", k, v) for k, v in batch])
                for k, v in batch:
                    oracle[k] = v
                inflight_batch = None
                continue
            k = b"k%05d" % j
            v = b"v%05d.%d" % (j, 0)
            if i % 10 == 5 and i >= 10:     # overwrite an acked key
                j = ((i - 7) * 7919) % n
                k = b"k%05d" % j
                v = b"v%05d.%d" % (j, 1)
            inflight = (k, v)
            db.put(k, v)
            oracle[k] = v
            inflight = None
        db.flush()
        db.wait_idle()
    except BaseException as e:  # noqa: BLE001 - the injected kill
        res.crashed = True
        if not isinstance(e, faults.SimulatedCrash) and \
                faults.FAILPOINTS.fired(point) == 0:
            res.errors.append(f"workload died without firing: {e!r}")
    finally:
        faults.FAILPOINTS.clear()
    res.acked = len(oracle)
    if not res.crashed:
        res.errors.append("failpoint never fired (workload survived)")
        if db is not None:
            db.close()
            db = None
    if db is not None:
        _quiesce(db)
        shutil.copytree(live, image)    # the disk as the dead process left it
        _abandon(db)
    else:
        shutil.copytree(live, image)
    # the dead process's disk is GONE: recovery must work from the image
    # alone (the manifest may record absolute paths into the old dir --
    # repair rewrites them; deleting proves nothing reads through)
    shutil.rmtree(live, ignore_errors=True)

    if sabotage:
        _corrupt_one_sst(image)

    # -- recovery + invariants ------------------------------------------
    db2 = None
    try:
        db2 = _open_store(image, mode, device=device, repair=True)
        # in-flight keys are judged old-or-new below, not exact-value
        skip: set[bytes] = set()
        if inflight is not None:
            skip.add(inflight[0])
        if inflight_batch is not None:
            skip.update(k for k, _ in inflight_batch)
        if verify is not None:
            # first, while the recovered store's block cache is cold
            verify(db2, {k: v for k, v in oracle.items() if k not in skip})
        for k, want in oracle.items():
            if k in skip:
                continue
            got = db2.get(k)
            if got != want:
                res.errors.append(
                    f"acked key {k!r} lost or wrong: {got!r} != {want!r}")
                if len(res.errors) > 5:
                    break
        if inflight is not None:
            got = db2.get(inflight[0])
            if got not in (oracle.get(inflight[0]), inflight[1]):
                res.errors.append(
                    f"in-flight key {inflight[0]!r} partial: {got!r}")
        if inflight_batch is not None:
            # all-or-nothing: every key of the un-acked batch must be
            # its old value, or every key its new value -- never a mix
            landed = []
            for k, newv in inflight_batch:
                got = db2.get(k)
                oldv = oracle.get(k)    # pre-batch state (ack updates it)
                if got == newv:
                    landed.append(True)
                elif got == oldv:
                    landed.append(False)
                else:
                    res.errors.append(
                        f"in-flight batch key {k!r} partial: {got!r}")
            if True in landed and False in landed:
                res.errors.append(
                    f"in-flight batch torn: landed={landed}")
        rows = db2.scan(b"", b"\xff" * 8)
        prev = None
        allowed = set(oracle)
        if inflight is not None:
            allowed.add(inflight[0])
        if inflight_batch is not None:
            allowed.update(k for k, _ in inflight_batch)
        for k, v in rows:
            if prev is not None and k <= prev:
                res.errors.append(f"scan not strictly increasing at {k!r}")
                break
            prev = k
            if k not in allowed:
                res.errors.append(f"resurrected/unknown key {k!r}")
                break
        # liveness: the recovered store accepts new writes
        db2.put(b"zz.post-recovery", b"ok")
        if db2.get(b"zz.post-recovery") != b"ok":
            res.errors.append("recovered store rejected a new write")
    except BaseException as e:  # noqa: BLE001 - any recovery failure
        res.errors.append(f"recovery failed: {e!r}")
    finally:
        if db2 is not None:
            try:
                db2.close()
            except BaseException as e:  # noqa: BLE001
                res.errors.append(f"close after recovery failed: {e!r}")
        if workdir is None:
            shutil.rmtree(top, ignore_errors=True)
    return res


def run_matrix(points=None, modes=None, *, n: int = 600,
               sabotage: bool = False, verbose: bool = True, device=None,
               verify=None, workdir: str | None = None) -> list[CellResult]:
    """Run the (sub)matrix on ``device`` (None: ``cuda``); returns one
    :class:`CellResult` per cell, each with its ``seconds``.  With
    ``workdir``, each cell runs in a directory of its own below it (None:
    a new temporary directory a cell)."""
    device = resolve_device(device)
    modes = list(modes or MODES)
    results = []
    for mode in modes:
        eligible = MODE_POINTS[mode]
        for point in (points or eligible):
            if point not in eligible:
                continue
            t0 = time.perf_counter()
            cell = None if workdir is None else \
                os.path.join(workdir, f"{mode}-{point}")
            try:
                res = run_cell(point, mode, n=n, sabotage=sabotage,
                               workdir=cell, device=device, verify=verify)
            finally:
                if cell is not None:
                    shutil.rmtree(cell, ignore_errors=True)
            res.seconds = time.perf_counter() - t0
            if verbose:
                print(f"{res.line()}  ({res.seconds:.1f}s)", flush=True)
            results.append(res)
    return results


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.testing.crashmatrix",
        description="Crash-consistency matrix: kill at every failpoint, "
                    "reopen with repair, assert acked writes survive.")
    ap.add_argument("--points", help="comma-separated failpoint subset")
    ap.add_argument("--modes", help=f"comma-separated subset of {MODES}")
    ap.add_argument("--n", type=int, default=600,
                    help="workload size per cell (default 600)")
    ap.add_argument("--device", default=None,
                    help="the stores' device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--sabotage", action="store_true",
                    help="corrupt an SST in the crash image first "
                         "(self-test: the run MUST fail)")
    args = ap.parse_args(argv)
    points = args.points.split(",") if args.points else None
    modes = args.modes.split(",") if args.modes else None
    if modes:
        for m in modes:
            if m not in MODES:
                ap.error(f"unknown mode {m!r} (one of {MODES})")
    if points:
        for p in points:
            if p not in DEFAULT_SPECS:
                ap.error(f"unknown matrix point {p!r} "
                         f"(one of {sorted(DEFAULT_SPECS)})")
    results = run_matrix(points, modes, n=args.n, sabotage=args.sabotage,
                         device=args.device)
    failed = [r for r in results if not r.ok]
    print(f"\ncrash matrix: {len(results) - len(failed)}/{len(results)} "
          f"cells green")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
