"""Failpoint fault injection and the background-error taxonomy (the port of
``repro.lsm.faults``).

Every failure path of the store goes through two primitives here:

* **Failpoints** -- named injection sites in the write and engine paths
  (``wal.append``, ``sst.rename``, ``engine.launch``, ...; the names and
  sites are ``KNOWN_POINTS``).  A failpoint costs one dict probe under a
  lock when disarmed.  It is armed by ``DBConfig(failpoints=...)``, the
  ``REPRO_FAILPOINTS`` environment variable or the scoped
  :meth:`FailpointRegistry.active`, and then raises a recoverable error,
  simulates process death, or has its site tear the write in half first
  (the actions below).  ``repro_torch.testing.crashmatrix`` drives the
  ``failpoint x {sync, async, sharded}`` grid.

* **Error severity** -- :func:`classify` maps an exception to
  ``"transient"`` (worth retrying: I/O hiccups, injected soft faults) or
  ``"hard"`` (retrying cannot help: checksum mismatches, corruption,
  logic errors).  :class:`BackgroundError` carries that verdict on the
  store's ``bg_error``; ``with_retries`` retries only the transient
  class, and ``LsmDB.resume()`` restarts a halted pipeline.

Failpoint spec grammar (comma-separated)::

    name=action[:pRATE][:aAFTER][:xCOUNT]

    wal.append=torn               tear the next WAL record, then "die"
    flush.build=raise:x2          the first two flush builds fail
    engine.launch=raise:p0.5      each device launch fails with p 0.5
    manifest.append=crash:a3      3 appends succeed, the 4th "dies"

Actions:

====== ==============================================================
raise  raise ``FaultInjected(severity="transient")`` at the site
hard   raise ``FaultInjected(severity="hard")``
crash  raise :class:`SimulatedCrash` (a ``BaseException``: recovery
       code that catches ``Exception`` cannot swallow it, as nothing
       catches a real ``kill -9``)
torn   ``fire()`` returns ``TORN``; the site writes a partial prefix,
       flushes it, then raises :class:`SimulatedCrash`
off    disarmed (the same as not installing the point)
====== ==============================================================
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time

from repro_torch.lsm.fs import fsync_dir  # noqa: F401 - the JAX module's name

TORN = "torn"

_ACTIONS = ("raise", "hard", "crash", "torn", "off")

#: Every failpoint in the store, and where it fires.
KNOWN_POINTS = {
    "wal.append": "WALWriter.append, before the record is framed",
    "wal.fsync": "WALWriter.append, before fsync of a synced record",
    "sst.write": "write_sst, while the .tmp payload is being written",
    "sst.rename": "write_sst, between .tmp fsync and os.replace",
    "manifest.append": "VersionSet.log_and_apply, while appending records",
    "shards.write": "ShardedDB boundary persist, writing SHARDS.json.tmp",
    "engine.launch": "device compaction, before the kernel launch",
    "engine.crc": "device compaction, at the post-launch CRC verdict",
    "cache.insert": "BlockCache.put, before inserting a decoded block",
    "flush.build": "background flush, before building the SST image",
    "db.write_batch": "LsmDB.write_batch, after the WAL record is "
                      "written, before the memtable apply",
    "compact.install": "LsmDB.apply_compaction, before installing outputs",
    "compact.round": "GlobalCompactionQueue drain round, before picking jobs",
}


class FaultInjected(IOError):
    """Raised at an armed failpoint; carries the severity verdict."""

    def __init__(self, point: str, severity: str = "transient"):
        super().__init__(f"injected fault at failpoint {point!r} ({severity})")
        self.point = point
        self.severity = severity


class SimulatedCrash(BaseException):
    """Simulated process death at a failpoint.

    A ``BaseException`` on purpose: code that catches ``Exception`` must
    not be able to "handle" a crash; the only answer is what a real crash
    gets, a reopen (and repair)."""

    def __init__(self, point: str):
        super().__init__(f"simulated process death at failpoint {point!r}")
        self.point = point


class BackgroundError(IOError):
    """A classified background failure parked on the store's ``bg_error``.

    ``severity == "transient"`` means the in-line retries ran out but the
    failure class is recoverable: ``LsmDB.resume()`` restarts the
    pipeline.  ``"hard"`` means retrying cannot help (corruption, a
    checksum mismatch, a logic error); ``resume()`` still clears the
    error, but repair should run first."""

    def __init__(self, op: str, cause: BaseException):
        self.op = op
        self.cause = cause
        self.severity = classify(cause)
        super().__init__(
            f"background {op} failed ({self.severity}): {cause!r}; "
            "call resume() to restart the pipeline")


def classify(err: BaseException) -> str:
    """Severity verdict for a background failure: transient or hard.

    Injected faults carry their own verdict; checksum and corruption
    failures are hard (a retry re-reads the same bad bytes); other I/O
    errors are transient (the retryable class); anything else -- a failed
    kernel launch, an assertion, a type error -- is hard."""
    if isinstance(err, BackgroundError):
        return err.severity
    if isinstance(err, FaultInjected):
        return err.severity
    msg = str(err).lower()
    if "checksum" in msg or "crc" in msg or "corrupt" in msg:
        return "hard"
    if isinstance(err, OSError):
        return "transient"
    return "hard"


# ---------------------------------------------------------------------------
# retry and backoff


def backoff_delays(retries: int, base_s: float, *, factor: float = 2.0,
                   jitter: float = 0.5, rng=random):
    """``retries`` exponentially growing sleeps, each with jitter."""
    for i in range(retries):
        yield base_s * factor ** i * (1.0 + jitter * rng.random())


def with_retries(fn, *, retries: int = 3, base_s: float = 0.005,
                 on_retry=None):
    """Call ``fn()``; retry a transient failure with backoff and jitter.

    Hard failures and :class:`SimulatedCrash` (a ``BaseException``)
    propagate at once; a transient one is retried up to ``retries`` times,
    after a sleep that grows exponentially.  ``on_retry`` (if given) is
    called once a retry (the store's ``bg_retries`` count)."""
    delays = backoff_delays(retries, base_s)
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:
            if classify(e) != "transient" or attempt == retries:
                raise
            if on_retry is not None:
                on_retry()
            time.sleep(next(delays))


# ---------------------------------------------------------------------------
# the registry


@dataclasses.dataclass
class _Spec:
    """One armed failpoint (its counters are guarded by the registry)."""

    action: str
    rate: float = 1.0           # fire probability once armed
    after: int = 0              # evaluations skipped before arming
    count: int | None = None    # most fires (None: unlimited)
    hits: int = 0               # evaluations seen
    fires: int = 0              # times it fired


def _parse_one(name: str, val) -> _Spec:
    if isinstance(val, _Spec):
        return dataclasses.replace(val)
    if isinstance(val, (tuple, list)):
        action, *rest = val
        spec = _Spec(str(action))
        if len(rest) > 0 and rest[0] is not None:
            spec.rate = float(rest[0])
        if len(rest) > 1 and rest[1] is not None:
            spec.after = int(rest[1])
        if len(rest) > 2 and rest[2] is not None:
            spec.count = int(rest[2])
    else:
        parts = str(val).split(":")
        spec = _Spec(parts[0])
        for mod in parts[1:]:
            if mod.startswith("p"):
                spec.rate = float(mod[1:])
            elif mod.startswith("a"):
                spec.after = int(mod[1:])
            elif mod.startswith("x"):
                spec.count = int(mod[1:])
            else:
                raise ValueError(
                    f"bad failpoint modifier {mod!r} in {name}={val!r} "
                    f"(expected p<rate>, a<after>, or x<count>)")
    if spec.action not in _ACTIONS:
        raise ValueError(
            f"unknown failpoint action {spec.action!r} for {name!r} "
            f"(one of {', '.join(_ACTIONS)})")
    if not 0.0 <= spec.rate <= 1.0:
        raise ValueError(f"failpoint rate out of [0,1] for {name!r}: {spec.rate}")
    return spec


def parse_failpoints(spec) -> dict[str, _Spec]:
    """Normalise a spec into ``{name: _Spec}``.

    Takes ``"a=raise,b=torn:x1"`` strings (the environment variable's
    form), dicts of ``name -> "action:mods"`` strings, or dicts of
    ``name -> (action, rate, after, count)`` tuples.  Unknown names are
    rejected: a misspelt failpoint that never fires would turn a fault
    test into a no-op."""
    if spec is None:
        return {}
    items: list[tuple[str, object]]
    if isinstance(spec, str):
        items = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad failpoint spec {part!r} (want name=action)")
            name, val = part.split("=", 1)
            items.append((name.strip(), val.strip()))
    else:
        items = list(spec.items())
    out = {}
    for name, val in items:
        if name not in KNOWN_POINTS:
            raise ValueError(
                f"unknown failpoint {name!r} (known: {', '.join(sorted(KNOWN_POINTS))})")
        out[name] = _parse_one(name, val)
    return out


class FailpointRegistry:
    """Thread-safe registry of armed failpoints.

    One process-global instance (:data:`FAILPOINTS`) backs every
    injection site; tests scope injection with :meth:`active` so that no
    spec leaks between cases.  ``fire()`` is the only hot call."""

    def __init__(self, spec=None, *, seed: int = 0xFA17):
        self._lock = threading.Lock()
        self._specs: dict[str, _Spec] = parse_failpoints(spec)  # guarded-by: _lock
        self._fired: dict[str, int] = {}    # guarded-by: _lock (survives clear())
        self._rng = random.Random(seed)     # guarded-by: _lock

    def install(self, spec) -> None:
        """Arm failpoints from a spec (merged over those armed)."""
        parsed = parse_failpoints(spec)
        with self._lock:
            self._specs.update(parsed)

    def clear(self, *names: str) -> None:
        """Disarm the named failpoints (all of them when none is named)."""
        with self._lock:
            if not names:
                self._specs.clear()
            else:
                for n in names:
                    self._specs.pop(n, None)

    def reseed(self, seed: int) -> None:
        """Re-seed the probability RNG."""
        with self._lock:
            self._rng = random.Random(seed)

    def fired(self, name: str) -> int:
        """Fires of ``name`` over the registry's lifetime."""
        with self._lock:
            return self._fired.get(name, 0)

    def fire_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._fired)

    @contextlib.contextmanager
    def active(self, spec):
        """Scoped injection: install ``spec``, restore the prior specs of
        those names on exit."""
        parsed = parse_failpoints(spec)
        with self._lock:
            saved = {n: self._specs.get(n) for n in parsed}
            self._specs.update(parsed)
        try:
            yield self
        finally:
            with self._lock:
                for n, prior in saved.items():
                    if prior is None:
                        self._specs.pop(n, None)
                    else:
                        self._specs[n] = prior

    def fire(self, name: str):
        """Evaluate failpoint ``name`` at its site.

        Returns ``None`` (disarmed or not triggered) or :data:`TORN` (the
        site tears its write, then raises ``SimulatedCrash(name)``);
        raises as the armed action says."""
        with self._lock:
            spec = self._specs.get(name)
            if spec is None or spec.action == "off":
                return None
            spec.hits += 1
            if spec.hits <= spec.after:
                return None
            if spec.count is not None and spec.fires >= spec.count:
                return None
            if spec.rate < 1.0 and self._rng.random() >= spec.rate:
                return None
            spec.fires += 1
            self._fired[name] = self._fired.get(name, 0) + 1
            action = spec.action
        if action == "raise":
            raise FaultInjected(name, "transient")
        if action == "hard":
            raise FaultInjected(name, "hard")
        if action == "crash":
            raise SimulatedCrash(name)
        return TORN


#: The process-global registry behind every injection site;
#: ``REPRO_FAILPOINTS`` arms points for the whole process.
FAILPOINTS = FailpointRegistry(os.environ.get("REPRO_FAILPOINTS") or None)


def fire(name: str):
    """``FAILPOINTS.fire(name)``."""
    return FAILPOINTS.fire(name)
