"""Metrics registry: counters, gauges, log-bucketed latency histograms
(the port's copy of ``repro.obs.metrics``, whose buckets, percentiles and
snapshots it reproduces exactly).

Zero-dependency (stdlib only) and safe to touch from any thread:

* ``Counter`` / ``Gauge`` guard their value with a private lock, so the
  background flush workers and the compaction drainer can increment
  store statistics without holding (or racing) the DB lock.
* ``Histogram`` buckets values geometrically (4 buckets per doubling, so
  any percentile estimate is within ~9% of the true value) and is
  **mergeable**: per-shard histograms sum bucket-wise into exactly the
  histogram the combined stream would have produced.  The hot-path
  recording call is ``pend`` -- a bound ``deque.append`` (appends are
  atomic under the GIL), drained into the buckets lazily on the first
  read -- so recording a put latency costs well under a microsecond.
* ``MetricsRegistry`` hands out get-or-create metric handles keyed by
  ``(name, labels)``; ``NULL_REGISTRY`` is a no-op twin used to measure
  (and bound) instrumentation overhead.

Metric names are dotted (``lsm.puts``); labels are free-form string
pairs (``shard="3"``, ``op="put"``).  The README's port section has the
catalog of the names the port records.
"""

from __future__ import annotations

import collections
import math
import threading

# bucket width factor is 2**0.25: 4 buckets per doubling
_BUCKETS_PER_OCTAVE = 4
_M1, _M2, _M3 = 2.0 ** -0.75, 2.0 ** -0.5, 2.0 ** -0.25
ZERO_BUCKET = -(1 << 30)    # values <= 0 land here (reported as 0.0)


def bucket_index(v: float) -> int:
    """Index ``i`` such that ``2**(i/4) <= v < 2**((i+1)/4)``."""
    if v <= 0.0:
        return ZERO_BUCKET
    m, e = math.frexp(v)    # v = m * 2**e, m in [0.5, 1)
    return 4 * (e - 1) + (m >= _M1) + (m >= _M2) + (m >= _M3)


def bucket_hi(i: int) -> float:
    """Exclusive upper bound of bucket ``i``."""
    return 0.0 if i == ZERO_BUCKET else 2.0 ** ((i + 1) / _BUCKETS_PER_OCTAVE)


def bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket ``i`` (the percentile estimate)."""
    return 0.0 if i == ZERO_BUCKET else 2.0 ** ((i + 0.5) / _BUCKETS_PER_OCTAVE)


class _Metric:
    __slots__ = ("name", "labels", "help")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self.help = ""

    @property
    def key(self):
        return (self.name, tuple(sorted(self.labels.items())))


class Counter(_Metric):
    """Monotonic counter; ``inc``/``add`` are atomic (private lock)."""

    __slots__ = ("_lock", "_v")
    kind = "counter"

    def __init__(self, name: str, labels: dict[str, str]):
        super().__init__(name, labels)
        self._lock = threading.Lock()
        self._v = 0     # guarded-by: _lock

    def inc(self, n=1):
        with self._lock:
            self._v += n

    add = inc   # float-friendly alias (seconds accumulators)

    @property
    def value(self):
        with self._lock:
            return self._v


class Gauge(_Metric):
    """Last-value gauge (queue depths, compaction debt)."""

    __slots__ = ("_lock", "_v")
    kind = "gauge"

    def __init__(self, name: str, labels: dict[str, str]):
        super().__init__(name, labels)
        self._lock = threading.Lock()
        self._v = 0.0   # guarded-by: _lock

    def set(self, v):
        with self._lock:
            self._v = v

    def inc(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        with self._lock:
            return self._v


class Histogram(_Metric):
    """Log-bucketed distribution with mergeable percentile estimates.

    ``record(v)`` buckets immediately; ``pend(v)`` (the hot-path call) is
    a raw ``deque.append`` drained on the next read, so writers never
    take the histogram lock.
    """

    __slots__ = ("_lock", "_counts", "_count", "_sum", "_pending", "pend")
    kind = "histogram"

    def __init__(self, name: str, labels: dict[str, str]):
        super().__init__(name, labels)
        self._lock = threading.Lock()
        self._counts: dict[int, int] = {}             # guarded-by: _lock
        self._count = 0                               # guarded-by: _lock
        self._sum = 0.0                               # guarded-by: _lock
        # deliberately NOT lock-guarded: deque.append is GIL-atomic and
        # ``pend`` is the hot-path recording call (see module docstring)
        self._pending: collections.deque = collections.deque()
        self.pend = self._pending.append

    def record(self, v: float):
        with self._lock:
            self._record_locked(v)

    def _record_locked(self, v: float):
        i = bucket_index(v)
        self._counts[i] = self._counts.get(i, 0) + 1
        self._count += 1
        self._sum += max(v, 0.0)

    def _drain_locked(self):
        pend = self._pending
        for _ in range(len(pend)):
            try:
                v = pend.popleft()
            except IndexError:
                break
            self._record_locked(v)

    def merge(self, other: "Histogram"):
        """Absorb ``other``'s buckets (shard -> aggregate roll-up)."""
        counts, count, total = other.snapshot()
        with self._lock:
            self._drain_locked()
            for i, c in counts.items():
                self._counts[i] = self._counts.get(i, 0) + c
            self._count += count
            self._sum += total

    def snapshot(self) -> tuple[dict[int, int], int, float]:
        """(bucket counts, total count, value sum) -- a consistent copy."""
        with self._lock:
            self._drain_locked()
            return dict(self._counts), self._count, self._sum

    @property
    def count(self) -> int:
        return self.snapshot()[1]

    @property
    def sum(self) -> float:
        return self.snapshot()[2]

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (geometric bucket midpoint;
        nearest-rank, so it matches an exact percentile to within one
        bucket)."""
        counts, total, _ = self.snapshot()
        if total == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * total))
        cum = 0
        for i in sorted(counts):
            cum += counts[i]
            if cum >= rank:
                return bucket_mid(i)
        return bucket_mid(max(counts))   # unreachable

    def percentiles(self, qs=(50.0, 99.0, 99.9)) -> dict[float, float]:
        return {q: self.percentile(q) for q in qs}


def merge_histograms(hists) -> Histogram:
    """Fresh (unregistered) histogram holding the union of ``hists`` --
    bucket-wise sums, so aggregate percentiles equal what one histogram
    over the combined stream would report."""
    out = Histogram("merged", {})
    for h in hists:
        out.merge(h)
    return out


class MetricsRegistry:
    """Get-or-create metric handles keyed by (name, sorted labels)."""

    null = False
    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Metric] = {}      # guarded-by: _lock

    def _get(self, cls, name: str, labels: dict[str, str]):
        help_text = labels.pop("help", "")   # reserved, not a label
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels)
                self._metrics[key] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r}{labels} already registered as "
                    f"{m.kind}, requested {cls.kind}")
            if help_text and not m.help:
                m.help = help_text
            return m

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create; ``help=`` is reserved for the description
        (surfaced as the Prometheus ``# HELP`` line), everything else
        is a label."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def find(self, name: str, **labels):
        """The registered metric, or None (exact label match when labels
        are given, else all metrics sharing ``name``)."""
        if labels:
            key = (name, tuple(sorted(labels.items())))
            with self._lock:
                return self._metrics.get(key)
        return [m for m in self.metrics() if m.name == name]

    def snapshot(self) -> dict:
        """JSON-ready snapshot of every metric (histograms include
        count/sum/p50/p99/p99.9 and raw buckets)."""
        out: dict = {"counters": [], "gauges": [], "histograms": []}
        for m in self.metrics():
            entry: dict = {"name": m.name, "labels": m.labels}
            if isinstance(m, Histogram):
                counts, count, total = m.snapshot()
                pct = m.percentiles()
                entry.update(
                    count=count, sum=total,
                    p50=pct[50.0], p99=pct[99.0], p999=pct[99.9],
                    buckets={str(i): c for i, c in sorted(counts.items())})
                out["histograms"].append(entry)
            elif isinstance(m, Gauge):
                entry["value"] = m.value
                out["gauges"].append(entry)
            else:
                entry["value"] = m.value
                out["counters"].append(entry)
        for k in out:
            out[k].sort(key=lambda e: (e["name"], sorted(e["labels"].items())))
        return out


class _NullMetric:
    """Shared no-op metric: every mutator is a cheap bound no-op."""

    name = "null"
    labels: dict[str, str] = {}
    kind = "null"
    value = 0
    count = 0
    sum = 0.0

    def _nop(self, *a, **k):
        return None

    inc = add = set = record = pend = _nop

    def merge(self, other):
        return None

    def snapshot(self):
        return ({}, 0, 0.0)

    def percentile(self, q):
        return 0.0

    def percentiles(self, qs=(50.0, 99.0, 99.9)):
        return {q: 0.0 for q in qs}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """No-op registry: the baseline for instrumentation-overhead checks
    (and the default for callers that opt out of metrics)."""

    null = True

    def counter(self, name: str, **labels):
        return _NULL_METRIC

    gauge = counter
    histogram = counter

    def metrics(self):
        return []

    def find(self, name: str, **labels):
        return None if labels else []

    def snapshot(self):
        return {"counters": [], "gauges": [], "histograms": []}


NULL_REGISTRY = NullRegistry()

