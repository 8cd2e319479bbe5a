"""Structured tracer: span + counter events, Chrome/Perfetto export (the
port's copy of ``repro.obs.trace``, writing the same layout).

``Tracer`` records three event kinds into a bounded ring buffer:

* **complete spans** (``ph="X"``): name, monotonic begin, duration,
  thread id, optional args -- ``with tracer.span("flush.build"): ...``
  or, on hot paths that already hold timestamps, the lower-level
  ``tracer.complete(name, t0_ns, dur_ns)``;
* **counter samples** (``ph="C"``): gauge values sampled on transitions
  (immutable-queue depth, compaction debt, compaction-queue depth) --
  Perfetto renders them as stepped counter tracks;
* **instants** (``ph="i"``): point markers.

``tracer.export(path)`` writes Chrome ``trace_event`` JSON that loads
directly in https://ui.perfetto.dev (or chrome://tracing).  Timestamps
are normalized to the first event; thread ids are renumbered densely and
named via metadata events, so traces diff cleanly.

``NULL_TRACER`` is the default everywhere: ``enabled`` is False and
every method is a no-op, so untraced runs pay only an attribute check.
"""

from __future__ import annotations

import collections
import json
import threading
import time


class _Span:
    """Context manager recording one complete event on exit."""

    __slots__ = ("_tr", "_name", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, args):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = self._tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tr
        tr._events.append(("X", self._name, self._t0,
                           tr._clock() - self._t0,
                           threading.get_ident(), self._args))
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded in-memory trace recorder (thread-safe: the ring buffer is
    a ``deque`` with atomic appends)."""

    enabled = True

    def __init__(self, maxlen: int = 1_000_000, clock=time.perf_counter_ns):
        self._clock = clock
        self._events: collections.deque = collections.deque(maxlen=maxlen)

    def now(self) -> int:
        """Current trace clock (ns) -- pair with ``complete``."""
        return self._clock()

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("flush.build", level=0): ...``"""
        return _Span(self, name, args or None)

    def complete(self, name: str, t0_ns: int, dur_ns: int,
                 args: dict | None = None, tid: int | None = None):
        """Record a finished span from explicit timestamps (hot paths)."""
        self._events.append(
            ("X", name, t0_ns, max(dur_ns, 0),
             threading.get_ident() if tid is None else tid, args))

    def instant(self, name: str, args: dict | None = None):
        self._events.append(
            ("i", name, self._clock(), 0, threading.get_ident(), args))

    def counter(self, name: str, value, args: dict | None = None):
        """Sample a gauge value onto a Perfetto counter track."""
        self._events.append(
            ("C", name, self._clock(), 0, threading.get_ident(),
             {"value": value, **(args or {})}))

    def __len__(self) -> int:
        return len(self._events)

    def clear(self):
        self._events.clear()

    # ------------------------------------------------------------ export

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object (Perfetto-loadable)."""
        events = list(self._events)
        if not events:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        t0 = min(e[2] for e in events)
        tids: dict[int, int] = {}
        names = {t.ident: t.name for t in threading.enumerate()}
        out = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                "args": {"name": "repro-lsm"}}]
        meta_at = len(out)
        for ph, name, ts, dur, tid, args in events:
            t = tids.setdefault(tid, len(tids))
            ev = {"ph": ph, "name": name, "cat": "lsm",
                  "ts": (ts - t0) / 1000.0, "pid": 1, "tid": t}
            if ph == "X":
                ev["dur"] = dur / 1000.0
            if ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        meta = []
        for ident, t in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                         "tid": t,
                         "args": {"name": names.get(ident, f"thread-{t}")}})
        out[meta_at:meta_at] = meta
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str):
        """Write the trace as Perfetto-loadable JSON."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")


class NullTracer:
    """Disabled tracer: ``enabled`` is False, every call is a no-op."""

    enabled = False

    def now(self) -> int:
        return 0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name, t0_ns, dur_ns, args=None, tid=None):
        return None

    def instant(self, name, args=None):
        return None

    def counter(self, name, value, args=None):
        return None

    def __len__(self) -> int:
        return 0

    def clear(self):
        return None

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()
