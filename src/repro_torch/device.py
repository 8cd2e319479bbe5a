"""Device selection and device-side timing for the port's entry points.

The port runs on the card unless the caller asks for the CPU: an entry
point given no device takes ``cuda``, and raises when CUDA is absent.
"""

from __future__ import annotations

import contextlib
import time

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.  Raises
    when it names CUDA and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card unless the "
            "caller passes device='cpu'")
    return dev


class DeviceTimer:
    """Named spans timed by CUDA events on ``device``'s current stream
    (named when the events are recorded, so a timer built on one thread
    times that thread's stream).  On the CPU it records no event and every
    span reads 0.0: a CPU run has no device time.  Each span also keeps
    its host-clock bounds, which ``phases`` reads on the CPU, where the
    work runs synchronously."""

    def __init__(self, device: torch.device):
        self.device = device
        self.enabled = device.type == "cuda"
        self._spans: dict[str, list] = {}
        self._host: dict[str, list] = {}

    @property
    def clock(self) -> str:
        """What ``phases`` reads: ``"cuda_event"`` or ``"host"``."""
        return "cuda_event" if self.enabled else "host"

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        if not self.enabled:
            try:
                yield
            finally:
                self._host.setdefault(name, []).append(
                    (t0, time.perf_counter_ns()))
            return
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            self._spans.setdefault(name, []).append((start, end))
            self._host.setdefault(name, []).append(
                (t0, time.perf_counter_ns()))

    def seconds(self, name: str) -> float:
        """Summed device seconds of the spans called ``name`` (waits for
        their end events)."""
        total = 0.0
        for start, end in self._spans.get(name, ()):
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        return total

    def phases(self, outer: str, inner: str
               ) -> tuple[float, float, float] | None:
        """Seconds of the last ``outer`` span before the last ``inner``
        span, inside it, and after it, read from the events the two spans
        already recorded (none is added): on the card the times between
        their CUDA events, on the CPU between their host-clock bounds.
        None when either span is missing.  Waits for ``outer``'s end
        event."""
        if not (self._host.get(outer) and self._host.get(inner)):
            return None
        if not self.enabled:
            (o0, o1), (i0, i1) = self._host[outer][-1], self._host[inner][-1]
            return (i0 - o0) / 1e9, (i1 - i0) / 1e9, (o1 - i1) / 1e9
        (o0, o1), (i0, i1) = self._spans[outer][-1], self._spans[inner][-1]
        o1.synchronize()
        return (o0.elapsed_time(i0) / 1e3, i0.elapsed_time(i1) / 1e3,
                i1.elapsed_time(o1) / 1e3)
