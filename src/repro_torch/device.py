"""Device selection and device-side timing for the port's entry points.

The port runs on the card unless the caller asks for the CPU: an entry
point given no device takes ``cuda``, and raises when CUDA is absent.
"""

from __future__ import annotations

import contextlib

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
    times that thread's stream).  On the CPU it records nothing and every
    span reads 0.0: a CPU run has no device time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.enabled = device.type == "cuda"
        self._spans: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
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

    def seconds(self, name: str) -> float:
        """Summed device seconds of the spans called ``name`` (waits for
        their end events)."""
        total = 0.0
        for start, end in self._spans.get(name, ()):
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        return total
