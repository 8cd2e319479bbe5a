"""One device's peak memory over a traced step (the port's counterpart of
``compiled.memory_analysis()`` in the JAX package's dry run).

``PeakMemory`` is a dispatch mode over the ops one device runs
(``counts.LocalOps``: a DTensor's local shards, not its global shape) that
holds a weak reference to every storage an op makes and counts its bytes
live until the storage is freed; the arguments, handed over by
:meth:`PeakMemory.hold` before the step, are live from the start.  Run on
fake tensors it needs no memory of the device's.

What it cannot see: a hand-written kernel's own workspace (allocated inside
its operator, below the dispatcher), the caching allocator's rounding of
each block, and any buffer a library allocates for itself (cuBLAS, NCCL).
"""

from __future__ import annotations

import weakref

from repro_torch.roofline.counts import LocalOps, returns_alias, tensors


class PeakMemory(LocalOps):
    """Live and peak bytes of the storages the ``with`` block's ops make,
    plus the storages given to :meth:`hold`."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._refs: dict[int, weakref.ref] = {}
        self._args: set[int] = set()

    def _track(self, t) -> int:
        """Count ``t``'s storage live (once; a ``meta`` tensor, a shape
        with no memory, never); returns the bytes added."""
        if t.device.type == "meta":
            return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs and self._refs[key]() is not None:
            return 0
        size = st.nbytes()

        def freed(_, key=key, size=size):
            self.live -= size
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)
        self.live += size
        self.peak = max(self.peak, self.live)
        return size

    def hold(self, tree) -> None:
        """Count the tensors of ``tree`` (a DTensor as its local shard) as
        the step's arguments, live from now on."""
        for t in tensors(tree):
            self.argument_bytes += self._track(t)
            self._args.add(t.untyped_storage()._cdata)

    def on_op(self, func, args, kwargs, out) -> None:
        if returns_alias(func):
            return
        for t in tensors(out):
            self._track(t)

    def analysis(self, result) -> dict:
        """``compiled.memory_analysis()``'s fields for a step that returned
        ``result``: its arguments, its outputs (the result's storages that
        are not arguments), the rest of the peak as temporaries, and no
        aliases (the port donates no argument)."""
        outputs = {}
        for t in tensors(result):
            st = t.untyped_storage()
            if st._cdata not in self._args:
                outputs[st._cdata] = st.nbytes()
        out_bytes = sum(outputs.values())
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": max(self.peak - self.argument_bytes
                                  - out_bytes, 0),
                "alias_bytes": 0,
                "peak_bytes": self.peak}
