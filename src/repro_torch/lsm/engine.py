"""The port's compaction engine, and the host numpy helpers the SST reader
needs.

``TorchCompactionEngine`` is the counterpart of
``repro.lsm.cpu_engine.DeviceCompactionEngine``: it stages SST images on
its device, pads them exactly as the JAX engine does (each input run to a
power-of-two block count, the total to a power-of-two bucket, a flush to
a power-of-two block count), runs the pipeline through
``CompactionExecutor`` and brings the output image back to the host.  The
padding decides the output image's size, so the same padding is what
makes the SST files byte-identical to the JAX store's.  There is no retry
and no CPU engine behind it: a failed launch raises.  (The numpy CPU
baseline, ``cpu_engine.CpuCompactionEngine``, runs only where a store's
config names it.)

On the card, ``device_seconds`` and ``sort_seconds`` are CUDA-event times
around the pipeline and around phase 2; on the CPU they stay 0.0.
"""

from __future__ import annotations

import binascii
import dataclasses
import time

import numpy as np

from repro_torch.core import formats, offload
from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.device import DeviceTimer, resolve_device

U32 = np.uint32


# ---------------------------------------------------------------------------
# numpy mirrors of the kernel math (the host read path)
# ---------------------------------------------------------------------------


def np_u32_to_bytes(words: np.ndarray) -> np.ndarray:
    shifts = (8 * (3 - np.arange(4, dtype=np.uint32))).astype(np.uint32)
    b = (words[..., None] >> shifts) & U32(0xFF)
    return b.reshape(*words.shape[:-1], words.shape[-1] * 4).astype(np.uint8)


def np_bytes_to_u32(b: np.ndarray) -> np.ndarray:
    L = b.shape[-1] // 4
    b4 = b.reshape(*b.shape[:-1], L, 4).astype(np.uint32)
    shifts = (8 * (3 - np.arange(4, dtype=np.uint32))).astype(np.uint32)
    return (b4 << shifts).sum(-1).astype(np.uint32)


def np_prefix_decode(shared: np.ndarray, keys_raw: np.ndarray,
                     restart_interval: int) -> np.ndarray:
    """Vectorized across restart intervals: the serial chain is only
    ``restart_interval`` steps deep."""
    kb = np_u32_to_bytes(keys_raw).copy()
    n, B = kb.shape
    r = restart_interval
    pad = (-n) % r
    if pad:
        kb = np.concatenate([kb, np.zeros((pad, B), kb.dtype)])
        shared = np.concatenate([shared, np.zeros(pad, shared.dtype)])
    ki = kb.reshape(-1, r, B)
    sh = shared.reshape(-1, r)
    pos = np.arange(B)[None, :]
    for t in range(1, r):
        m = pos < sh[:, t, None]
        ki[:, t] = np.where(m, ki[:, t - 1], ki[:, t])
    return np_bytes_to_u32(ki.reshape(-1, B)[:n])


def np_crc_blocks(words: np.ndarray) -> np.ndarray:
    """binascii CRC per row of the little-endian word serialization."""
    return np.array([binascii.crc32(row.astype("<u4").tobytes()) & 0xFFFFFFFF
                     for row in words], dtype=np.uint32)


def _np_mix32(h):
    h = h ^ (h >> U32(16))
    h = (h * U32(0x85EBCA6B)).astype(U32)
    h = h ^ (h >> U32(13))
    h = (h * U32(0xC2B2AE35)).astype(U32)
    return h ^ (h >> U32(16))


def np_bloom_hashes(keys: np.ndarray):
    keys = keys.astype(U32)
    h1 = np.full(keys.shape[:-1], 2166136261, U32)
    h2 = np.full(keys.shape[:-1], 2166136261 ^ 0xDEADBEEF, U32)
    for lane in range(keys.shape[-1]):
        h1 = ((h1 ^ keys[..., lane]) * U32(16777619)).astype(U32)
        h2 = ((h2 ^ U32(0x9E3779B9) ^ keys[..., lane]) *
              U32(16777619)).astype(U32)
    return _np_mix32(h1), _np_mix32(h2) | U32(1)


def np_bloom_query(filters: np.ndarray, keys: np.ndarray,
                   n_probes: int) -> np.ndarray:
    h1, h2 = np_bloom_hashes(keys)
    m_bits = U32(filters.shape[-1] * 32)
    ok = np.ones(h1.shape, bool)
    for i in range(n_probes):
        pos = (h1 + U32(i) * h2) % m_bits
        word = np.take_along_axis(filters, (pos >> 5).astype(np.int64),
                                  axis=-1)
        ok &= ((word >> (pos & U32(31))) & 1).astype(bool)
    return ok


def np_wire_words(img: SSTImage) -> np.ndarray:
    b, k, lanes = img.keys.shape
    vw = img.vals.shape[-1]
    return np.concatenate([
        np.asarray(img.nvalid, U32)[:, None],
        np.asarray(img.keys, U32).reshape(b, k * lanes),
        np.asarray(img.meta, U32),
        np.asarray(img.vals, U32).reshape(b, k * vw),
        np.asarray(img.shared).astype(U32),
    ], axis=-1)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineStats:
    """Per-job compaction accounting.  ``device_seconds`` and
    ``sort_seconds`` (phase 2, inside ``device_seconds``) are CUDA-event
    times; ``host_seconds`` is the rest of the job's wall time (file
    reads, staging, read-back)."""
    n_input: int = 0
    n_live: int = 0
    n_dropped: int = 0
    crc_ok: bool = True
    bytes_in: int = 0
    bytes_out: int = 0
    host_seconds: float = 0.0
    device_seconds: float = 0.0
    sort_seconds: float = 0.0


class TorchCompactionEngine:
    """The LUDA path on PyTorch: flushes and compactions on ``device``
    (None: ``cuda``, which must be present).

    On the card, images cross between host and device through pinned
    staging buffers that the engine owns (``formats.PinnedStaging``), and
    ``compact_paths`` reads file *i + 1* on a ``PrefetchReader`` thread
    while image *i* is staged.  ``close()`` stops the reader and releases
    the buffers."""

    name = "torch"

    def __init__(self, geom: SSTGeometry, device=None,
                 sort_mode: str = "merge"):
        self.geom = geom
        self.device = resolve_device(device)
        self.executor = offload.CompactionExecutor(
            geom, device=self.device, sort_mode=sort_mode)
        self.staging = (formats.PinnedStaging(self.device)
                        if self.device.type == "cuda" else None)
        self._reader = None   # a PrefetchReader, built at the first job

    def close(self):
        """Stop the file reader's thread and release the pinned buffers."""
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        if self.staging is not None:
            self.staging.close()

    def compact(self, images: list[SSTImage], *, bottom_level: bool = False
                ) -> tuple[SSTImage, EngineStats]:
        """Compact host images (numpy); returns a host image."""
        t0 = time.perf_counter()
        imgs = [formats.image_from_numpy(im, self.device, self.staging)
                for im in images]
        real = sum(np.asarray(im.keys).shape[0] for im in images)
        return self._compact_staged(imgs, real, bottom_level=bottom_level,
                                    t0=t0)

    def compact_paths(self, paths: list[str], *, bottom_level: bool = False
                      ) -> tuple[SSTImage, EngineStats]:
        """Compact straight from SST files, double-buffering the reads:
        while image *i* is staged, the reader thread reads file *i + 1*."""
        from repro_torch.core.background import PrefetchReader
        from repro_torch.lsm import sstable
        t0 = time.perf_counter()
        if self._reader is None:
            self._reader = PrefetchReader()
        imgs, real = [], 0
        for im in self._reader.read_all(paths, sstable.read_sst):
            real += im.keys.shape[0]
            imgs.append(formats.image_from_numpy(im, self.device,
                                                 self.staging))
        return self._compact_staged(imgs, real, bottom_level=bottom_level,
                                    t0=t0)

    def _compact_staged(self, imgs, real_blocks, *, bottom_level, t0):
        if self.executor.sort_mode == "merge":
            # each run to a pow2 block count, as the JAX engine pads
            imgs = [offload.pad_image_blocks(
                im, offload.next_pow2(im.keys.shape[0]), self.geom)
                for im in imgs]
        bucket = offload.next_pow2(sum(im.keys.shape[0] for im in imgs))
        timer = DeviceTimer(self.device)
        t_exec = time.perf_counter()
        with timer.span("pipeline"):
            out, s = self.executor.compact(imgs, bottom_level=bottom_level,
                                           pad_blocks=bucket, timer=timer)
        out = formats.image_to_numpy(out, self.staging)
        exec_wall = time.perf_counter() - t_exec
        wire = self.geom.wire_words_per_block * 4
        stats = EngineStats(
            n_input=s.n_input, n_live=s.n_live, n_dropped=s.n_dropped,
            crc_ok=s.crc_ok, bytes_in=real_blocks * wire,
            bytes_out=s.bytes_out)
        stats.device_seconds = timer.seconds("pipeline")
        stats.sort_seconds = timer.seconds("sort")
        stats.host_seconds = max(time.perf_counter() - t0 - exec_wall, 0.0)
        return out, stats

    def build_image(self, keys, meta, vals) -> SSTImage:
        """Pack sorted host entries into a host image (the flush), padded
        to a power-of-two block count as the JAX engine pads it."""
        keys = np.asarray(keys, U32)
        n = keys.shape[0]
        k = self.geom.block_kvs
        n_pad = offload.next_pow2(max(1, -(-n // k))) * k
        pad = n_pad - n
        keys = np.pad(keys, ((0, pad), (0, 0)))
        meta = np.pad(np.asarray(meta, U32), (0, pad))
        vals = np.pad(np.asarray(vals, U32), ((0, pad), (0, 0)))
        img = offload.build_image(
            *formats.words_to_tensors([keys, meta, vals], self.device,
                                      staging=self.staging),
            n, geom=self.geom)
        return formats.image_to_numpy(img, self.staging)
