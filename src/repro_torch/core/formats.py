"""SST image format over tensors (the port of ``repro.core.formats``).

An SST image is a struct-of-arrays over data blocks:

* ``keys``   ``[blocks, block_kvs, key_lanes]``   prefix-zeroed key lanes
* ``meta``   ``[blocks, block_kvs]``              ``seq << 1 | is_value``
* ``vals``   ``[blocks, block_kvs, value_words]`` value slots
* ``shared`` ``[blocks, block_kvs]``              shared-prefix bytes
* ``nvalid`` ``[blocks]``                         live entries per block
* ``crc``    ``[blocks]``                         CRC-32 per block
* ``bloom``  ``[filter_groups, bloom_words]``     filter block(s)

On a device every field is an ``int32`` tensor holding uint32 bit patterns
(torch's ``uint32`` lacks the arithmetic the pipeline needs).  On the host
the same ``SSTImage`` holds numpy arrays with the JAX package's dtypes
(uint32, except ``shared`` and ``nvalid`` in int32), which is what the SST
files store; :func:`image_from_numpy` and :func:`image_to_numpy` cross
between the two.

Keys are big-endian packed so lexicographic unsigned lane order equals
byte order.  The all-ones key is reserved as the padding sentinel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# zero_prefix_lanes lives with the plain version of the pack's prefix step
# (ref.prefix_encode_wire), and is this module's public name as in JAX
from repro_torch.kernels.ref import MASK32, zero_prefix_lanes  # noqa: F401


@dataclasses.dataclass(frozen=True)
class SSTGeometry:
    """Static geometry shared by every SST in a store (paper defaults:
    16 B keys, 4 KB data blocks, 4 MB SSTs, 10 bloom bits/key)."""
    key_bytes: int = 16
    value_bytes: int = 256
    block_bytes: int = 4096
    sst_bytes: int = 4 * 1024 * 1024
    restart_interval: int = 16
    bloom_bits_per_key: int = 10
    bloom_granularity: str = "block"  # "block" | "sst"

    def __post_init__(self):
        if self.key_bytes % 4 or self.value_bytes % 4:
            raise ValueError("key_bytes and value_bytes must be multiples "
                             "of 4")

    @property
    def key_lanes(self) -> int:
        return self.key_bytes // 4

    @property
    def value_words(self) -> int:
        return self.value_bytes // 4

    @property
    def entry_bytes(self) -> int:
        # key + meta word + value slot + shared word
        return self.key_bytes + 4 + self.value_bytes + 4

    @property
    def block_kvs(self) -> int:
        n = self.block_bytes // self.entry_bytes
        # multiple of the restart interval so blocks start at restart points
        return max(self.restart_interval,
                   n // self.restart_interval * self.restart_interval)

    @property
    def blocks_per_sst(self) -> int:
        return max(1, self.sst_bytes // self.block_bytes)

    @property
    def sst_kvs(self) -> int:
        return self.block_kvs * self.blocks_per_sst

    @property
    def bloom_probes(self) -> int:
        # LevelDB: k = bits_per_key * ln2, capped
        return max(1, min(30, int(self.bloom_bits_per_key * 0.69)))

    def bloom_words(self, keys_per_group: int) -> int:
        bits = max(64, keys_per_group * self.bloom_bits_per_key)
        return (bits + 31) // 32

    @property
    def wire_words_per_block(self) -> int:
        """uint32 words per block covered by the CRC (header + payload)."""
        k = self.block_kvs
        return 1 + k * self.key_lanes + k + k * self.value_words + k


class SSTImage(NamedTuple):
    """Struct-of-arrays image of one or more SSTs (see module doc)."""
    keys: torch.Tensor
    meta: torch.Tensor
    vals: torch.Tensor
    shared: torch.Tensor
    nvalid: torch.Tensor
    crc: torch.Tensor
    bloom: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.keys.shape[0]

    @property
    def n_entries(self) -> int:
        return self.keys.shape[0] * self.keys.shape[1]


# numpy dtypes of the host image fields (the SST file's)
HOST_DTYPES = SSTImage(keys=np.uint32, meta=np.uint32, vals=np.uint32,
                       shared=np.int32, nvalid=np.int32, crc=np.uint32,
                       bloom=np.uint32)


# the meta word's low bit: a value, or a delete (a tombstone)
VALUE_TYPE = 1
DELETE_TYPE = 0


def make_meta(seq: int, is_value: int) -> int:
    return ((seq << 1) | is_value) & MASK32


def meta_is_value(meta: torch.Tensor) -> torch.Tensor:
    return (meta & 1) == 1


def wire_sections(img: SSTImage) -> list[torch.Tensor]:
    """Each block's CRC-covered serialization as five per-block sections
    (nvalid, keys, meta, vals, shared), which the sectioned CRC consumes
    without a concatenated copy."""
    b, k, lanes = img.keys.shape
    vw = img.vals.shape[-1]
    return [img.nvalid[:, None], img.keys.reshape(b, k * lanes), img.meta,
            img.vals.reshape(b, k * vw), img.shared]


def concat_images(images: list[SSTImage], *, with_runs: bool = False):
    """Concatenate images along the block axis (the compaction input).
    ``with_runs=True`` also returns each input's entry count: every input
    SST is a sorted run, which the merge phase needs."""
    img = SSTImage(*(torch.cat(parts, dim=0) for parts in zip(*images)))
    if with_runs:
        return img, tuple(im.keys.shape[0] * im.keys.shape[1]
                          for im in images)
    return img


def entry_validity(img: SSTImage) -> torch.Tensor:
    """bool ``[B, K]``: which slots hold live entries."""
    k = img.keys.shape[1]
    return torch.arange(k, device=img.keys.device)[None, :] < \
        img.nvalid[:, None]


def wire_words(img: SSTImage) -> torch.Tensor:
    """Each block's CRC-covered word row ``[blocks,
    wire_words_per_block]``: the concatenation of ``wire_sections``."""
    return torch.cat(wire_sections(img), dim=1)


def meta_seq(meta: torch.Tensor) -> torch.Tensor:
    """The sequence numbers of ``meta`` words (a logical shift of the
    uint32 bit patterns)."""
    return (meta >> 1) & 0x7FFFFFFF


class PinnedStaging:
    """Page-locked host buffers for the copies between host images and
    the card, reused across calls: one buffer per power-of-two byte
    bucket, allocated at first use.

    ``to_device`` packs several host arrays into one buffer and moves them
    with one non-blocking copy on the current stream, which orders the
    work that reads them after it.  ``to_host`` copies tensors back on the
    current stream too, after the work that made them, waits for the
    copies, then hands back owned numpy arrays, never views of a buffer
    that the next call overwrites.  Each buffer keeps the event of the
    last copy that read it, and the host waits on that event before
    writing the buffer again.  ``close`` releases the buffers; the next
    call allocates anew.

    No copy goes through a stream of PyTorch's pool (``torch.cuda.Stream``
    hands the same few CUDA streams out round-robin): an async store's
    worker calls here while the serving engine may be capturing a CUDA
    graph on a pool stream in another thread, and a wait put into the
    capturing stream from here would break that capture.
    """

    MIN_BYTES = 1 << 16

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: dict[int, torch.Tensor] = {}
        self._pending: dict[int, torch.cuda.Event] = {}

    def _take(self, words: int) -> tuple[int, torch.Tensor]:
        nbytes = max(self.MIN_BYTES, 1 << max(0, 4 * words - 1).bit_length())
        ev = self._pending.pop(nbytes, None)
        if ev is not None:
            ev.synchronize()
        buf = self._bufs.get(nbytes)
        if buf is None:
            buf = self._bufs[nbytes] = torch.empty(
                nbytes // 4, dtype=torch.int32, pin_memory=True)
        return nbytes, buf

    def to_device(self, arrays: list[np.ndarray]) -> list[torch.Tensor]:
        """int32 host arrays as int32 tensors on the card (views of one
        device buffer, in the arrays' shapes)."""
        nbytes, buf = self._take(sum(a.size for a in arrays))
        host = buf.numpy()
        off = 0
        for a in arrays:
            host[off:off + a.size] = a.reshape(-1)
            off += a.size
        flat = buf[:off].to(self.device, non_blocking=True)
        self._pending[nbytes] = \
            torch.cuda.current_stream(self.device).record_event()
        out, off = [], 0
        for a in arrays:
            out.append(flat[off:off + a.size].view(a.shape))
            off += a.size
        return out

    def to_host(self, tensors: list[torch.Tensor]) -> list[np.ndarray]:
        """int32 tensors on the card as owned int32 numpy arrays."""
        nbytes, buf = self._take(sum(t.numel() for t in tensors))
        off = 0
        for t in tensors:
            buf[off:off + t.numel()].view(t.shape).copy_(t, non_blocking=True)
            off += t.numel()
        torch.cuda.current_stream(self.device).record_event().synchronize()
        host = buf.numpy()
        out, off = [], 0
        for t in tensors:
            out.append(host[off:off + t.numel()].reshape(t.shape).copy())
            off += t.numel()
        return out

    def close(self):
        """Wait for the copies in flight and release the buffers."""
        for ev in self._pending.values():
            ev.synchronize()
        self._pending.clear()
        self._bufs.clear()


def words_to_tensors(arrays, device, dtypes=None,
                     staging: PinnedStaging | None = None
                     ) -> list[torch.Tensor]:
    """Host arrays of 32-bit words (each read as its ``dtypes`` entry,
    default uint32) as int32 bit-pattern tensors on ``device``; through
    ``staging``'s pinned buffer in one copy when it is given and
    ``device`` is the card."""
    dtypes = dtypes or [np.uint32] * len(arrays)
    words = [np.asarray(a).astype(dt, copy=False).view(np.int32)
             for a, dt in zip(arrays, dtypes)]
    if staging is not None and torch.device(device).type == "cuda":
        return staging.to_device(words)
    return [torch.from_numpy(np.array(w)).to(device) for w in words]


def words_to_tensor(a, device, dtype=np.uint32,
                    staging: PinnedStaging | None = None) -> torch.Tensor:
    """A host array of 32-bit words (read as ``dtype``) as an int32
    bit-pattern tensor on ``device``."""
    return words_to_tensors([a], device, [dtype], staging)[0]


def image_from_numpy(img, device,
                     staging: PinnedStaging | None = None) -> SSTImage:
    """A host image (numpy arrays: the port's or ``repro``'s ``SSTImage``)
    as int32 tensors on ``device``."""
    return SSTImage(*words_to_tensors(list(img), device, list(HOST_DTYPES),
                                      staging))


def image_to_numpy(img: SSTImage,
                   staging: PinnedStaging | None = None) -> SSTImage:
    """A device image as numpy arrays with the SST file's dtypes."""
    return images_to_numpy([img], staging)[0]


def images_to_numpy(images: list[SSTImage],
                    staging: PinnedStaging | None = None) -> list[SSTImage]:
    """Device images as host images (:func:`image_to_numpy`), through one
    copy back for all of them when ``staging`` is given on the card."""
    tensors = [t for img in images for t in img]
    if staging is not None and tensors and tensors[0].device.type == "cuda":
        words = staging.to_host(tensors)
    else:
        words = [t.detach().cpu().numpy() for t in tensors]
    n = len(HOST_DTYPES)
    return [SSTImage(*(w.view(dt) for w, dt in zip(words[i:i + n],
                                                   HOST_DTYPES)))
            for i in range(0, len(words), n)]


# ---------------------------------------------------------------------------
# Host-side helpers (numpy; the store's key/value packing)
# ---------------------------------------------------------------------------


def pack_key_bytes(key: bytes, key_bytes: int) -> np.ndarray:
    """Pack a user key (<= key_bytes, zero padded) into big-endian uint32
    lanes so lane order equals byte order.  Keys may not end with NUL:
    the zero padding is only reversible under that rule."""
    if len(key) > key_bytes:
        raise ValueError("key too long for geometry")
    if key.endswith(b"\x00"):
        raise ValueError("keys must not end with NUL")
    raw = key.ljust(key_bytes, b"\x00")
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32)


def unpack_key_bytes(lanes: np.ndarray) -> bytes:
    return np.asarray(lanes).astype(">u4").tobytes()


def pack_value_bytes(value: bytes, value_bytes: int) -> np.ndarray:
    """Length-prefixed value in fixed uint32 slots (little-endian words)."""
    if len(value) > value_bytes - 4:
        raise ValueError("value too long for geometry")
    raw = len(value).to_bytes(4, "little") + value
    raw = raw.ljust(value_bytes, b"\x00")
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32)


def unpack_value_bytes(words: np.ndarray) -> bytes:
    raw = np.asarray(words).astype("<u4").tobytes()
    n = int.from_bytes(raw[:4], "little")
    return raw[4:4 + n]
