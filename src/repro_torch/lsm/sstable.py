"""SST file I/O, the ``TableReader`` read protocol and the host caches (the
port of ``repro.lsm.sstable``, same bytes on disk).

The on-disk format is the raw dump of the wire image:

  magic "LUDASST1"
  u32 n_blocks, block_kvs, key_lanes, value_words, bloom_groups, bloom_words
  keys   uint32 LE [n_blocks, block_kvs, key_lanes]
  meta   uint32 LE [n_blocks, block_kvs]
  vals   uint32 LE [n_blocks, block_kvs, value_words]
  shared int32  LE [n_blocks, block_kvs]
  nvalid int32  LE [n_blocks]
  crc    uint32 LE [n_blocks]
  bloom  uint32 LE [bloom_groups, bloom_words]
  u32 file_crc  -- crc32 of everything before this field

Trailing all-zero blocks (``nvalid == 0``) are trimmed on write.
Failpoints: ``sst.write`` (a torn ``.tmp``), ``sst.rename`` (death
between the ``.tmp``'s fsync and its rename), ``cache.insert``.

``TableReader`` is the one decode entry point for point reads and scans:
the file loads on first touch (whole-file CRC verified), and blocks decode
on demand through a shared ``BlockCache``.  The store is synchronous, so
the caches hold no locks.
"""

from __future__ import annotations

import binascii
import bisect
import dataclasses
import os
import struct
import threading
from collections import OrderedDict

import numpy as np

from repro_torch.core import formats
from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.device import resolve_device
from repro_torch.lsm import DEFAULT_READ_OPTIONS, engine, faults
from repro_torch.lsm import read as lsm_read
from repro_torch.lsm.fs import fsync_dir

MAGIC = b"LUDASST1"
SENTINEL = np.uint32(0xFFFFFFFF)   # all-ones key: sorts after any real key


@dataclasses.dataclass
class FileMeta:
    file_no: int
    path: str
    smallest: bytes           # first live user key (trimmed)
    largest: bytes            # last live user key (trimmed)
    n_entries: int
    size_bytes: int

    def to_json(self):
        return dict(file_no=self.file_no, path=self.path,
                    smallest=self.smallest.hex(), largest=self.largest.hex(),
                    n_entries=self.n_entries, size_bytes=self.size_bytes)

    @classmethod
    def from_json(cls, d):
        return cls(file_no=d["file_no"], path=d["path"],
                   smallest=bytes.fromhex(d["smallest"]),
                   largest=bytes.fromhex(d["largest"]),
                   n_entries=d["n_entries"], size_bytes=d["size_bytes"])


def trim_image(img: SSTImage) -> SSTImage:
    """Drop trailing empty blocks (the compaction output's padding)."""
    img = SSTImage(*(np.asarray(a) for a in img))
    live = max(1, int((img.nvalid > 0).sum()))
    if img.bloom.shape[0] == img.keys.shape[0]:  # block-granularity blooms
        bloom = img.bloom[:live]
    else:
        bloom = img.bloom
    return SSTImage(keys=img.keys[:live], meta=img.meta[:live],
                    vals=img.vals[:live], shared=img.shared[:live],
                    nvalid=img.nvalid[:live], crc=img.crc[:live],
                    bloom=bloom)


def write_sst(path: str, img: SSTImage, file_no: int) -> FileMeta:
    img = trim_image(img)
    b, k, lanes = img.keys.shape
    vw = img.vals.shape[-1]
    g, w = img.bloom.shape
    header = MAGIC + struct.pack("<6I", b, k, lanes, vw, g, w)
    payload = b"".join([
        header,
        img.keys.astype("<u4").tobytes(),
        img.meta.astype("<u4").tobytes(),
        img.vals.astype("<u4").tobytes(),
        img.shared.astype("<i4").tobytes(),
        img.nvalid.astype("<i4").tobytes(),
        img.crc.astype("<u4").tobytes(),
        img.bloom.astype("<u4").tobytes(),
    ])
    payload += struct.pack("<I", binascii.crc32(payload) & 0xFFFFFFFF)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        if faults.fire("sst.write") is faults.TORN:
            f.write(payload[: max(1, len(payload) // 2)])
            f.flush()
            raise faults.SimulatedCrash("sst.write")
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    faults.fire("sst.rename")   # a crash here leaves a complete orphan .tmp
    os.replace(tmp, path)  # atomic install
    fsync_dir(os.path.dirname(path) or ".")

    smallest, largest, n_entries = image_bounds(img)
    return FileMeta(file_no=file_no, path=path,
                    smallest=smallest, largest=largest,
                    n_entries=n_entries, size_bytes=len(payload))


def image_bounds(img: SSTImage, restart_interval: int = 16):
    """(smallest_key, largest_key, n_entries) without a full decode: block
    starts are restart points, and ``largest`` decodes only the final
    restart interval."""
    nvalid = np.asarray(img.nvalid)
    keys = np.asarray(img.keys, np.uint32)
    n_entries = int(nvalid.sum())
    if n_entries == 0:
        return b"", b"", 0
    smallest = formats.unpack_key_bytes(keys[0, 0]).rstrip(b"\x00")
    b_last = int(np.nonzero(nvalid > 0)[0][-1])
    nv = int(nvalid[b_last])
    r = (nv - 1) // restart_interval * restart_interval
    seg = engine.np_prefix_decode(np.asarray(img.shared)[b_last, r:nv],
                                  keys[b_last, r:nv], restart_interval)
    largest = formats.unpack_key_bytes(seg[-1]).rstrip(b"\x00")
    return smallest, largest, n_entries


def read_sst(path: str) -> SSTImage:
    """A host image (numpy) of the file; raises on a checksum mismatch."""
    with open(path, "rb") as f:
        data = f.read()
    (want,) = struct.unpack_from("<I", data, len(data) - 4)
    if binascii.crc32(data[:-4]) & 0xFFFFFFFF != want:
        raise IOError(f"file checksum mismatch: {path}")
    if data[:8] != MAGIC:
        raise IOError(f"bad magic in {path}")
    b, k, lanes, vw, g, w = struct.unpack_from("<6I", data, 8)
    off = 8 + 24

    def take(shape, dt):
        nonlocal off
        count = int(np.prod(shape))
        arr = np.frombuffer(data, dtype=dt, count=count,
                            offset=off).reshape(shape)
        off += count * 4
        return arr

    keys = take((b, k, lanes), "<u4")
    meta = take((b, k), "<u4")
    vals = take((b, k, vw), "<u4")
    shared = take((b, k), "<i4")
    nvalid = take((b,), "<i4")
    crc = take((b,), "<u4")
    bloom = take((g, w), "<u4")
    return SSTImage(keys=keys, meta=meta, vals=vals, shared=shared,
                    nvalid=nvalid, crc=crc, bloom=bloom)


@dataclasses.dataclass
class DecodedBlock:
    """One decoded data block (the block-cache unit).  ``keys_u32`` rows at
    or beyond ``nvalid`` hold the all-ones sentinel; ``keys_packed`` is
    the big-endian byte view of the same rows, whose memcmp order equals
    the lane order."""
    keys_u32: np.ndarray      # uint32 [K, L]  full (prefix-restored) keys
    keys_packed: np.ndarray   # bytes  [K]
    meta: np.ndarray          # uint32 [K]     seq << 1 | is_value
    vals: np.ndarray          # uint32 [K, Vw]
    nvalid: int

    @property
    def nbytes(self) -> int:
        return (self.keys_u32.nbytes + self.keys_packed.nbytes +
                self.meta.nbytes + self.vals.nbytes)


class BlockCache:
    """Host LRU cache of ``DecodedBlock``s keyed ``(file_no, block)`` (file
    numbers are never reused); capacity in blocks, 0 disables it.
    Thread-safe: a sharded store's compaction worker drops files while the
    caller reads.  ``on_hit`` / ``on_miss`` are called on each lookup that
    finds a block or not (the store's ``lsm.block_cache_*`` counters)."""

    def __init__(self, capacity: int = 4096, *, on_hit=None, on_miss=None):
        self.capacity = capacity
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._c: OrderedDict[tuple[int, int], DecodedBlock] = OrderedDict()
        self._on_hit = on_hit
        self._on_miss = on_miss

    def get(self, file_no: int, block: int) -> DecodedBlock | None:
        with self._lock:
            blk = self._c.get((file_no, block))
            if blk is not None:
                self._c.move_to_end((file_no, block))
        hook = self._on_hit if blk is not None else self._on_miss
        if hook is not None:
            hook()
        return blk

    def put(self, file_no: int, block: int, blk: DecodedBlock):
        if self.capacity <= 0:
            return
        faults.fire("cache.insert")
        with self._lock:
            self._c[(file_no, block)] = blk
            while len(self._c) > self.capacity:
                self._c.popitem(last=False)

    def drop_file(self, file_no: int):
        with self._lock:
            for k in [k for k in self._c if k[0] == file_no]:
                del self._c[k]

    def __len__(self) -> int:
        with self._lock:
            return len(self._c)


def _pack_rows(keys_u32: np.ndarray) -> np.ndarray:
    be = np.ascontiguousarray(keys_u32.astype(">u4"))
    return be.view(f"S{4 * keys_u32.shape[-1]}").ravel()


class TableReader:
    """The single decode entry point for reads on one SST.  Constructing a
    reader touches nothing; the first read loads the file, and blocks
    decode on demand through the shared ``BlockCache``.  ``device`` is
    where ``multi_get``'s ``"device"`` backend stages (None: ``cuda``,
    which must then be present)."""

    def __init__(self, meta: FileMeta, geom: SSTGeometry, *,
                 block_cache: BlockCache | None = None, device=None):
        self.meta = meta
        self.geom = geom
        self.block_cache = block_cache
        self.device = device
        self._lock = threading.Lock()
        self._img: SSTImage | None = None             # guarded-by: _lock
        self._first_keys: list[bytes] | None = None   # guarded-by: _lock

    def _load(self) -> SSTImage:
        with self._lock:
            return self._load_locked()

    def _load_locked(self) -> SSTImage:
        if self._img is None:
            self._img = read_sst(self.meta.path)  # file CRC verified
        return self._img

    @property
    def first_keys(self) -> list[bytes]:
        """Per-block smallest user key (block starts are restart points,
        so row 0 of the raw lanes is the full key)."""
        with self._lock:
            if self._first_keys is None:
                keys = np.asarray(self._load_locked().keys, np.uint32)
                self._first_keys = [
                    formats.unpack_key_bytes(keys[b, 0]).rstrip(b"\x00")
                    for b in range(keys.shape[0])]
            return self._first_keys

    @property
    def n_blocks(self) -> int:
        return self._load().keys.shape[0]

    def candidate_block(self, key: bytes) -> int:
        """The one block that can hold ``key``: the rightmost block whose
        first key <= key."""
        return max(0, bisect.bisect_right(self.first_keys, key) - 1)

    def bloom_row(self, block: int) -> np.ndarray | None:
        """The filter row guarding ``block`` (None: no filters)."""
        bloom = np.asarray(self._load().bloom)
        if bloom.shape[0] == 0:
            return None
        return bloom[min(block, bloom.shape[0] - 1)]

    def block(self, b: int, *, fill_cache: bool = True,
              verify_crc: bool = False) -> DecodedBlock:
        """Block ``b``, decoded at most once while it stays cached."""
        blk = self.cached_block(b)
        if blk is not None:
            return blk
        return self.decode_block(b, fill_cache=fill_cache,
                                 verify_crc=verify_crc)

    def cached_block(self, b: int) -> DecodedBlock | None:
        if self.block_cache is None:
            return None
        return self.block_cache.get(self.meta.file_no, b)

    def decode_block(self, b: int, *, fill_cache: bool = True,
                     verify_crc: bool = False) -> DecodedBlock:
        img = self._load()
        keys_raw = np.asarray(img.keys, np.uint32)[b]
        shared = np.asarray(img.shared)[b]
        meta = np.asarray(img.meta, np.uint32)[b]
        vals = np.asarray(img.vals, np.uint32)[b]
        nv = int(np.asarray(img.nvalid)[b])
        if verify_crc:
            block = SSTImage(*(np.asarray(a)[b:b + 1] for a in img))
            wire = engine.np_wire_words(block)
            if int(engine.np_crc_blocks(wire)[0]) != int(block.crc[0]):
                raise IOError(f"SST block checksum mismatch: "
                              f"{self.meta.path} block {b}")
        keys = engine.np_prefix_decode(shared, keys_raw,
                                       self.geom.restart_interval).copy()
        keys[nv:] = SENTINEL
        blk = DecodedBlock(keys_u32=keys, keys_packed=_pack_rows(keys),
                           meta=meta, vals=vals, nvalid=nv)
        if self.block_cache is not None and fill_cache:
            self.block_cache.put(self.meta.file_no, b, blk)
        return blk

    def probe(self, key: bytes, opts=None
              ) -> tuple[bool, bytes | None, bool]:
        """``(found, value|None, bloom_pruned)``: ``found=True,
        value=None`` means a tombstone shadows the key.  Searching
        ``keys_packed`` with the plain key is exact: numpy ``S``
        comparisons zero-pad to the item width, which is the fixed-width
        packing, and keys never end with NUL."""
        opts = opts or DEFAULT_READ_OPTIONS
        if not (self.meta.smallest <= key <= self.meta.largest):
            return False, None, False
        b = self.candidate_block(key)
        blk = self.cached_block(b)
        if blk is None:
            # probe the filter only when the block is not decoded yet
            row = self.bloom_row(b)
            if row is not None:
                lanes = formats.pack_key_bytes(key, self.geom.key_bytes)
                hit = engine.np_bloom_query(row[None], lanes[None, None, :],
                                            self.geom.bloom_probes)
                if not bool(hit[0, 0]):
                    return False, None, True
            blk = self.decode_block(b, fill_cache=opts.fill_cache,
                                    verify_crc=opts.verify_crc)
        i = int(np.searchsorted(blk.keys_packed, key))
        if i >= blk.nvalid or blk.keys_packed[i] != key:
            return False, None, False
        if not (int(blk.meta[i]) & 1):
            return True, None, False          # tombstone
        return True, formats.unpack_value_bytes(blk.vals[i]), False

    def get(self, key: bytes, opts=None) -> bytes | None:
        _, value, _ = self.probe(key, opts)
        return value

    def multi_get(self, keys, opts=None) -> list[bytes | None]:
        """Batched ``get`` over this one table: one stacked bloom prune,
        then one stacked search and gather (see ``lsm.read``)."""
        opts = opts or DEFAULT_READ_OPTIONS
        keys = list(keys)
        out: list[bytes | None] = [None] * len(keys)
        cands = [lsm_read.Candidate(slot=i, rank=0, reader=self, key=k)
                 for i, k in enumerate(keys)
                 if self.meta.smallest <= k <= self.meta.largest]
        device = resolve_device(self.device) if opts.backend == "device" \
            else None
        resolved = lsm_read.resolve_candidates(cands, self.geom, opts,
                                               device)
        for slot, (_, value) in resolved.items():
            out[slot] = value
        return out

    def scan(self, start: bytes, end: bytes, opts=None
             ) -> list[tuple[bytes, int, bytes | None]]:
        """``[(key, seq, value|None)]`` for start <= key < end in key order,
        tombstones included (the store's merge needs them)."""
        opts = opts or DEFAULT_READ_OPTIONS
        if self.meta.largest < start or self.meta.smallest >= end:
            return []
        out = []
        fk = self.first_keys
        b = self.candidate_block(start)
        while b < len(fk) and fk[b] < end:
            blk = self.block(b, fill_cache=opts.fill_cache,
                             verify_crc=opts.verify_crc)
            lo = int(np.searchsorted(blk.keys_packed, start))
            for i in range(lo, blk.nvalid):
                k = formats.unpack_key_bytes(blk.keys_u32[i]).rstrip(b"\x00")
                if k >= end:
                    return out
                m = int(blk.meta[i])
                v = formats.unpack_value_bytes(blk.vals[i]) if m & 1 else None
                out.append((k, m >> 1, v))
            b += 1
        return out


class TableCache:
    """LRU cache of per-file ``TableReader``s plus the shared block cache;
    its readers stage batched reads on ``device``.  Thread-safe, as the
    block cache."""

    def __init__(self, capacity: int = 64, *, geom: SSTGeometry,
                 block_cache: BlockCache | None = None, device=None):
        self.capacity = capacity
        self.geom = geom
        self.block_cache = block_cache
        self.device = device
        self._lock = threading.Lock()
        self._c: OrderedDict[int, TableReader] = OrderedDict()  # guarded-by: _lock

    def reader(self, meta: FileMeta) -> TableReader:
        """The (cached) reader of ``meta``; nothing is read until it is
        first probed."""
        with self._lock:
            rdr = self._c.get(meta.file_no)
            if rdr is not None:
                self._c.move_to_end(meta.file_no)
                return rdr
            rdr = TableReader(meta, self.geom, block_cache=self.block_cache,
                              device=self.device)
            self._c[meta.file_no] = rdr
            while len(self._c) > self.capacity:
                self._c.popitem(last=False)
            return rdr

    def drop(self, file_no: int):
        with self._lock:
            self._c.pop(file_no, None)
        if self.block_cache is not None:
            self.block_cache.drop_file(file_no)
