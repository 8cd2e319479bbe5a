"""CPU compaction baseline (the LevelDB / RocksDB side of the paper).

The port's copy of ``repro.lsm.cpu_engine.CpuCompactionEngine``: numpy +
binascii on the host, no tensors.  Its math mirrors the kernels exactly
(same CRC, same bloom hash, same prefix rules), so for the same inputs it
writes the same SST files as ``engine.TorchCompactionEngine`` and as the
JAX package's CPU engine.  A store runs it only when its ``DBConfig``
names it (``engine="cpu"``); it is a baseline, never a fallback.

``threads`` models RocksDB's multi-threaded compaction: the work here is
single-threaded, and it is recorded as metadata for a harness that
divides the measured seconds by the modelled parallelism, as the JAX
package's does.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.kernels.ref import tree_merge
from repro_torch.lsm.engine import (EngineStats, np_bloom_hashes,
                                    np_bytes_to_u32, np_crc_blocks,
                                    np_prefix_decode, np_u32_to_bytes,
                                    np_wire_words)
# defined beside the read path's other host helpers; exported here too, as
# JAX's cpu_engine defines it
from repro_torch.lsm.engine import np_bloom_query  # noqa: F401
from repro_torch.obs.trace import NULL_TRACER

U32 = np.uint32


# ---------------------------------------------------------------------------
# numpy mirrors of the pack's kernels (the decode side is in lsm/engine.py)
# ---------------------------------------------------------------------------


def np_prefix_encode(keys: np.ndarray, restart_interval: int) -> np.ndarray:
    kb = np_u32_to_bytes(keys)
    prev = np.roll(kb, 1, axis=0)
    eq = (kb == prev).astype(np.int32)
    shared = np.cumprod(eq, axis=-1).sum(-1)
    idx = np.arange(keys.shape[0])
    return np.where(idx % restart_interval == 0, 0, shared).astype(np.int32)


def np_bloom_build(keys: np.ndarray, valid: np.ndarray, n_words: int,
                   n_probes: int) -> np.ndarray:
    g = keys.shape[0]
    h1, h2 = np_bloom_hashes(keys)
    out = np.zeros((g, n_words), U32)
    m_bits = U32(n_words * 32)
    for i in range(n_probes):
        pos = ((h1 + U32(i) * h2) % m_bits)
        w = (pos >> 5).astype(np.int64)
        bit = (U32(1) << (pos & U32(31))).astype(U32)
        for gi in range(g):
            np.bitwise_or.at(out[gi], w[gi][valid[gi]], bit[gi][valid[gi]])
    return out


def _np_merge_run_order(packed: np.ndarray, run_lens) -> np.ndarray:
    """Order indices sorting ``packed`` (unique fixed-width byte keys laid
    out as back-to-back sorted runs): a stable argsort per run (O(run) on a
    sorted run), then pairwise ``searchsorted`` merges up the tree of
    ``kernels.ref.tree_merge`` -- the host mirror of the merge path."""
    segs = []
    off = 0
    for ln in run_lens:
        seg = packed[off:off + ln]
        o = np.argsort(seg, kind="stable")
        segs.append((seg[o], (off + o).astype(np.int64)))
        off += ln
    if not segs:
        return np.zeros(0, np.int64)

    def merge2(a, b):
        (ak, ai), (bk, bi) = a, b
        pa = np.arange(len(ak)) + np.searchsorted(bk, ak, side="left")
        pb = np.arange(len(bk)) + np.searchsorted(ak, bk, side="right")
        keys_m = np.empty(len(ak) + len(bk), ak.dtype)
        idx_m = np.empty(len(ai) + len(bi), np.int64)
        keys_m[pa], idx_m[pa] = ak, ai
        keys_m[pb], idx_m[pb] = bk, bi
        return keys_m, idx_m

    return tree_merge(segs, merge2)[1]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class CpuCompactionEngine:
    """LevelDB-like compaction entirely on the host CPU.  Its
    ``EngineStats`` carry host seconds only (``device_seconds`` 0.0);
    ``sort_seconds`` is the measured wall time of phase 2."""

    name = "cpu"

    def __init__(self, geom: SSTGeometry, threads: int = 1, tracer=None):
        self.geom = geom
        self.threads = threads
        # the three phases as host spans, as JAX's CPU engine records them
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def close(self):
        """Nothing to release: the engine holds no files or threads."""

    # -- phase 1 -----------------------------------------------------------
    def _unpack(self, img: SSTImage):
        g = self.geom
        b, k, lanes = img.keys.shape
        crc_ok = bool((np_crc_blocks(np_wire_words(img)) ==
                       np.asarray(img.crc, U32)).all())
        keys = np_prefix_decode(
            np.asarray(img.shared).reshape(b * k),
            np.asarray(img.keys, U32).reshape(b * k, lanes),
            g.restart_interval)
        valid = (np.arange(k)[None, :] <
                 np.asarray(img.nvalid)[:, None]).reshape(b * k)
        return keys, np.asarray(img.meta, U32).reshape(b * k), \
            np.asarray(img.vals, U32).reshape(b * k, -1), valid, crc_ok

    # -- public API (the torch engine's) ------------------------------------
    def compact(self, images: list[SSTImage], *, bottom_level: bool = False
                ) -> tuple[SSTImage, EngineStats]:
        """Compact host images (numpy); returns a host image of as many
        blocks as the inputs hold (``write_sst`` trims the empty ones)."""
        t0 = time.perf_counter()
        g = self.geom
        tr = self.tracer
        with tr.span("compact.crc_verify", inputs=len(images)):
            parts = [self._unpack(SSTImage(*(np.asarray(a) for a in im)))
                     for im in images]
        keys = np.concatenate([p[0] for p in parts])
        meta = np.concatenate([p[1] for p in parts])
        vals = np.concatenate([p[2] for p in parts])
        valid = np.concatenate([p[3] for p in parts])
        crc_ok = all(p[4] for p in parts)

        # phase 2: run-aware k-way merge + dedup (key asc, seq desc); the
        # unique trailing index makes the order that of a full lexsort
        t_sort0 = time.perf_counter()
        with tr.span("compact.merge_phase2", runs=len(parts)):
            sk = np.where(valid[:, None], keys, U32(0xFFFFFFFF))
            inv_meta = (~meta).astype(U32)
            idx = np.arange(len(sk), dtype=U32)
            packed = np.ascontiguousarray(
                np.concatenate([sk, inv_meta[:, None], idx[:, None]],
                               axis=1).astype(">u4")).view(
                f"S{4 * (sk.shape[1] + 2)}").ravel()
            order = _np_merge_run_order(packed,
                                        [p[0].shape[0] for p in parts])
        t_sort = time.perf_counter() - t_sort0
        keys_s, meta_s, valid_s = keys[order], meta[order], valid[order]
        vals_s = vals[order]
        neq = np.any(keys_s != np.roll(keys_s, 1, axis=0), axis=1)
        neq[0] = True
        live = valid_s & neq
        if bottom_level:
            live &= (meta_s & 1).astype(bool)

        with tr.span("compact.format"):
            out = self.build_image(keys_s[live], meta_s[live], vals_s[live],
                                   n_blocks=sum(im.keys.shape[0]
                                                for im in images))
        wire = g.wire_words_per_block * 4
        stats = EngineStats(
            n_input=int(valid.sum()), n_live=int(live.sum()),
            n_dropped=int(valid.sum() - live.sum()), crc_ok=crc_ok,
            bytes_in=sum(im.keys.shape[0] for im in images) * wire,
            bytes_out=int((np.asarray(out.nvalid) > 0).sum()) * wire,
            sort_seconds=t_sort)
        stats.host_seconds = time.perf_counter() - t0
        return out, stats

    def compact_paths(self, paths: list[str], *, bottom_level: bool = False
                      ) -> tuple[SSTImage, EngineStats]:
        """Compact straight from SST files, read one after another; the
        reads count toward ``host_seconds``."""
        from repro_torch.lsm import sstable
        t0 = time.perf_counter()
        images = [sstable.read_sst(p) for p in paths]
        t_read = time.perf_counter() - t0
        out, stats = self.compact(images, bottom_level=bottom_level)
        stats.host_seconds += t_read
        return out, stats

    def compact_many(self, jobs: list[tuple[list[str], bool]]
                     ) -> list[tuple[SSTImage, EngineStats]]:
        """One job after another (the CPU has no batch dimension to
        exploit): ``[(input_paths, bottom_level)]`` in, results in order."""
        return [self.compact_paths(paths, bottom_level=bottom)
                for paths, bottom in jobs]

    def build_image(self, keys, meta, vals, n_blocks: int | None = None
                    ) -> SSTImage:
        """Pack sorted entries into a wire image (numpy phase 3), of
        ``n_blocks`` blocks (default: as few as hold the entries)."""
        g = self.geom
        keys = np.asarray(keys, U32)
        meta = np.asarray(meta, U32)
        vals = np.asarray(vals, U32)
        n = keys.shape[0]
        k = g.block_kvs
        nb = max(1, -(-n // k)) if n_blocks is None else max(1, n_blocks)
        n_pad = nb * k
        keys = np.pad(keys, ((0, n_pad - n), (0, 0)))
        meta = np.pad(meta, (0, n_pad - n))
        vals = np.pad(vals, ((0, n_pad - n), (0, 0)))
        valid = np.arange(n_pad) < n

        shared = np_prefix_encode(keys, g.restart_interval)
        shared = np.where(valid, shared, 0).astype(np.int32)
        kb = np_u32_to_bytes(keys)
        bpos = np.arange(kb.shape[-1])
        kb_wire = np.where(bpos[None, :] < shared[:, None], 0, kb)
        kb_wire = np.where(valid[:, None], kb_wire, 0).astype(np.uint8)
        keys_wire = np_bytes_to_u32(kb_wire)
        meta_w = np.where(valid, meta, 0).astype(U32)
        nvalid = np.clip(n - np.arange(nb) * k, 0, k).astype(np.int32)

        img = SSTImage(
            keys=keys_wire.reshape(nb, k, g.key_lanes),
            meta=meta_w.reshape(nb, k),
            vals=vals.reshape(nb, k, g.value_words),
            shared=shared.reshape(nb, k), nvalid=nvalid,
            crc=np.zeros(nb, U32), bloom=np.zeros((1, 1), U32))
        crc = np_crc_blocks(np_wire_words(img))
        if g.bloom_granularity == "block":
            groups, per = nb, k
        else:
            per = min(g.sst_kvs, n_pad)
            groups = n_pad // per
        bloom = np_bloom_build(keys.reshape(groups, per, g.key_lanes),
                               valid.reshape(groups, per),
                               g.bloom_words(per), g.bloom_probes)
        return img._replace(crc=crc, bloom=bloom)
