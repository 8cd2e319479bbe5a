"""Batched point reads: probe -> prune -> gather (the port of
``repro.lsm.read``).

LUDA's argument applied to reads: per-key lookups are independent, so K
of them stack into one launch.  ``multi_get`` resolves what it can in the
memtable, then turns every unresolved (key, SST) pair into a
``Candidate`` and resolves the set in rank-ordered waves: wave 0 takes
every slot's newest candidate, wave 1 the next candidate of the slots
still unresolved, and so on, as the scalar walk short-circuits.  Each
wave is one stacked pass:

1. **prune** -- candidates whose block is already in the ``BlockCache``
   skip the filter (searching a cached block is exact and cheaper); the
   rest go through one pairwise bloom probe over their stacked filter
   rows (``ops.bloom_multi_probe``).
2. **gather** -- the surviving blocks are decoded once each (through the
   cache), stacked, and every query is resolved by one lower-bound
   search and gather (``ops.lookup_blocks_packed``).

Newest-version-wins follows from the wave order: a candidate carries the
rank of its table in the scalar search order (L0 newest first, then the
deeper levels), and the first wave in which a slot finds its key holds
its minimum-rank find.

``ReadOptions.backend``: ``"device"`` stacks each stage's rows into
tensors on the store's device -- one copy to the device and one back per
stage -- so on ``cuda`` the two stages are the CUDA kernels and on
``cpu`` their plain versions; ``"host"`` runs the same stages in numpy.

Candidate counts are padded to power-of-two buckets before a device
stage, as the JAX package pads them; padded rows report absent (zero
filters; ``nvalid = 0``).  The kernels would take any count, but the
bucketing keeps the set of launch shapes small, which the repository's
jit-cache lint (``repro.analysis`` JC001) checks at every call site.

Tracing: each wave's prune is a ``read.bloom_probe`` span and its gather
(the block decodes and the stacked search) a ``read.block_gather`` span,
as in JAX, with the candidate count as ``n``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core.formats import SSTGeometry
from repro_torch.kernels import ops
from repro_torch.lsm import engine
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class Candidate:
    """One (query key, SST) pair in the stacked batch."""
    slot: int          # index into the caller's key batch
    rank: int          # search-order priority; min-rank found wins a slot
    reader: object     # sstable.TableReader
    key: bytes


def version_candidates(version, slot_keys, cache) -> list[Candidate]:
    """Ranked candidates for unresolved ``(slot, key)`` pairs in the scalar
    search order: L0 newest first (file number descending), then the
    deeper, disjoint levels top-down (at most one file per level)."""
    cands: list[Candidate] = []
    l0 = sorted(version.levels[0], key=lambda f: -f.file_no)
    for slot, key in slot_keys:
        rank = 0
        for fm in l0:
            if fm.smallest <= key <= fm.largest:
                cands.append(Candidate(slot, rank, cache.reader(fm), key))
            rank += 1
        for level in range(1, len(version.levels)):
            for fm in version.levels[level]:
                if fm.smallest <= key <= fm.largest:
                    cands.append(Candidate(slot, rank, cache.reader(fm),
                                           key))
                    rank += 1
                    break
    return cands


def resolve_candidates(cands: list[Candidate], geom: SSTGeometry, opts,
                       device: torch.device, *, counters=None, tracer=None,
                       span_args=None
                       ) -> dict[int, tuple[int, bytes | None]]:
    """``{slot: (rank, value|None)}`` for the minimum-rank found candidate
    of each slot (``None``: a tombstone); slots that found nothing are
    absent.  ``device`` is the store's: the ``"device"`` backend stages
    there.  ``counters``: the owner's ``lsm.*`` counters by ``DBStats``
    field, which count bloom prunes per candidate
    (``bloom_negative_skips``), the waves, and the device stages' staged
    bytes and host-clock seconds (block-cache traffic is counted by the
    cache's own hooks).  ``tracer`` records each wave's two stages, with
    ``span_args`` (the owner's labels) in their args.  Raises
    ``FileNotFoundError`` if a candidate's file is gone; the caller
    decides whether to retry."""
    if not cands:
        return {}
    tracer = tracer if tracer is not None else NULL_TRACER
    sa = span_args or {}
    queues: dict[int, list[Candidate]] = {}
    for c in cands:   # version_candidates appends in rank order per slot
        queues.setdefault(c.slot, []).append(c)
    best: dict[int, tuple[int, bytes | None]] = {}
    fronts = dict.fromkeys(queues, 0)
    while fronts:
        wave = []
        for slot in list(fronts):
            q = queues[slot]
            pos = fronts[slot]
            if pos >= len(q):
                del fronts[slot]
                continue
            wave.append(q[pos])
            fronts[slot] = pos + 1
        if not wave:
            break
        if counters is not None:
            counters["multi_get_waves"].inc()
        for slot, rv in _resolve_wave(wave, geom, opts, device, counters,
                                      tracer, sa).items():
            best[slot] = rv
            fronts.pop(slot, None)
    return best


def _resolve_wave(cands: list[Candidate], geom: SSTGeometry, opts, device,
                  counters, tracer, sa
                  ) -> dict[int, tuple[int, bytes | None]]:
    """One stacked prune -> gather pass over at most one candidate per
    slot."""
    blocks = [c.reader.candidate_block(c.key) for c in cands]  # loads files

    # residency: a decoded block skips the bloom stage (its search is
    # exact, so skipping the probe cannot change the answer)
    decoded: dict[tuple[int, int], object] = {}
    for c, b in zip(cands, blocks):
        ck = (id(c.reader), b)
        if ck not in decoded:
            blk = c.reader.cached_block(b)
            if blk is not None:
                decoded[ck] = blk
    alive = np.zeros(len(cands), bool)
    probe_idx = []
    for i, (c, b) in enumerate(zip(cands, blocks)):
        if (id(c.reader), b) in decoded:
            alive[i] = True
        else:
            probe_idx.append(i)

    # prune: one stacked pairwise probe over the uncached candidates
    if probe_idx:
        rows = [cands[i].reader.bloom_row(blocks[i]) for i in probe_idx]
        if any(r is not None for r in rows):
            probes = np.stack(
                [formats.pack_key_bytes(cands[i].key, geom.key_bytes)
                 for i in probe_idx])                          # [P, L]
            w = next(r.shape[-1] for r in rows if r is not None)
            ones = np.full((w,), 0xFFFFFFFF, np.uint32)  # no filter: keep
            filters = np.stack([ones if r is None else r for r in rows])
            with tracer.span("read.bloom_probe", n=len(probe_idx), **sa):
                keep = _bloom_stage(filters, probes, geom, opts.backend,
                                    device, counters)
        else:
            keep = np.ones(len(probe_idx), bool)
        alive[probe_idx] = keep
        if counters is not None:
            pruned = int(len(probe_idx) - keep.sum())
            if pruned:
                counters["bloom_negative_skips"].inc(pruned)

    survivors = [i for i in range(len(cands)) if alive[i]]
    if not survivors:
        return {}

    # gather: decode the surviving blocks once, one stacked search
    with tracer.span("read.block_gather", n=len(survivors), **sa):
        for i in survivors:
            ck = (id(cands[i].reader), blocks[i])
            if ck not in decoded:
                decoded[ck] = cands[i].reader.decode_block(
                    blocks[i], fill_cache=opts.fill_cache,
                    verify_crc=opts.verify_crc)
        blks = [decoded[(id(cands[i].reader), blocks[i])]
                for i in survivors]
        if opts.backend == "host":
            found, metas, vals = _host_lookup(
                blks, [cands[i].key for i in survivors])
        else:
            queries = np.stack(
                [formats.pack_key_bytes(cands[i].key, geom.key_bytes)
                 for i in survivors])
            found, metas, vals = _device_lookup(blks, queries, device,
                                                counters)

    best: dict[int, tuple[int, bytes | None]] = {}
    for j, i in enumerate(survivors):
        if not found[j]:
            continue
        c = cands[i]
        value = formats.unpack_value_bytes(vals[j]) \
            if int(metas[j]) & 1 else None
        best[c.slot] = (c.rank, value)
    return best


def _bucket(n: int, lo: int = 8) -> int:
    """The next power of two >= n (at least ``lo``)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _bloom_stage(filters: np.ndarray, probes: np.ndarray, geom: SSTGeometry,
                 backend: str, device, counters=None) -> np.ndarray:
    """bool ``[P]``: probe row ``i`` against filter row ``i``."""
    n = filters.shape[0]
    if backend == "host":
        return engine.np_bloom_query(filters, probes[:, None, :],
                                     geom.bloom_probes)[:, 0]
    t0 = time.perf_counter()
    pad = _bucket(n) - n   # zero filters: padded rows report absent
    filters_t, probes_t = _stage([np.pad(filters, ((0, pad), (0, 0))),
                                  np.pad(probes, ((0, pad), (0, 0)))], device,
                                 counters)
    hit = ops.bloom_multi_probe(filters_t, probes_t,
                                n_probes=geom.bloom_probes)
    keep = hit.cpu().numpy()[:n]
    _count_stage(counters, t0)
    return keep


def _host_lookup(blks, keys):
    """numpy gather, one ``searchsorted`` per distinct block over its packed
    key column (queries cast to the column's ``S`` width zero-pad to the
    fixed packing, and keys never end with NUL, so it is exact)."""
    n = len(blks)
    found = np.zeros(n, bool)
    metas = np.zeros(n, np.uint32)
    vw = blks[0].vals.shape[-1] if n else 0
    vals = np.zeros((n, vw), np.uint32)
    groups: dict[int, list[int]] = {}
    for j, blk in enumerate(blks):
        groups.setdefault(id(blk), []).append(j)
    for idxs in groups.values():
        blk = blks[idxs[0]]
        col = blk.keys_packed
        qarr = np.asarray([keys[j] for j in idxs], dtype=col.dtype)
        pos = np.searchsorted(col, qarr)
        safe = np.minimum(pos, len(col) - 1)
        ok = (pos < blk.nvalid) & (col[safe] == qarr)
        for t, j in enumerate(idxs):
            if ok[t]:
                found[j] = True
                metas[j] = blk.meta[pos[t]]
                vals[j] = blk.vals[pos[t]]
    return found, metas, vals


def _count_stage(counters, t0: float) -> None:
    """Add a device stage's host-clock seconds since ``t0`` (stacking, the
    copy over, the kernel, the copy back) to ``counters``."""
    if counters is not None:
        counters["multi_get_stage_seconds"].add(time.perf_counter() - t0)


def _stage(arrays, device, counters=None) -> list[torch.Tensor]:
    """Copy 32-bit host arrays to ``device`` in one transfer: one int32
    host buffer, split on the device into tensors of the arrays' shapes.
    ``counters`` count the bytes copied."""
    flat = np.concatenate([np.ascontiguousarray(a).view(np.int32).ravel()
                           for a in arrays])
    if counters is not None:
        counters["multi_get_staged_bytes"].inc(flat.nbytes)
    buf = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for a in arrays:
        out.append(buf[off:off + a.size].view(a.shape))
        off += a.size
    return out


def _device_lookup(blks, queries: np.ndarray, device, counters=None):
    """Stack the candidate blocks, copy them to ``device`` in one transfer,
    resolve every query in one ``lookup_blocks_packed`` call, and read its
    one buffer back in one transfer."""
    t0 = time.perf_counter()
    n = len(blks)
    pad = _bucket(n) - n   # sentinel rows with nvalid = 0: never found
    keys = np.stack([b.keys_u32 for b in blks])        # [C, K, L]
    meta = np.stack([b.meta for b in blks])            # [C, K]
    vals = np.stack([b.vals for b in blks])            # [C, K, Vw]
    nvalid = np.array([b.nvalid for b in blks], np.int32)
    staged = [np.pad(keys, ((0, pad), (0, 0), (0, 0)),
                     constant_values=0xFFFFFFFF),
              np.pad(meta, ((0, pad), (0, 0))),
              np.pad(vals, ((0, pad), (0, 0), (0, 0))),
              np.pad(nvalid, (0, pad)),
              np.pad(queries, ((0, pad), (0, 0)))]
    packed = ops.lookup_blocks_packed(*_stage(staged, device, counters))
    out = packed.cpu().numpy().view(np.uint32)[:n]
    _count_stage(counters, t0)
    return out[:, 0].astype(bool), out[:, 1], out[:, 2:]
