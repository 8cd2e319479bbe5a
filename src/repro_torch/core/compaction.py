"""The LUDA compaction pipeline over tensors: unpack -> sort -> pack.

The port of ``repro.core.compaction``.  The three phases map to the
paper's kernels, here the port's CUDA kernels (``kernels.ops``):

* phase 1 ``unpack``     -> CRC verify (``crc32_sections``) + prefix restore
* phase 2 ``sort``       -> ``<K, ~meta, V_offset>`` tuples merged run by
                            run (``merge_runs``, the default), or re-sorted
                            (``device``: ``bitonic_sort``; ``xla``: a
                            stable torch sort; ``cooperative``: a host
                            sort)
* phase 3 ``shared_key`` -> ``prefix_encode_wire`` on the survivor keys (the
                            shared lengths and the wire keys)
          ``encode``     -> value gather + CRC
          ``filter``     -> ``bloom_build``

PyTorch runs eagerly, so there is no jit and no static-shape bucketing
here; the engine still pads to the same block counts as the JAX engine,
because the padding decides the output image's size.  Values move once:
the sort carries the pair-buffer index, and phase 3 gathers each output
slot's value by it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.kernels import ops


class CompactionStats(NamedTuple):
    n_input: int      # live entries in
    n_live: int       # entries out
    n_dropped: int    # stale, shadowed or collected tombstones
    crc_ok: bool      # every input block verified
    bytes_in: int     # wire bytes read
    bytes_out: int    # wire bytes written (live blocks only)


class Unpacked(NamedTuple):
    keys: torch.Tensor    # [N, L] fully restored user keys
    meta: torch.Tensor    # [N]
    vals: torch.Tensor    # [N, Vw]  (the KV pair buffer)
    valid: torch.Tensor   # bool [N]
    crc_ok: torch.Tensor  # bool [n_blocks]


# ---------------------------------------------------------------------------
# Phase 1: unpack
# ---------------------------------------------------------------------------


def unpack(img: SSTImage, geom: SSTGeometry) -> Unpacked:
    b, k, lanes = img.keys.shape
    crc_ok = ops.crc32_sections(formats.wire_sections(img)) == img.crc
    keys = ops.prefix_decode(img.shared.reshape(b * k),
                             img.keys.reshape(b * k, lanes),
                             restart_interval=geom.restart_interval)
    valid = formats.entry_validity(img).reshape(b * k)
    return Unpacked(keys=keys, meta=img.meta.reshape(b * k),
                    vals=img.vals.reshape(b * k, -1), valid=valid,
                    crc_ok=crc_ok)


# ---------------------------------------------------------------------------
# Phase 2: delete + sort (lightweight tuples)
# ---------------------------------------------------------------------------


def build_tuples(up: Unpacked) -> torch.Tensor:
    """``<K, ~meta, V_offset>`` rows; padding rows get the all-ones key so
    they sort to the end of their run."""
    n = up.keys.shape[0]
    keys = torch.where(up.valid[:, None], up.keys, -1)
    idx = torch.arange(n, dtype=torch.int32, device=up.keys.device)
    return torch.cat([keys, (~up.meta)[:, None], idx[:, None]], dim=1)


def cooperative_sort(rows: torch.Tensor) -> torch.Tensor:
    """The paper's cooperative sort: tuples go to the host, are sorted
    there, and come back."""
    r = rows.cpu().numpy().view(np.uint32)
    order = np.lexsort(tuple(r[:, lane]
                             for lane in reversed(range(r.shape[1]))))
    return torch.from_numpy(np.ascontiguousarray(r[order]).view(
        np.int32)).to(rows.device)


# mode -> (rows, run_lens) -> sorted rows
SORTERS = {
    "merge": lambda rows, run_lens: ops.merge_runs(rows, run_lens),
    "device": lambda rows, run_lens: ops.bitonic_sort(rows),
    "xla": lambda rows, run_lens: ops.sort_tuples(rows),
    "cooperative": lambda rows, run_lens: cooperative_sort(rows),
}


def sort_phase(rows: torch.Tensor, *, sort_mode: str,
               run_lens: tuple[int, ...] | None = None) -> torch.Tensor:
    """Order the phase-2 tuples.  ``"merge"`` merges the sorted runs that
    ``run_lens`` (entries per input SST) delimits; ``None`` means one
    sorted run.  The other modes re-sort everything."""
    if sort_mode not in SORTERS:
        raise ValueError(f"unknown sort_mode {sort_mode!r}")
    return SORTERS[sort_mode](rows, run_lens)


def survivor_mask(rows: torch.Tensor, valid: torch.Tensor, key_lanes: int,
                  *, bottom_level: bool) -> torch.Tensor:
    """Keep the newest version of each user key; drop shadowed versions;
    collect tombstones only at the bottom level."""
    keys_s = rows[:, :key_lanes]
    meta = ~rows[:, key_lanes]
    valid_s = valid[rows[:, key_lanes + 1].to(torch.int64)]
    first = torch.any(keys_s != torch.roll(keys_s, 1, dims=0), dim=1)
    first[0] = True
    live = valid_s & first
    if bottom_level:
        live = live & formats.meta_is_value(meta)
    return live


# ---------------------------------------------------------------------------
# Phase 3: pack
# ---------------------------------------------------------------------------


def pack(rows: torch.Tensor, live: torch.Tensor, vals: torch.Tensor,
         geom: SSTGeometry, data_ready=None) -> SSTImage:
    """Phase 3.  ``data_ready`` (a CUDA event) is recorded once the data
    blocks and their CRCs are enqueued, before the filter."""
    n = rows.shape[0]
    lanes = geom.key_lanes
    k = geom.block_kvs
    n_blocks = n // k
    dev = rows.device

    # compact survivors to the front: slot pos[i] takes sorted row i.  The
    # dead rows are routed to one spare slot n, dropped with it.
    pos = torch.cumsum(live.to(torch.int64), 0) - 1
    tgt = torch.where(live, pos, n)
    count = live.sum()
    slot_row = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    slot_row.index_copy_(0, tgt, torch.arange(n, device=dev))
    slot_row = slot_row[:n]
    valid_c = torch.arange(n, device=dev) < count

    src = rows[slot_row]
    keys_c = torch.where(valid_c[:, None], src[:, :lanes], 0).contiguous()
    meta_c = torch.where(valid_c, ~src[:, lanes], 0)
    # lazy value movement: one gather from the pair buffer
    vals_c = torch.where(valid_c[:, None],
                         vals[src[:, lanes + 1].to(torch.int64)], 0)

    # the canonical compressed form: shared prefix bytes zeroed in lanes,
    # nothing shared past the survivors (one launch on the card)
    shared, keys_wire = ops.prefix_encode_wire(
        keys_c, count, restart_interval=geom.restart_interval)
    nvalid = torch.clamp(count - torch.arange(n_blocks, device=dev) * k,
                         0, k).to(torch.int32)

    img = SSTImage(
        keys=keys_wire.reshape(n_blocks, k, lanes),
        meta=meta_c.reshape(n_blocks, k),
        vals=vals_c.reshape(n_blocks, k, -1),
        shared=shared.reshape(n_blocks, k),
        nvalid=nvalid,
        crc=torch.zeros(n_blocks, dtype=torch.int32, device=dev),
        bloom=torch.zeros((1, 1), dtype=torch.int32, device=dev),
    )
    crc = ops.crc32_sections(formats.wire_sections(img))
    if data_ready is not None:
        data_ready.record()

    # filter: bloom per block or per SST, over the restored keys
    if geom.bloom_granularity == "block":
        groups, per = n_blocks, k
    else:
        per = min(geom.sst_kvs, n)
        groups = n // per
    bloom = ops.bloom_build(keys_c.reshape(groups, per, lanes),
                            valid_c.reshape(groups, per),
                            n_words=geom.bloom_words(per),
                            n_probes=geom.bloom_probes)
    return img._replace(crc=crc, bloom=bloom)


# ---------------------------------------------------------------------------
# End-to-end pipeline
# ---------------------------------------------------------------------------


def compact(img: SSTImage, *, geom: SSTGeometry, bottom_level: bool = False,
            sort_mode: str = "device",
            run_lens: tuple[int, ...] | None = None, timer=None
            ) -> tuple[SSTImage, CompactionStats]:
    """Run one compaction over the concatenated input image.

    ``run_lens`` (entries per input SST) keeps the sorted-run structure
    of the concatenation for ``sort_mode="merge"``, which requires it: the
    input is normally several runs, and taking it as one would corrupt the
    output (a single-run input is ``run_lens=(n_entries,)``).  ``timer``
    (a ``DeviceTimer``) records phase 2 as its ``"sort"`` span.  The stats
    are read back to the host once, at the end."""
    out, counts = launch(img, geom=geom, bottom_level=bottom_level,
                         sort_mode=sort_mode, run_lens=run_lens, timer=timer)
    return out, read_stats(counts, img.n_blocks, geom)


def launch(img: SSTImage, *, geom: SSTGeometry, bottom_level: bool = False,
           sort_mode: str = "device",
           run_lens: tuple[int, ...] | None = None, timer=None,
           data_ready=None) -> tuple[SSTImage, torch.Tensor]:
    """``compact`` without its read-back: the output image and the stats'
    counts, both still on the device.  ``data_ready`` (a CUDA event) is
    recorded after the pack's CRC (``pack``)."""
    if sort_mode == "merge" and run_lens is None:
        raise ValueError(
            'sort_mode="merge" requires run_lens (the per-input entry '
            "counts; see formats.concat_images(..., with_runs=True))")
    up = unpack(img, geom)
    rows = build_tuples(up)
    if timer is None:
        rows_s = sort_phase(rows, sort_mode=sort_mode, run_lens=run_lens)
    else:
        with timer.span("sort"):
            rows_s = sort_phase(rows, sort_mode=sort_mode,
                                run_lens=run_lens)
    live = survivor_mask(rows_s, up.valid, geom.key_lanes,
                         bottom_level=bottom_level)
    out = pack(rows_s, live, up.vals, geom, data_ready=data_ready)
    counts = torch.stack([
        up.valid.sum(), live.sum(), up.crc_ok.all().to(torch.int64),
        (out.nvalid > 0).sum()])
    return out, counts


def read_stats(counts: torch.Tensor, n_blocks: int,
               geom: SSTGeometry) -> CompactionStats:
    """The ``CompactionStats`` of ``launch``'s counts for an input of
    ``n_blocks`` blocks (one read-back)."""
    wire_bytes = geom.wire_words_per_block * 4
    n_in, n_live, crc_ok, live_blocks = counts.tolist()
    return CompactionStats(
        n_input=n_in, n_live=n_live, n_dropped=n_in - n_live,
        crc_ok=bool(crc_ok), bytes_in=n_blocks * wire_bytes,
        bytes_out=live_blocks * wire_bytes)


# ---------------------------------------------------------------------------
# A batch of jobs (the body of JAX's ``offload.compact_batch``)
# ---------------------------------------------------------------------------
#
# Every field of a batch image is ``[J, ...]``: J same-shape jobs, each one
# job's concatenated (and padded) input.  The CRC, the prefix restore, the
# bloom build and the pack's CRC run once over the flattened ``J x blocks``
# rows; the merge, the device sort and the pack's prefix step take the job
# as a dimension of their one launch; the tuple index, the survivor mask and
# the pack's compaction stay per job.  Each job's output is bit-identical to
# the same job run alone through ``launch``.


def unpack_batch(img: SSTImage, geom: SSTGeometry) -> Unpacked:
    """Phase 1 over a batch: ``keys [J, N, L]``, ``meta [J, N]``, ``vals
    [J, N, Vw]``, ``valid [J, N]``, ``crc_ok [J, blocks]``."""
    j, b, k, lanes = img.keys.shape
    flat = SSTImage(*(t.flatten(0, 1) for t in img))
    crc_ok = ops.crc32_sections(formats.wire_sections(flat)) == flat.crc
    keys = ops.prefix_decode(flat.shared.reshape(j * b * k),
                             flat.keys.reshape(j * b * k, lanes),
                             restart_interval=geom.restart_interval)
    return Unpacked(keys=keys.reshape(j, b * k, lanes),
                    meta=img.meta.reshape(j, b * k),
                    vals=img.vals.reshape(j, b * k, -1),
                    valid=formats.entry_validity(flat).reshape(j, b * k),
                    crc_ok=crc_ok.reshape(j, b))


def build_tuples_batch(up: Unpacked) -> torch.Tensor:
    """``build_tuples`` per job: rows ``[J, N, L + 2]``, the index lane
    numbering each job's own rows ``0..N-1``."""
    j, n = up.valid.shape
    keys = torch.where(up.valid[..., None], up.keys, -1)
    idx = torch.arange(n, dtype=torch.int32,
                       device=up.keys.device).expand(j, n)
    return torch.cat([keys, (~up.meta)[..., None], idx[..., None]], dim=2)


# mode -> (rows [J, N, W], run_lens) -> each job's rows sorted, in the one
# job's launches; the other modes sort job by job (``sort_phase_batch``)
BATCH_SORTERS = {
    "merge": lambda rows, run_lens: ops.merge_runs(rows, run_lens),
    "device": lambda rows, run_lens: ops.bitonic_sort(rows),
}


def sort_phase_batch(rows: torch.Tensor, *, sort_mode: str,
                     run_lens: tuple[int, ...] | None = None
                     ) -> torch.Tensor:
    """``sort_phase`` per job of ``rows [J, N, W]``."""
    if sort_mode in BATCH_SORTERS:
        return BATCH_SORTERS[sort_mode](rows, run_lens)
    return torch.stack([sort_phase(r, sort_mode=sort_mode,
                                   run_lens=run_lens) for r in rows])


def survivor_mask_batch(rows: torch.Tensor, valid: torch.Tensor,
                        key_lanes: int, *, bottom_level: bool
                        ) -> torch.Tensor:
    """``survivor_mask`` per job: the shadow test rolls along each job's
    own rows, so a job's first row never compares with another job's."""
    keys_s = rows[..., :key_lanes]
    meta = ~rows[..., key_lanes]
    valid_s = torch.gather(valid, 1, rows[..., key_lanes + 1].to(torch.int64))
    first = torch.any(keys_s != torch.roll(keys_s, 1, dims=1), dim=2)
    first[:, 0] = True
    live = valid_s & first
    if bottom_level:
        live = live & formats.meta_is_value(meta)
    return live


def pack_batch(rows: torch.Tensor, live: torch.Tensor, vals: torch.Tensor,
               geom: SSTGeometry) -> SSTImage:
    """``pack`` per job of ``rows [J, N, W]`` (its survivors ``live [J,
    N]``, its values ``vals [J, N, Vw]``): each job compacts into its own
    slots, with its own spare slot and survivor count, and gathers its
    values from its own rows.  Returns the ``[J, ...]`` image."""
    j, n, width = rows.shape
    lanes = geom.key_lanes
    k = geom.block_kvs
    n_blocks = n // k
    dev = rows.device

    pos = torch.cumsum(live.to(torch.int64), 1) - 1
    tgt = torch.where(live, pos, n)
    count = live.sum(1)
    slot_row = torch.zeros((j, n + 1), dtype=torch.int64, device=dev)
    slot_row.scatter_(1, tgt, torch.arange(n, device=dev).expand(j, n))
    slot_row = slot_row[:, :n]
    valid_c = torch.arange(n, device=dev)[None, :] < count[:, None]

    src = torch.gather(rows, 1, slot_row[..., None].expand(j, n, width))
    keys_c = torch.where(valid_c[..., None], src[..., :lanes],
                         0).contiguous()
    meta_c = torch.where(valid_c, ~src[..., lanes], 0)
    vidx = src[..., lanes + 1].to(torch.int64)
    vals_c = torch.where(valid_c[..., None], torch.gather(
        vals, 1, vidx[..., None].expand(j, n, vals.shape[2])), 0)

    shared, keys_wire = ops.prefix_encode_wire(
        keys_c, count, restart_interval=geom.restart_interval)
    nvalid = torch.clamp(
        count[:, None] - torch.arange(n_blocks, device=dev)[None, :] * k,
        0, k).to(torch.int32)
    img = SSTImage(
        keys=keys_wire.reshape(j * n_blocks, k, lanes),
        meta=meta_c.reshape(j * n_blocks, k),
        vals=vals_c.reshape(j * n_blocks, k, -1),
        shared=shared.reshape(j * n_blocks, k),
        nvalid=nvalid.reshape(j * n_blocks),
        crc=torch.zeros(1, dtype=torch.int32, device=dev),
        bloom=torch.zeros((1, 1), dtype=torch.int32, device=dev))
    crc = ops.crc32_sections(formats.wire_sections(img))

    if geom.bloom_granularity == "block":
        groups, per = n_blocks, k
    else:
        per = min(geom.sst_kvs, n)
        groups = n // per
    bloom = ops.bloom_build(keys_c.reshape(j * groups, per, lanes),
                            valid_c.reshape(j * groups, per),
                            n_words=geom.bloom_words(per),
                            n_probes=geom.bloom_probes)
    return SSTImage(*(t.reshape(j, -1, *t.shape[1:]) for t in img._replace(
        crc=crc, bloom=bloom)))


def launch_batch(img: SSTImage, *, geom: SSTGeometry,
                 bottom_level: bool = False, sort_mode: str = "device",
                 run_lens: tuple[int, ...] | None = None, timer=None
                 ) -> tuple[SSTImage, torch.Tensor]:
    """``launch`` over a batch image (every field ``[J, ...]``, one
    job's input each, the same ``run_lens`` for all): the ``[J, ...]``
    output image and the int64 counts ``[J, 4]``, still on the device.
    ``timer`` records phase 2 as its ``"sort"`` span."""
    if sort_mode == "merge" and run_lens is None:
        raise ValueError(
            'sort_mode="merge" requires run_lens (the per-input entry '
            "counts; see formats.concat_images(..., with_runs=True))")
    if sort_mode not in SORTERS:
        raise ValueError(f"unknown sort_mode {sort_mode!r}")
    up = unpack_batch(img, geom)
    rows = build_tuples_batch(up)
    if timer is None:
        rows_s = sort_phase_batch(rows, sort_mode=sort_mode,
                                  run_lens=run_lens)
    else:
        with timer.span("sort"):
            rows_s = sort_phase_batch(rows, sort_mode=sort_mode,
                                      run_lens=run_lens)
    live = survivor_mask_batch(rows_s, up.valid, geom.key_lanes,
                               bottom_level=bottom_level)
    out = pack_batch(rows_s, live, up.vals, geom)
    counts = torch.stack([
        up.valid.sum(1), live.sum(1), up.crc_ok.all(1).to(torch.int64),
        (out.nvalid > 0).sum(1)], dim=1)
    return out, counts


def read_stats_batch(counts: torch.Tensor, n_blocks: int,
                     geom: SSTGeometry) -> list[CompactionStats]:
    """Each job's ``CompactionStats`` from ``launch_batch``'s ``[J, 4]``
    counts (one read-back for the batch), inputs of ``n_blocks`` blocks."""
    wire_bytes = geom.wire_words_per_block * 4
    return [CompactionStats(
        n_input=n_in, n_live=n_live, n_dropped=n_in - n_live,
        crc_ok=bool(crc_ok), bytes_in=n_blocks * wire_bytes,
        bytes_out=live_blocks * wire_bytes)
        for n_in, n_live, crc_ok, live_blocks in counts.tolist()]
