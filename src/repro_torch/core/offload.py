"""Compaction executor and image building over tensors (the port of
``repro.core.offload``).

``CompactionExecutor`` is what the engine talks to: it owns the device and
the sort mode, concatenates the input images, pads them to the requested
block count and runs the pipeline, one job (``compact``) or a stack of
same-shape jobs in one batched pipeline (``compact_many`` over
``compact_batch``).

``sharded_compact`` scales the single-device pipeline to a mesh: a mesh
axis carries disjoint key-range partitions (``place_sharded``) and each
rank runs one pipeline on its shard -- compaction is embarrassingly
parallel across ranges; the only cross-rank traffic is the stats.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import compaction, formats
from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.device import resolve_device
from repro_torch.kernels import tables


@dataclasses.dataclass
class CompactionExecutor:
    """Runs compactions and image builds on ``device`` (None: ``cuda``).

    ``sort_mode="merge"`` (the default) is run-aware: ``compact`` derives
    the run lengths from the image list, so each image must be one sorted
    input SST.  ``debug_check_runs=True`` verifies that on the host for
    every job."""
    geom: SSTGeometry
    device: object = None
    sort_mode: str = "merge"  # "merge" | "device" | "xla" | "cooperative"
    debug_check_runs: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.sort_mode not in compaction.SORTERS:
            raise ValueError(f"unknown sort_mode {self.sort_mode!r}")

    def _check_device(self, img: SSTImage):
        if img.keys.device.type != self.device.type:
            raise ValueError(f"image on {img.keys.device}, executor on "
                             f"{self.device}")

    def _concat(self, images: list[SSTImage], pad_blocks: int | None):
        """The concatenated (and padded) input image and its run lengths."""
        for im in images:
            self._check_device(im)
        img, run_lens = formats.concat_images(images, with_runs=True)
        if pad_blocks is not None:
            img, run_lens = pad_image_blocks(img, pad_blocks, self.geom,
                                             run_lens=run_lens)
        if self.debug_check_runs and self.sort_mode == "merge":
            self._check_runs(img, run_lens)
        return img, tuple(run_lens)

    def _input(self, images: list[SSTImage], pad_blocks: int | None):
        """The concatenated (and padded) input image and its runs (None
        for the modes that re-sort)."""
        img, run_lens = self._concat(images, pad_blocks)
        return img, run_lens if self.sort_mode == "merge" else None

    def compact(self, images: list[SSTImage], *, bottom_level: bool = False,
                pad_blocks: int | None = None, timer=None
                ) -> tuple[SSTImage, compaction.CompactionStats]:
        """Compact the input set (tensor images on this executor's
        device).  ``pad_blocks`` pads the concatenation to that block
        count; the padding becomes a trailing all-sentinel run."""
        img, run_lens = self._input(images, pad_blocks)
        return compaction.compact(
            img, geom=self.geom, bottom_level=bottom_level,
            sort_mode=self.sort_mode, run_lens=run_lens, timer=timer)

    def compact_many(self, jobs: list[list[SSTImage]], *,
                     bottom_level: bool = False,
                     pad_blocks: int | None = None, timer=None
                     ) -> list[tuple[SSTImage, compaction.CompactionStats]]:
        """Compact several *same-shape* jobs in one batched pipeline
        (``compact_batch``).  Each job is one input image list; after its
        concatenation (and the padding to ``pad_blocks``) every job must
        have the same block count and, in merge mode, the same run lengths
        (callers group jobs by ``scheduler.batch_signature`` first; see
        ``TorchCompactionEngine.compact_many``), else ``ValueError``.
        Returns ``(image, stats)`` a job, in input order, each
        bit-identical to ``compact`` of that job alone, with its own
        ``crc_ok``."""
        if not jobs:
            raise AssertionError("compact_many needs at least one job")
        imgs, sigs = [], []
        for images in jobs:
            img, run_lens = self._concat(images, pad_blocks)
            imgs.append(img)
            sigs.append(run_lens)
        if self.sort_mode == "merge" and any(s != sigs[0] for s in sigs):
            raise ValueError(
                f"compact_many jobs have mismatched run signatures {sigs}; "
                "group jobs by shape bucket before batching")
        if any(im.keys.shape != imgs[0].keys.shape for im in imgs):
            raise ValueError(
                "compact_many jobs have mismatched block counts "
                f"{[im.keys.shape[0] for im in imgs]}; pass pad_blocks or "
                "group jobs by shape bucket before batching")
        stacked = SSTImage(*(torch.stack(parts) for parts in zip(*imgs)))
        out, stats = compact_batch(
            stacked, geom=self.geom, bottom_level=bottom_level,
            sort_mode=self.sort_mode,
            run_lens=sigs[0] if self.sort_mode == "merge" else None,
            timer=timer)
        return [(SSTImage(*(a[j] for a in out)), s)
                for j, s in enumerate(stats)]

    def compact_overlapped(self, images: list[SSTImage], *,
                           bottom_level: bool = False,
                           pad_blocks: int | None = None):
        """Fig. 6(b): yield ``("data", (keys, meta, vals, shared, nvalid,
        crc))`` as soon as the data blocks and their CRCs are done (an
        event recorded after the pack's CRC), then ``("bloom", bloom)``
        once the filter is, then ``("stats", stats)``.  A caller can
        serialize the data blocks while the filter builds.  The image is
        ``compact``'s."""
        img, run_lens = self._input(images, pad_blocks)
        cuda = self.device.type == "cuda"
        data_ready = torch.cuda.Event() if cuda else None
        out, counts = compaction.launch(
            img, geom=self.geom, bottom_level=bottom_level,
            sort_mode=self.sort_mode, run_lens=run_lens,
            data_ready=data_ready)
        if cuda:
            done = torch.cuda.current_stream(self.device).record_event()
            data_ready.synchronize()
        yield "data", (out.keys, out.meta, out.vals, out.shared, out.nvalid,
                       out.crc)
        if cuda:
            done.synchronize()
        yield "bloom", out.bloom
        yield "stats", compaction.read_stats(counts, img.n_blocks, self.geom)

    def _check_runs(self, img: SSTImage, run_lens: tuple[int, ...]):
        from repro_torch.kernels import merge_path
        up = compaction.unpack(img, self.geom)
        rows = compaction.build_tuples(up)
        merge_path.assert_runs_sorted(rows.cpu().numpy(), run_lens)

    def build_image(self, keys, meta, vals, n_live=None) -> SSTImage:
        """A fresh SST image from sorted entries (the memtable flush)."""
        return build_image(keys, meta, vals, n_live, geom=self.geom)


def compact_batch(img: SSTImage, *, geom: SSTGeometry,
                  bottom_level: bool = False, sort_mode: str = "device",
                  run_lens: tuple[int, ...] | None = None, timer=None
                  ) -> tuple[SSTImage, list[compaction.CompactionStats]]:
    """One batched pipeline over a leading *job* axis: ``img`` holds J
    independent jobs stacked on axis 0 (every field ``[J, ...]`` of one
    job's shape).  The kernels take the batch in the one job's launches
    (``compaction.launch_batch``), and the counts come back in one
    read-back.  Returns the stacked output image and each job's
    ``CompactionStats`` (``crc_ok`` a per-job verdict: one corrupt input
    does not taint its batch mates)."""
    out, counts = compaction.launch_batch(
        img, geom=geom, bottom_level=bottom_level, sort_mode=sort_mode,
        run_lens=run_lens, timer=timer)
    return out, compaction.read_stats_batch(counts, img.keys.shape[1], geom)


def build_image(keys: torch.Tensor, meta: torch.Tensor, vals: torch.Tensor,
                n_live: int | None = None, *,
                geom: SSTGeometry) -> SSTImage:
    """Pack sorted entries (int32 ``keys [n, L]``, ``meta [n]``,
    ``vals [n, Vw]``) into a wire SST image: phase 3 alone.  ``n_live``
    rows are real (default all); the rest are padding."""
    n = keys.shape[0]
    k = geom.block_kvs
    n_pad = max(k, -(-n // k) * k)
    dev = keys.device
    pad = n_pad - n
    keys = torch.cat([keys, keys.new_zeros((pad, keys.shape[1]))])
    meta = torch.cat([meta, meta.new_zeros(pad)])
    vals = torch.cat([vals, vals.new_zeros((pad, vals.shape[1]))])
    rows = torch.cat([keys, (~meta)[:, None],
                      torch.arange(n_pad, dtype=torch.int32,
                                   device=dev)[:, None]], dim=1)
    live = torch.arange(n_pad, device=dev) < (n if n_live is None
                                               else n_live)
    return compaction.pack(rows, live, vals, geom)


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def pad_image_blocks(img: SSTImage, n_blocks: int, geom: SSTGeometry,
                     run_lens: tuple[int, ...] | None = None):
    """Append empty (nvalid=0) blocks up to ``n_blocks``.  Padding blocks
    carry the CRC of an all-zero wire block, so phase 1 verifies them.
    With ``run_lens`` returns ``(img, run_lens + (pad_entries,))``: the
    padding is one trailing sentinel run, sorted by construction."""
    b = img.keys.shape[0]
    extra = n_blocks - b
    if extra <= 0:
        return img if run_lens is None else (img, run_lens)
    zero_crc = tables.crc32_zero_message(geom.wire_words_per_block * 4)

    def pad(a):
        return torch.cat([a, a.new_zeros((extra, *a.shape[1:]))])

    bloom = img.bloom
    if bloom.shape[0] == b:  # block-granularity filters track blocks
        bloom = pad(bloom)
    crc_pad = torch.full((extra,), zero_crc, dtype=torch.int64,
                         device=img.crc.device).to(torch.int32)
    padded = SSTImage(keys=pad(img.keys), meta=pad(img.meta),
                      vals=pad(img.vals), shared=pad(img.shared),
                      nvalid=pad(img.nvalid),
                      crc=torch.cat([img.crc, crc_pad]), bloom=bloom)
    if run_lens is None:
        return padded
    return padded, tuple(run_lens) + (extra * geom.block_kvs,)


def _block_placements(mesh, axes) -> list:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return [Shard(0) if n in axes else Replicate()
            for n in mesh.mesh_dim_names]


def place_sharded(img: SSTImage, mesh, axes) -> SSTImage:
    """``img`` (the same shapes on every rank; rank 0's values are taken)
    as DTensors with the block axis sharded over ``axes`` of ``mesh``, one
    a field.  A collective: every rank calls it."""
    from torch.distributed.tensor import distribute_tensor
    pl = _block_placements(mesh, axes)
    return SSTImage(*(distribute_tensor(a, mesh, pl, src_data_rank=0)
                      for a in img))


def shard_local(img: SSTImage, mesh, axes) -> SSTImage:
    """This rank's range of an image of DTensors, its block axis sharded
    over ``axes`` first (a placed image moves nothing)."""
    pl = _block_placements(mesh, axes)
    return SSTImage(*(a.redistribute(mesh, pl).to_local() for a in img))


def shard_global(img: SSTImage, mesh, axes) -> SSTImage:
    """This rank's output range as its part of an image of DTensors, the
    block axis sharded over ``axes``."""
    pl = _block_placements(mesh, axes)
    return SSTImage(*(DTensor.from_local(a, mesh, pl, run_check=False)
                      for a in img))


def sharded_compact(img: SSTImage, mesh, axes, *, geom: SSTGeometry,
                    bottom_level: bool = False, sort_mode: str = "device"):
    """Range-partitioned compaction across ``axes`` of ``mesh``.

    ``img`` holds ``n_shards`` concatenated per-range images along the
    block axis, placed by ``place_sharded`` (the host partitions SSTs by
    key range; ranges are disjoint, so no cross-shard merge is needed --
    the paper's single-device pipeline, ``compaction.compact``, is the
    per-shard unit, on each rank's device).  Returns the sharded output
    image and the shards' ``CompactionStats``, in shard order, on every
    rank.  A collective: every rank of the world calls it.

    ``sort_mode="merge"`` raises ``ValueError``, as JAX's does: per-shard
    run boundaries are not representable through its ``shard_map``'s
    uniform specs, so shards re-sort (``"device"`` / ``"xla"``).
    """
    if sort_mode == "merge":
        raise ValueError(
            'sharded_compact does not support sort_mode="merge": per-shard '
            "run boundaries are not representable through uniform shard "
            'specs; use "device" or "xla"')
    local = shard_local(img, mesh, axes)
    out, stats = compaction.compact(local, geom=geom,
                                    bottom_level=bottom_level,
                                    sort_mode=sort_mode)
    out = shard_global(out, mesh, axes)
    pl = _block_placements(mesh, axes)
    coord = mesh.get_coordinate()
    shard = 0
    for i, p in enumerate(pl):   # row-major over the sharding mesh dims
        if p.is_shard():
            shard = shard * mesh.size(i) + coord[i]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (shard, stats))
    return out, [st for _, st in sorted(dict(gathered).items())]
