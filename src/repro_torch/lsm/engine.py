"""The port's compaction engine, and the host numpy helpers the SST reader
needs.

``TorchCompactionEngine`` is the counterpart of
``repro.lsm.cpu_engine.DeviceCompactionEngine``: it stages SST images on
its device, pads them exactly as the JAX engine does (each input run to a
power-of-two block count, the total to a power-of-two bucket, a flush to
a power-of-two block count), runs the pipeline through
``CompactionExecutor`` and brings the output image back to the host.  The
padding decides the output image's size, so the same padding is what
makes the SST files byte-identical to the JAX store's.

A compaction job whose launch raises, or whose CRC verdict is negative,
runs once more on the same card (``launch_retries`` counts each such
retry); a stacked launch that raises reruns its jobs one by one, which
counts one retry.  That is the device half of the JAX engine's launch
resilience, and all of it: there is no CPU engine behind this one, so the
second attempt's error propagates and its negative verdict is returned
(the store then aborts the job with its inputs kept).  The failpoints
``engine.launch`` and ``engine.crc`` fire before the pipeline call and
after it, before its verdict is read.  (The numpy CPU baseline,
``cpu_engine.CpuCompactionEngine``, runs only where a store's config
names it.)

On the card, ``device_seconds`` and ``sort_seconds`` are CUDA-event spans
around the pipeline and around phase 2; on the CPU they stay 0.0.  The
events are recorded on the calling thread's current stream, the default
stream that every thread of the process launches on (a store's flush and
compaction workers, its readers).  A span holds whatever reaches that
stream between its two events, and the card's idle time while the host
has not yet launched: a job called alone, it is the job's time on the
card; under an async store it also holds the readers' waves and the
worker's waits for the interpreter, so it is a span, not the job's
device time (a profiler's trace gives that).

Tracing (``tracer``, an ``obs.Tracer``; ``NULL_TRACER`` by default): the
spans ``compact.read_inputs``, ``compact.execute`` (one job),
``compact.batch_launch`` (a stacked launch) and ``compact_many`` at the
places JAX's device engine records them.  Under each launch span the
pipeline's three phases are child spans, ``compact.crc_verify`` (phase 1,
from the pipeline's start to phase 2's), ``compact.merge_phase2`` and
``compact.format`` (phase 3, from phase 2's end to the pipeline's),
measured where JAX's are modelled: on the card the times between the
CUDA events the pipeline and its ``"sort"`` span record anyway (no event
is added, traced or not), on the CPU the host clock.  Their args name the
clock (``"clock": "cuda_event"`` or ``"host"``), carry ``"stream":
"shared"`` when another thread launched one of the port's kernels between
the pipeline's two events (``ops.launch_marks``, read only when traced;
on the card its work is then inside the children), and ``"scale"`` when
they were scaled down to fit the launch span's wall.  The durations are read after the output is back on
the host, where the engine waits for the events already.
"""

from __future__ import annotations

import binascii
import dataclasses
import threading
import time

import numpy as np

from repro_torch.core import formats, offload
from repro_torch.core.formats import SSTGeometry, SSTImage
from repro_torch.device import DeviceTimer, resolve_device
from repro_torch.kernels import ops
from repro_torch.lsm import faults
from repro_torch.obs.trace import NULL_TRACER

U32 = np.uint32

# the pipeline's phases as child spans of a launch span, in order: the
# time before the "sort" span, the span, the time after it
PHASE_SPANS = ("compact.crc_verify", "compact.merge_phase2",
               "compact.format")


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
    reads, staging, read-back).  A job of a stacked launch (``batched``)
    gets the launch's event times divided by its jobs."""
    n_input: int = 0
    n_live: int = 0
    n_dropped: int = 0
    crc_ok: bool = True
    bytes_in: int = 0
    bytes_out: int = 0
    host_seconds: float = 0.0
    device_seconds: float = 0.0
    sort_seconds: float = 0.0
    batched: bool = False   # produced by a stacked multi-job launch


class TorchCompactionEngine:
    """The LUDA path on PyTorch: flushes and compactions on ``device``
    (None: ``cuda``, which must be present).

    On the card, images cross between host and device through pinned
    staging buffers that the engine owns (``formats.PinnedStaging``), and
    ``compact_paths`` reads file *i + 1* on a ``PrefetchReader`` thread
    while image *i* is staged.  ``close()`` stops the reader and releases
    the buffers.

    ``compact_many`` takes several jobs at once (one a shard, from
    ``ShardedDB``'s queue) and stacks the jobs that share a
    ``scheduler.batch_signature`` into one batched pipeline
    (``batch_launches``, ``batch_jobs``, ``max_batch_jobs`` count them).

    One engine may be called from several threads: a store's flush
    workers and compaction worker in async mode, a shard's flush and the
    queue's compactions under ``ShardedDB``.  The staging buffers, the
    reader and the device timers are not built for two callers, so every
    public call runs under the engine's lock, one at a time: two flush
    workers' builds take turns there, and a build waits behind a running
    compaction (the card runs one job at a time anyway).  A flush's
    packing into host arrays happens before it takes the lock."""

    name = "torch"

    def __init__(self, geom: SSTGeometry, device=None,
                 sort_mode: str = "merge", tracer=None):
        self.geom = geom
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.device = resolve_device(device)
        self.executor = offload.CompactionExecutor(
            geom, device=self.device, sort_mode=sort_mode)
        self.staging = (formats.PinnedStaging(self.device)
                        if self.device.type == "cuda" else None)
        self._lock = threading.RLock()
        # a PrefetchReader, built at the first job
        self._reader = None           # guarded-by: _lock
        # stacked launches (of >= 2 jobs each), the jobs they took, and
        # the most jobs one took
        self.batch_launches = 0       # guarded-by: _lock
        self.batch_jobs = 0           # guarded-by: _lock
        self.max_batch_jobs = 0       # guarded-by: _lock
        # jobs (or stacked launches) run a second time on the card
        self.launch_retries = 0       # guarded-by: _lock

    def close(self):
        """Stop the file reader's thread and release the pinned buffers."""
        with self._lock:
            if self._reader is not None:
                self._reader.close()
                self._reader = None
            if self.staging is not None:
                self.staging.close()

    def _read_all_locked(self, paths: list[str]):
        """The host images of ``paths`` in order, file *i + 1* read on the
        reader's thread while the caller stages image *i*."""
        from repro_torch.core.background import PrefetchReader
        from repro_torch.lsm import sstable
        if self._reader is None:
            self._reader = PrefetchReader()
        return self._reader.read_all(paths, sstable.read_sst)

    def _stage(self, images) -> list[SSTImage]:
        return [formats.image_from_numpy(im, self.device, self.staging)
                for im in images]

    def _run_locked(self, staged, host, real_blocks: int, bottom_level: bool,
                    t0: float) -> tuple[SSTImage, EngineStats]:
        """One job on the card from its ``staged`` images, run once more
        (staged again from the ``host`` images) when it raises or its
        verdict is negative.  The second attempt's error propagates and
        its verdict is returned as it is.  Every staging goes through
        ``PinnedStaging``, which waits for a buffer's last copy before it
        writes the buffer again, so a retry never overwrites a buffer that
        a failed attempt's copy still reads.  An error of the second
        attempt carries the first attempt's as its cause.
        ``SimulatedCrash`` is not an ``Exception`` and passes through."""
        first = None
        try:
            out, es = self._compact_staged_locked(
                staged, real_blocks, bottom_level=bottom_level, t0=t0)
            if es.crc_ok:
                return out, es
        except Exception as e:   # noqa: BLE001 - the one retry on the card
            first = e
        self.launch_retries += 1
        t0 = time.perf_counter()
        try:
            return self._compact_staged_locked(
                self._stage(host), real_blocks, bottom_level=bottom_level,
                t0=t0)
        except Exception as e:
            if first is None:
                raise
            raise e from first

    def compact(self, images: list[SSTImage], *, bottom_level: bool = False
                ) -> tuple[SSTImage, EngineStats]:
        """Compact host images (numpy); returns a host image."""
        with self._lock:
            t0 = time.perf_counter()
            real = sum(np.asarray(im.keys).shape[0] for im in images)
            return self._run_locked(self._stage(images), images, real,
                                    bottom_level, t0)

    def compact_paths(self, paths: list[str], *, bottom_level: bool = False
                      ) -> tuple[SSTImage, EngineStats]:
        """Compact straight from SST files, double-buffering the reads:
        while image *i* is staged, the reader thread reads file *i + 1*.
        A retry stages the images read once more."""
        with self._lock:
            t0 = time.perf_counter()
            host, imgs = [], []
            with self.tracer.span("compact.read_inputs", files=len(paths)):
                for im in self._read_all_locked(paths):
                    host.append(im)
                    imgs.append(formats.image_from_numpy(im, self.device,
                                                         self.staging))
            return self._run_locked(imgs, host,
                                    sum(im.keys.shape[0] for im in host),
                                    bottom_level, t0)

    def compact_many(self, jobs: list[tuple[list[str], bool]]
                     ) -> list[tuple[SSTImage, EngineStats]]:
        """Compact several independent jobs, ``[(input_paths,
        bottom_level)]`` (one a shard, from ``ShardedDB``'s queue),
        stacking the jobs of one ``scheduler.batch_signature`` (their
        input block counts after the pow2 padding, and ``bottom_level``)
        into one batched pipeline (``CompactionExecutor.compact_many``);
        a job alone in its signature takes the single-job path.  Results
        come back in input order, each bit-identical to ``compact_paths``
        of that job.  A job of a batch whose inputs fail the CRC is run
        again alone for its verdict; a stacked launch that raises runs
        its jobs again one by one (one ``launch_retries``), each with the
        single-job path's retry.  A launch that still fails raises, noting
        the stacked launch's error: there is no CPU engine behind this
        one."""
        from repro_torch.core.scheduler import batch_signature
        with self._lock:
            t_many0 = self.tracer.now()
            t_read0 = time.perf_counter()
            flat_paths = [p for paths, _ in jobs for p in paths]
            with self.tracer.span("compact.read_inputs",
                                  files=len(flat_paths)):
                flat = list(self._read_all_locked(flat_paths))
            read_share = (time.perf_counter() - t_read0) / max(1, len(jobs))
            job_imgs, off = [], 0
            for paths, _ in jobs:
                job_imgs.append(flat[off:off + len(paths)])
                off += len(paths)
            groups: dict[tuple, list[int]] = {}
            for j, (_, bottom) in enumerate(jobs):
                sig = batch_signature(
                    [im.keys.shape[0] for im in job_imgs[j]], bottom,
                    sort_mode=self.executor.sort_mode)
                groups.setdefault(sig, []).append(j)
            results: list = [None] * len(jobs)
            for sig, idxs in groups.items():
                if len(idxs) == 1:
                    j = idxs[0]
                    results[j] = self._single_locked(
                        job_imgs[j], jobs[j][1], read_share)
                    continue
                try:
                    batch = self._compact_batched_locked(
                        [job_imgs[j] for j in idxs], bucket=sig[1],
                        bottom_level=jobs[idxs[0]][1],
                        read_share=read_share)
                except Exception as stacked:   # noqa: BLE001 - one by one
                    self.launch_retries += 1
                    try:
                        for j in idxs:
                            results[j] = self._single_locked(
                                job_imgs[j], jobs[j][1], read_share)
                    except Exception as e:
                        # a single job's own first error may be its cause
                        e.add_note(f"the stacked launch of {len(idxs)} "
                                   f"jobs raised first: {stacked!r}")
                        raise
                    continue
                for j, res in zip(idxs, batch):
                    if not res[1].crc_ok:
                        # the single-job path gives its own verdict
                        res = self._single_locked(job_imgs[j], jobs[j][1],
                                                  read_share)
                    results[j] = res
            if self.tracer.enabled:
                self.tracer.complete(
                    "compact_many", t_many0, self.tracer.now() - t_many0,
                    args={"jobs": len(jobs), "groups": len(groups)})
            return results

    def _single_locked(self, images, bottom_level: bool, read_share: float):
        """One read job of ``compact_many`` through the single-job path
        (with its retry)."""
        t0 = time.perf_counter()
        out, es = self._run_locked(self._stage(images), images,
                                   sum(im.keys.shape[0] for im in images),
                                   bottom_level, t0)
        es.host_seconds += read_share
        return out, es

    def _compact_batched_locked(self, group_imgs, *, bucket: int,
                                bottom_level: bool, read_share: float):
        """One stacked launch over >= 2 jobs of one signature.  Each job's
        ``device_seconds`` and ``sort_seconds`` are the launch's CUDA-event
        spans divided by the jobs; its ``host_seconds`` the launch's host
        time divided likewise, plus its share of the reads."""
        t0 = time.perf_counter()
        staged = []
        for images in group_imgs:
            imgs = self._stage(images)
            if self.executor.sort_mode == "merge":
                imgs = [offload.pad_image_blocks(
                    im, offload.next_pow2(im.keys.shape[0]), self.geom)
                    for im in imgs]
            staged.append(imgs)
        n_jobs = len(staged)
        self.batch_launches += 1
        self.batch_jobs += n_jobs
        self.max_batch_jobs = max(self.max_batch_jobs, n_jobs)
        timer = DeviceTimer(self.device)
        t_exec = time.perf_counter()
        t_exec_ns = self.tracer.now()
        marks = self._marks()
        with timer.span("pipeline"):
            faults.fire("engine.launch")
            outs = self.executor.compact_many(
                staged, bottom_level=bottom_level, pad_blocks=bucket,
                timer=timer)
            faults.fire("engine.crc")
        if marks is not None:
            marks = (marks, self._marks())
        host = formats.images_to_numpy([out for out, _ in outs],
                                       self.staging)
        exec_wall = time.perf_counter() - t_exec
        host_share = max(time.perf_counter() - t0 - exec_wall,
                         0.0) / n_jobs
        wire = self.geom.wire_words_per_block * 4
        device_s = timer.seconds("pipeline") / n_jobs
        sort_s = timer.seconds("sort") / n_jobs
        results = []
        for out, (_, s), raw in zip(host, outs, group_imgs):
            stats = EngineStats(
                n_input=s.n_input, n_live=s.n_live, n_dropped=s.n_dropped,
                crc_ok=s.crc_ok,
                bytes_in=sum(im.keys.shape[0] for im in raw) * wire,
                bytes_out=s.bytes_out, batched=True)
            stats.host_seconds = host_share + read_share
            stats.device_seconds = device_s
            stats.sort_seconds = sort_s
            results.append((out, stats))
        if self.tracer.enabled:
            self._trace_launch("compact.batch_launch", t_exec_ns, timer,
                               marks, jobs=n_jobs, bucket=bucket)
        return results

    def _compact_staged_locked(self, imgs, real_blocks, *, bottom_level,
                               t0):
        if self.executor.sort_mode == "merge":
            # each run to a pow2 block count, as the JAX engine pads
            imgs = [offload.pad_image_blocks(
                im, offload.next_pow2(im.keys.shape[0]), self.geom)
                for im in imgs]
        bucket = offload.next_pow2(sum(im.keys.shape[0] for im in imgs))
        timer = DeviceTimer(self.device)
        t_exec = time.perf_counter()
        t_exec_ns = self.tracer.now()
        marks = self._marks()
        with timer.span("pipeline"):
            faults.fire("engine.launch")
            out, s = self.executor.compact(imgs, bottom_level=bottom_level,
                                           pad_blocks=bucket, timer=timer)
            faults.fire("engine.crc")
        if marks is not None:
            marks = (marks, self._marks())
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
        if self.tracer.enabled:
            self._trace_launch("compact.execute", t_exec_ns, timer, marks,
                               jobs=1, bucket=bucket)
        return out, stats

    def _marks(self):
        """``ops.launch_marks()`` where a traced pipeline on the card needs
        them to tell a shared stream, else None."""
        if self.tracer.enabled and self.device.type == "cuda":
            return ops.launch_marks()
        return None

    def _trace_launch(self, name: str, t0_ns: int, timer: DeviceTimer,
                      marks, **args):
        """Record the launch span ``name`` from ``t0_ns`` (its output is on
        the host by now) and, nested in it from its start, the pipeline's
        three phases (``PHASE_SPANS``) as ``timer`` measured them.  The
        children keep JAX's clamp: where their sum overruns the launch
        span's wall they are scaled down to fit (``"scale"`` in their
        args).  ``marks``: ``launch_marks`` before and after the pipeline
        (None on the CPU or untraced); the children say ``"stream": "shared"`` when
        another thread launched in between."""
        tr = self.tracer
        wall_ns = tr.now() - t0_ns
        tr.complete(name, t0_ns, wall_ns, args=args)
        phases = timer.phases("pipeline", "sort")
        if phases is None or sum(phases) <= 0.0:
            return
        scale = min(1.0, wall_ns / 1e9 / sum(phases))
        child = {"clock": timer.clock}
        if marks is not None:
            (all0, own0), (all1, own1) = marks
            if all1 - all0 > own1 - own0:
                child["stream"] = "shared"
        if scale < 1.0:
            child["scale"] = scale
        cur = t0_ns
        for phase, seconds in zip(PHASE_SPANS, phases):
            dur = int(seconds * scale * 1e9)
            tr.complete(phase, cur, dur, args=dict(child))
            cur += dur

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
        with self._lock:
            img = offload.build_image(
                *formats.words_to_tensors([keys, meta, vals], self.device,
                                          staging=self.staging),
                n, geom=self.geom)
            return formats.image_to_numpy(img, self.staging)
