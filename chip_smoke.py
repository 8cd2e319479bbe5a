#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port of the LUDA store (and of the
model server beside it) on one GPU.

    python3 chip_smoke.py        (from the repository root)

Phases, any fault exits non-zero:

1. identify the card and build the CUDA kernels from ``src/repro_torch``;
2. hold each kernel against its plain PyTorch version at the shapes of the
   store's main paths, bit for bit, and time both (CUPTI device time and
   CUDA events around one call); the merge also at disjoint, ragged and
   tile-edge runs, with one launch a level of its merge tree; the read
   kernels also at their edges, one launch a call; the sort and the bloom
   build at their edges (``SORT_EDGES``, ``BLOOM_EDGES``), the sort with
   the launches its plan names, the build with one; PyTorch's nearest
   route to the sort timed beside it, and the same call (``torch.unique``
   between two sign flips) as the merge's library time; the card's launch
   floor (a
   one-element fill) beside the small kernels;
3. drive the store (``repro_torch.lsm.db.LsmDB``) at the paper's geometry:
   a seeded bulk load, a YCSB-A mix, deletes, compactions, reads and
   batched ``multi_get``s (one through a snapshot) checked against the
   ``get`` loop and a dict of acknowledged writes, close, reopen (cold
   block cache), and the reads again; every kernel of the write and read
   paths must have launched during this phase, the merge once a level of
   each job's merge tree; one ``multi_get`` batch traced, cold and warm:
   each stage of a wave one copy over, one kernel, one copy back;
4. run one real compaction job of phase 3 through the engine on ``cuda``
   (``sort_mode="merge"`` and ``"device"``, the bitonic sort), on ``cpu``
   and through the numpy baseline (``CpuCompactionEngine``): the output
   images must be byte-identical (padding blocks trimmed where the two
   pad differently); split the ``cuda`` job's device time by kernel
   (CUPTI trace), in both sort modes, its image copies through pinned
   staging;
5. serve falcon-mamba-7b at full width and depth
   (``repro_torch.serving.engine.ServeEngine``): the selective-scan kernel
   against its plain version at the serving shapes (and at one long
   sequence), 4 requests of 512 prompt tokens and 16 new tokens with one
   kernel launch per layer of the prefill, prefill-then-decode against a
   longer prefill, and the prefill with the kernel against the prefill
   with the plain scan; decode timed eagerly (``model.decode_step``) and
   as the engine's captured step (one CUDA graph), with equal greedy
   tokens;
6. the paper's evaluation (``repro_torch.launch.ycsb.run`` at
   ``configs.luda_paper.PAPER``): YCSB-A at each of the paper's value
   sizes, 9 memtables of records and as many operations, on the LUDA
   store (the device engine on ``cuda``) and on the CPU baseline
   (``DBConfig(engine="cpu")`` on ``device="cpu"``); every read and a full
   scan checked against the acknowledged writes, the two stores' SST files
   byte-identical, the store kernels launched by LUDA and none by the
   baseline; a row per store and a LUDA / baseline line per value size;
7. page phase 5's served session (falcon-mamba-7b's ``(cache, pos)`` of 4
   requests, 146,800,656 B) through an ``LsmDB`` on ``cuda`` at the
   serving launcher's geometry (4 KiB values, 32 KiB blocks) with
   ``ServeEngine.save_session``: one ``write_batch`` of 35,912 records,
   a flush and the compactions it triggers; load it back bit for bit
   with ``load_session`` and ``load_sessions``; resume 8 captured decode
   steps from it against an uninterrupted run; save over it, compact the
   superseded pages away, reopen, load and drop; every kernel of the
   session's path must have launched; and a seeded 4 MiB state paged
   through a ``cuda`` and a ``cpu`` store must give the same SST files;
8. drive the sharded store (``repro_torch.lsm.sharded.ShardedDB``, 4
   shards split over the YCSB load keys, at the paper's geometry): two
   deterministic rounds of 4 full memtables a shard and a
   ``maybe_compact()`` each, the first one stacked launch of 4 same-shape
   L0->L1 jobs (262,144 rows; the merge in the one job's 2 launches), each
   job byte-identical to its rerun alone on the plain versions and each
   batched kernel call to the plain batched version; the first round's
   jobs again as one ``sort_mode="device"`` batch, and stacked against
   one at a time; then a background round (``auto_compact=True``, the
   queue draining while the caller writes) and a YCSB-A mix, every
   acknowledged write read back by a scan across the shards (the mix's
   writes and a sample of the loads by ``get`` and ``multi_get`` too),
   before and after a reopen;
9. drive the async write path (``DBConfig(async_compaction=True)``) at the
   paper's geometry at 1,024 B values: (a) one seeded stream of puts and
   deletes (8 full memtables and more) into a sync and an async store
   (``flush_workers=3``, ``auto_compact=False``): byte-identical SST
   files after ``wait_idle()`` and again after ``maybe_compact()`` +
   ``wait_idle()`` (that drain's CUPTI device time beside its CUDA-event
   spans), every write-path kernel launched from the workers, the merge
   once a level of each job's merge tree, a flush's wait at the engine
   lock behind a running compaction, and the async store's jobs and
   first flushes rebuilt byte-identical on the plain versions and its
   read-back's wave calls bit-identical to them; (b) YCSB-A through
   ``launch.ycsb.run``, sync against async on the same op streams (9
   memtables of records and as many operations), a row a mode and the
   async / sync p99 put; (c) in both, two reader threads ``get`` and
   ``multi_get`` a fixed key sample beside the writer, every value one
   issued to that key and none stale, ``bloom_multi_probe`` and
   ``lookup_blocks`` launched on them while a background compaction ran,
   the async run's first reader wave calls bit-identical to the plain
   versions;
   (d) one ``build_image`` made to raise: ``BackgroundError`` at
   ``wait_idle()`` and the next rotation, the queued tables readable, L0
   held, then ``resume()``: every write back and the L0 files a sync
   store's; (e) an async ``ShardedDB`` of 4 shards under YCSB-A read back
   by scan, ``get`` and ``multi_get`` before and after a reopen; (f) a 4
   MiB served state saved into an async store whose flush builds inside
   the CUDA graph capture of a new decode batch size: tokens equal an
   eager run's, the state loads back bit for bit;
10. the store's durability contract on the card, on the LUDA store
   (``DBConfig(engine="device")``) at the default ``SSTGeometry`` (the
   paper's 16 B keys, 256 B values, 4 KB blocks), cut in scale to the
   crash matrix's 640 B memtables and 600 operations a cell: (a) every
   cell of ``repro_torch.testing.crashmatrix`` (failpoint x {sync, async,
   sharded}) crashes at its point and passes, each recovered store's
   ``multi_get`` of every acknowledged key equal to its ``get`` loop and
   its first wave calls bit-identical to the plain versions, every store
   kernel launched, no launch retry; (b) sabotage fails in every mode;
   (c) one injected launch fault is absorbed by one ``launch_retries`` (a
   sync store, and a stacked round of 2 shards, whose jobs run again one
   by one, its batched calls bit-identical to the plain batched versions)
   with the clean store's files; (d) a
   persistent one raises (sync) or halts the async store after its
   retries, no CPU engine built, and ``resume()`` recovers the clean
   files; (e) two failed flush builds are retried, the files a sync
   store's; (f) ``WriteOptions(wait_stall=False)`` sheds at a full queue;
   (c)-(f) read back by ``multi_get``, its first wave calls held against
   the plain versions, and no store without an engine failpoint retries a
   launch; (g) (a)'s jobs and first flushes rebuilt byte-identical on the
   plain versions.

11. metrics and tracing on the card (``repro_torch.obs``) at the paper's
   geometry at 256 B values: (a) YCSB-A through ``launch.ycsb.run`` as
   phase 6 sizes it, on a sync store with a ``MetricsRegistry`` and a
   ``Tracer``: the ``lsm.*`` counters equal ``DBStats``, the put
   histogram counts every put and the launcher's p99 estimate is within
   2**0.5 of the exact p99, spans nest, each launch span holds its three
   child phases timed by the pipeline's CUDA events, whose sum over the
   jobs equals ``compact_device_seconds`` within 1 %; (b) an async store
   (``flush_workers=3``) with two reader threads whose ``get`` and
   ``multi_get`` counts come out exact, its exported trace read by
   ``python -m repro_torch.obs.report``; (c) a 2-shard ``ShardedDB``
   whose round is one stacked launch of 2 jobs, its per-shard histograms
   merged; (d) a ``ServeEngine`` over a page store, taking the store's
   registry and tracer, with nothing recorded inside a decode capture;
   the kernels each part launched held against their plain versions;
   (e) the cost of tracing: put p50 / p99 and one L0->L1 job, traced
   against untraced, and the CUDA events a job records either way (the
   same).

12. the model zoo's attention, MoE and encoder-decoder archs on the card
   (bf16 compute, random weights from a seed, each model freed before the
   next, its peak memory printed): (a) gemma3-4b (34 layers, windows of
   1,024 with every 6th layer global, a tied vocab of 262,144) and (b)
   granite-moe-3b-a800m (32 layers, 40 experts, top-8) at full width and
   depth served as phase 5 serves falcon: 4 requests of 512 prompt tokens
   and 16 new, captured decode's tokens equal to eager's, prefill-then-
   decode against the longer prefill, prefill and decode timed beside the
   decode step's bound (its weights over the HBM rate), (b)'s capacity
   drops counted; (a) also the ring wrap: 1,000 prompt tokens and 48
   teacher-forced captured steps past the windowed layers' 1,024 slots,
   each step's logits against ``forward``; (c) card against CPU at fp32
   compute and scan, the same weights: gemma3-4b cut to 6 layers,
   granite-moe to 2, falcon-mamba-7b to 4, at full width, the MoE
   routings equal and the logits within 1e-3 of the largest; (d) every
   other arch once (a prefill and 8 decode steps; qwen3-14b, yi-34b,
   granite-20b, phi3.5-moe and internvl2-26b at full width cut to 2
   layers, whisper-medium whole over 1,500 frames, jamba at its smoke
   config), finite, prefill-then-decode within 5e-2, the served ones
   captured = eager; (e) one gemma3 request's ``(cache, pos)`` paged
   through the store as phase 7 pages falcon's, loaded bit for bit and
   resumed as an uninterrupted run.

13. training on the card (``repro_torch.training``, the checkpoint store
   ``repro_torch.checkpoint.store`` on the LUDA store, bf16 compute with
   fp32 master weights and moments): the selective-scan backward kernel
   against the plain backward (autograd through the plain scan) at 4 x
   512 and 1 x 4,096, timed, and at its segment, chunk and channel-block
   edges (``SCAN_BWD_EDGES``), each rerun bit for bit; (a) falcon-mamba-7b
   at full width cut to 4 layers, 6 ``train_step``s of 4 x 512
   ``BigramStream`` tokens timed by CUDA events beside the step's bound,
   the loss falling and the gradient norm finite, the scan launched twice a layer a step (the forward and
   remat's recompute) and its backward once, the last step's last-layer
   backward held against the plain one on its kept inputs and rerun bit
   for bit; (b) the same model cut to 2 layers and d_model 64 (the vocab
   kept) through ``Trainer`` with checkpoints every 3 of 8 steps, once
   uninterrupted and once under ``Supervisor`` with a failure at step 5:
   the resumed losses equal the uninterrupted ones bit for bit, the last
   restore equals the saved state, ``steps()`` is ``[6, 8]``, the
   compactions dropped records that ``gc``'s tombstones shadowed, kept
   jobs and flushes are byte-identical on the plain versions, and a cpu
   store writes the same SST files; (c) ``python -m
   repro_torch.launch.train --smoke --fail-at 5`` prints ``restarts=1``.
14. the distributed layer on the card (``repro_torch.distributed``,
   ``launch.mesh``, ``serving.serve_step``, ``offload.sharded_compact``):
   (a) in a one-rank NCCL world on a (1, 1) mesh, ``shard_train_step`` on
   phase 13 (a)'s model and batches for 3 steps against ``train_step``
   (bit for bit or within the updates' bound, the scan's launches counted,
   the step timed by CUDA events), falcon-mamba-7b whole through
   ``shard_prefill`` / ``shard_decode_step`` (the greedy tokens equal
   phase 5's), one job of 65,536 rows through ``sharded_compact``
   (byte-identical to ``compaction.compact`` on cuda and on cpu); (b) four
   ranks sharing the card over gloo: 4 range shards through
   ``sharded_compact`` (each rank's shard as compacted alone, every kernel
   of a device-sort compaction launched on each), the scan's DTensor
   wrapper on a (2, 2) mesh against the whole scan (its partial ``dB`` /
   ``dC`` reduced over "model"), EP MoE against the dense path, and the
   int8 compressed mean; a rank that fails or dies ends the world.

Phases 3-9, 11, 12 and 13 fail if a compaction engine built in them
retried a launch: no engine failpoint is armed outside phase 10.

The line before the last is a JSON ``kernels`` record (each kernel's
``launches`` sums phase 3's paths, phase 9's, phase 10's, phase 11's,
phase 12's, phase 13's and phase 14's, split in ``launches_by_path``); the
last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.

    python3 chip_smoke.py --kernels

runs phases 1 and 2's timed cases and row 9b's two cases (the
selective-scan backward at 4 x 512 and 1 x 4,096) only (no edge tables, no
``ok`` line), so that a copy of this script placed in another checkout
times that checkout's kernels on the same cases.
"""

from __future__ import annotations

import binascii
import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.luda_paper import PAPER  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.core.formats import SSTGeometry  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.data.ycsb import (  # noqa: E402
    WorkloadSpec, YCSBWorkload, key_of)
from repro_torch.kernels import _build, merge_path, ops, ref  # noqa: E402
from repro_torch.kernels import bitonic_sort as sort_plan  # noqa: E402
from repro_torch.launch import dryrun, ycsb  # noqa: E402
from repro_torch.lsm import ReadOptions, sstable  # noqa: E402
from repro_torch.lsm.cpu_engine import CpuCompactionEngine  # noqa: E402
from repro_torch.lsm.db import DBConfig, LsmDB  # noqa: E402
from repro_torch.lsm.engine import (  # noqa: E402
    PHASE_SPANS, TorchCompactionEngine)
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import tree_leaves, tree_map  # noqa: E402
from repro_torch.roofline import constants as h100  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.session_store import (  # noqa: E402
    LsmSessionStore, encode_state)

# LUDA §IV-A (configs.luda_paper): 16 B keys, 256 B values (+16 B slot
# header room), 4 KB blocks, 4 MB SSTs, 10 bloom bits per key; L0 compacts
# at 4 files, L1 holds 32 MB
PAPER_GEOM = PAPER.geometry(256)
PAPER_SCHED = PAPER.scheduler()

# the card's rates (NVIDIA H100 SXM data sheet, repro_torch.roofline.
# constants): HBM3, and the scalar (non-tensor-core) 32-bit rate, used for
# integer and fp32 work; the special-function units give 16 exponentials a
# clock per SM (compute capability 9.0), at the clock nvidia-smi reports
HBM_BYTES_PER_S = h100.HBM_BW
SCALAR_OPS_PER_S = h100.SCALAR_OPS_PER_S
SFU_PER_CLOCK_PER_SM = h100.SFU_PER_CLOCK_PER_SM
H100_SMS = h100.H100_SMS

KERNELS = {
    # name: (C entry point, phase-2 case, source, the TPU kernel replaced)
    "crc32_sections": ("crc32_sections", "crc32_sections",
                       "src/repro_torch/kernels/csrc/crc32.cu",
                       "src/repro/kernels/crc32.py:26"),
    "merge_runs": ("merge_runs", "merge_runs/65536",
                   "src/repro_torch/kernels/csrc/merge_path.cu",
                   "src/repro/kernels/merge_path.py:87"),
    "prefix_encode": ("prefix_encode", "prefix_encode/wire",
                      "src/repro_torch/kernels/csrc/prefix.cu",
                      "src/repro/kernels/prefix.py:24"),
    "bloom_build": ("bloom_build", "bloom_build",
                    "src/repro_torch/kernels/csrc/bloom.cu",
                    "src/repro/kernels/bloom.py:25"),
    "bloom_multi_probe": ("bloom_multi_probe", "bloom_multi_probe/256",
                          "src/repro_torch/kernels/csrc/bloom.cu",
                          "src/repro/kernels/bloom.py:138"),
    "lookup_blocks": ("lookup_blocks", "lookup_blocks/256",
                      "src/repro_torch/kernels/csrc/lookup.cu",
                      "src/repro/kernels/lookup.py:48"),
    "bloom_query": ("bloom_query", "bloom_query",
                    "src/repro_torch/kernels/csrc/bloom.cu",
                    "src/repro/kernels/bloom.py:83"),
    "bitonic_sort": ("bitonic_sort", "bitonic_sort/65536",
                     "src/repro_torch/kernels/csrc/bitonic.cu",
                     "src/repro/kernels/bitonic_sort.py:55"),
    "selective_scan": ("selective_scan", "selective_scan/4x512",
                       "src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:31"),
    # no Pallas kernel: JAX takes this gradient by autodiff through the
    # associative scan of its training path
    "selective_scan_bwd": ("selective_scan_bwd", "selective_scan_bwd/4x512",
                           "src/repro_torch/kernels/csrc/"
                           "selective_scan_bwd.cu",
                           "src/repro/models/mamba.py:77"),
}
# kernels of the write path (flush, compaction) and of multi_get, which
# phase 3 drives; the bitonic sort runs in phase 4 (sort_mode="device"),
# and no path calls bloom_query (as in the JAX package)
STORE_PATH = ("crc32_sections", "merge_runs", "prefix_encode",
              "bloom_build", "bloom_multi_probe", "lookup_blocks")
# the kernels of a flush and a compaction, which phase 6's LUDA runs drive
WRITE_PATH = ("crc32_sections", "merge_runs", "prefix_encode", "bloom_build")
# the kernels of a multi_get wave: the bloom prune, the search and gather
READ_PATH = ("bloom_multi_probe", "lookup_blocks")
# why each kernel has no library_ms
NO_LIBRARY = "no single PyTorch call computes it"
MULTI_GET_BATCH = 256
# phase 2's pack-shaped prefix case: 65,536 rows, of them 61,440 survivors
PREFIX_COUNT = 61_440
# phase 8: a ShardedDB of 4 shards, each round a stacked launch of 4 jobs
BATCH_JOBS = 4
# phase 5: falcon-mamba-7b serving 4 requests of 512 prompt tokens, 16 new
# tokens each; the scan also at one request of 4,096 tokens
FALCON = "falcon-mamba-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 16
SCAN_SHAPES = ((SERVE_BATCH, SERVE_PROMPT), (1, 4096))
# the kernel against its plain version: max abs error <= SCAN_TOL of the
# largest |y| (and of the largest |h_last|): both scan in fp32, and differ
# in expf's last bits and the order of the h . C sum
SCAN_TOL = 1e-4
BF16_ULP = 2.0 ** -7   # a bf16 ulp is at most this share of the value
# last logits of two routes through the bf16 model (prefill-then-decode
# against prefill; kernel scan against plain scan): max abs difference <=
# LOGIT_TOL of the largest |logit|.  The routes round bf16 activations at
# other places (other GEMM shapes, expf against torch.exp), and a flipped
# bf16 ulp (2**-8) travels through the residual stream of all 64 layers
LOGIT_TOL = 5e-2


def log(*a):
    print(*a, flush=True)


def as_i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint32)).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def call_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call of ``fn`` in ms, after two
    warm-up calls.  For a small kernel this is mostly the host's launch
    path (the stream waits for the host between the two events)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, *, with_events: bool = False):
    """Device time per call of ``fn`` in ms: the summed durations of the
    kernels (and copies) it runs, from the profiler's CUPTI trace, so the
    host's launch path is left out.  ``with_events``: also the device
    events (kernels and copies) a call, from the same trace."""
    fn()
    torch.cuda.synchronize()
    trace = device_trace(lambda: [fn() for _ in range(reps)])
    ms = sum(t for _, t in trace) / reps
    return (ms, len(trace) / reps) if with_events else ms


def sorted_keys(rng, n: int, lanes: int) -> np.ndarray:
    """Sorted big-endian key lanes sharing a "user" prefix, as the store's
    YCSB keys do."""
    k = rng.integers(0, 2**32, (n, lanes), dtype=np.uint32)
    k[:, 0] = 0x75736572
    k[:, 1] %= 1 << 12
    return k[np.lexsort(tuple(k[:, i] for i in reversed(range(lanes))))]


def tuple_runs(rng, run_rows: list[int], pad_rows: int,
               lanes: int) -> np.ndarray:
    """Phase-2 tuples ``<key, ~meta, index>``: sorted runs of real rows,
    then one run of all-ones padding rows."""
    parts = []
    for n in run_rows:
        keys = sorted_keys(rng, n, lanes)
        meta = ~((rng.integers(1, 2**30, n, dtype=np.uint32) << 1) | 1)
        parts.append(np.concatenate([keys, meta[:, None]], axis=1))
    parts.append(np.full((pad_rows, lanes + 1), 0xFFFFFFFF, np.uint32))
    rows = np.concatenate(parts)
    idx = np.arange(rows.shape[0], dtype=np.uint32)[:, None]
    return np.concatenate([rows, idx], axis=1)


def merge_levels(run_lens) -> int:
    """Levels of the pairwise merge tree: ceil(log2 k') for k' non-empty
    runs."""
    return (sum(1 for n in run_lens if n) - 1).bit_length()


def merge_cases(rng, dev):
    """Phase 2's further merge cases, (name, rows, run_lens), of phase-2
    tuples: 16 runs of 16,384 rows over disjoint key ranges in order (an
    L1->L2 job's inputs), 11 ragged runs with an empty and a one-row run,
    and runs of T - 1, T and T + 1 rows (T the kernel's tile) against a
    longer one."""
    L = PAPER_GEOM.key_lanes
    T = merge_path.TILE_ROWS
    lens = (16_384,) * 16
    cases = [("merge_runs/disjoint", as_i32(tuple_runs(
        rng, [sum(lens)], 0, L), dev), lens)]
    lens = (900, 0, 1, 5000, 37, T, 12_000, 0, 2, 3000, T + 1)
    cases.append(("merge_runs/ragged",
                  as_i32(tuple_runs(rng, list(lens), 0, L), dev), lens))
    for n in (T - 1, T, T + 1):
        lens = (n, 4 * T + 3)
        cases.append((f"merge_runs/tile{n - T:+d}",
                      as_i32(tuple_runs(rng, list(lens), 0, L), dev), lens))
    return cases


def check_merge_cases(dev, card: str, rng) -> None:
    """Phase 2: ``merge_runs`` against its plain version, bit for bit, at
    ``merge_cases``; each must take ceil(log2 k') launches; the disjoint
    case is timed too."""
    for name, rows, lens in merge_cases(rng, dev):
        before = ops.launch_counts()["merge_runs"]
        got = ops.merge_runs(rows, lens)
        launches = ops.launch_counts()["merge_runs"] - before
        torch.cuda.synchronize()
        err, shapes = compare_outputs(name, got, ref.merge_runs(rows, lens))
        if launches != merge_levels(lens):
            raise AssertionError(f"{name}: {launches} launches, not "
                                 f"{merge_levels(lens)}")
        timed = ""
        if name == "merge_runs/disjoint":
            def kern(r=rows, ln=lens):
                return ops.merge_runs(r, ln)
            bound = rows.numel() * 4 * 2 / HBM_BYTES_PER_S * 1e3
            timed = (f"; device time {device_ms(kern, 50):.4f} ms, bound "
                     f"{bound:.4f} ms (bytes), one call "
                     f"{call_ms(kern, 50):.4f} ms [{card}]")
        log(f"  {name:22s} shape {shapes}, {sum(1 for x in lens if x)} "
            f"runs: bit-identical (max abs err {err}); {launches} launches "
            f"a call{timed}")


def kernel_cases(rng, dev, merge_rows: dict | None = None):
    """(name, kernel call, plain call, bytes, operations) at the main
    path's shapes: a 4-SST L0 job of the paper geometry (4096 blocks,
    65,536 rows) and a 16-SST merge (262,144 rows).  Bytes count each
    input read once and each output written once; operations count what
    these inputs need (the CRC one table step a byte, whatever implements
    it; the prefix loop stops at the first differing lane, the bloom skips
    invalid slots).  ``merge_rows`` gets the merge cases' rows and run
    lengths by case name."""
    merge_rows = {} if merge_rows is None else merge_rows
    g = PAPER_GEOM
    B, K, L, Vw = 4096, g.block_kvs, g.key_lanes, g.value_words
    widths = (1, K * L, K, K * Vw, K)
    host = [rng.integers(0, 2**32, (B, w), dtype=np.uint32) for w in widths]
    sections = [as_i32(h, dev) for h in host]
    W = sum(widths)
    crc_bytes = 4 * B * W + 4 * B
    crc_ops = 4 * B * W   # one table step a byte
    cases = [("crc32_sections", lambda: ops.crc32_sections(sections),
              lambda: ref.crc32_words_sections(sections),
              crc_bytes, crc_ops)]

    for n_runs, run_rows, pad in ((4, 15_360, 4096), (16, 16_384, 0)):
        rows = as_i32(tuple_runs(rng, [run_rows] * n_runs, pad, L), dev)
        lens = [run_rows] * n_runs + [pad]
        n = rows.shape[0]
        merge_rows[f"merge_runs/{n}"] = (rows, lens)
        # a merge tree compares each row once a level, up to L + 2 lanes
        # (two operations a lane)
        cases.append((f"merge_runs/{n}",
                      lambda r=rows, ln=lens: ops.merge_runs(r, ln),
                      lambda r=rows, ln=lens: ref.merge_runs(r, ln),
                      2 * n * (L + 2) * 4,
                      n * merge_levels(lens) * 2 * (L + 2)))

    # the same merge for a batch of 4 jobs (phase 8's stacked L0 round):
    # one launch a level for all of them
    rows = torch.stack([as_i32(tuple_runs(rng, [15_360] * 4, 4096, L), dev)
                        for _ in range(BATCH_JOBS)])
    lens = [15_360] * 4 + [4096]
    n = rows.shape[0] * rows.shape[1]
    merge_rows[f"merge_runs/{BATCH_JOBS}x{rows.shape[1]}"] = (rows, lens)
    cases.append((f"merge_runs/{BATCH_JOBS}x{rows.shape[1]}",
                  lambda r=rows, ln=lens: ops.merge_runs(r, ln),
                  lambda r=rows, ln=lens: ref.merge_runs_batched(r, ln),
                  2 * n * (L + 2) * 4,
                  n * merge_levels(lens) * 2 * (L + 2)))

    n = 65_536
    keys_np = sorted_keys(rng, n, L)
    keys = as_i32(keys_np, dev)
    shared = ref.prefix_encode(keys, restart_interval=16).cpu().numpy()
    lanes_compared = np.minimum(shared // 4 + 1, L).sum()
    cases.append(("prefix_encode",
                  lambda: ops.prefix_encode(keys, restart_interval=16),
                  lambda: ref.prefix_encode(keys, restart_interval=16),
                  n * L * 4 + n * 4, int(4 * lanes_compared)))
    # the pack's route: survivors first, the rest zero (as `pack` leaves
    # them), the survivor count on the card; per lane a mask and an AND
    count = torch.tensor(PREFIX_COUNT, dtype=torch.int64, device=dev)
    keys_c = as_i32(np.where(np.arange(n)[:, None] < PREFIX_COUNT, keys_np,
                             0), dev)
    cases.append(("prefix_encode/wire",
                  lambda: ops.prefix_encode_wire(keys_c, count,
                                                 restart_interval=16),
                  lambda: ref.prefix_encode_wire(keys_c, count,
                                                 restart_interval=16),
                  n * L * 4 + 8 + n * 4 + n * L * 4,
                  int(4 * lanes_compared) + 5 * n * L))
    valid_c = torch.arange(n, device=dev) < count   # as `pack` has it
    # the pack's route for a batch of 4 jobs, one count a job, one launch
    counts = [PREFIX_COUNT, n, 0, n // 3][:BATCH_JOBS]
    bkeys_np = [np.where(np.arange(n)[:, None] < c, sorted_keys(rng, n, L),
                         0) for c in counts]
    keys_b = torch.stack([as_i32(k, dev) for k in bkeys_np])
    count_b = torch.tensor(counts, dtype=torch.int64, device=dev)
    compared = sum(int(np.minimum(ref.prefix_encode(
        as_i32(k, "cpu"), restart_interval=16).numpy() // 4 + 1, L).sum())
        for k in bkeys_np)
    cases.append((f"prefix_encode/wire{BATCH_JOBS}",
                  lambda: ops.prefix_encode_wire(keys_b, count_b,
                                                 restart_interval=16),
                  lambda: ref.prefix_encode_wire_batched(
                      keys_b, count_b, restart_interval=16),
                  BATCH_JOBS * (n * L * 4 + 8 + n * 4 + n * L * 4),
                  4 * compared + 5 * BATCH_JOBS * n * L))

    def before():
        return pack_prefix_before(keys_c, valid_c, ops.prefix_encode(
            keys_c, restart_interval=16))
    cases.append(("prefix_encode/before", before,
                  lambda: ref.prefix_encode_wire(keys_c, count,
                                                 restart_interval=16),
                  n * L * 4 + 8 + n * 4 + n * L * 4,
                  int(4 * lanes_compared) + 5 * n * L))

    bkeys = as_i32(rng.integers(0, 2**32, (B, K, L), dtype=np.uint32), dev)
    valid_np = rng.random((B, K)) < 0.94
    valid = torch.from_numpy(valid_np).to(dev)
    nw, probes = g.bloom_words(K), g.bloom_probes
    # per valid key: 2 FNV rounds a lane, two fmix32, and per probe a
    # multiply-add, a modulo, a shift and an OR; block filters, one group
    # of them alone (a launch's chain with no other work), then an SST's (4
    # SSTs of 16,384 keys, 5,120 words: the other route)
    for name, (G, per, words) in (("bloom_build", (B, K, nw)),
                                  ("bloom_build/1", (1, K, nw)),
                                  ("bloom_build/sst", (4, 16_384, 5_120))):
        if name != "bloom_build":
            bkeys = as_i32(rng.integers(0, 2**32, (G, per, L),
                                        dtype=np.uint32), dev)
            valid_np = rng.random((G, per)) < 0.94
            valid = torch.from_numpy(valid_np).to(dev)
        cases.append((name,
                      lambda k=bkeys, v=valid, w=words: ops.bloom_build(
                          k, v, n_words=w, n_probes=probes),
                      lambda k=bkeys, v=valid, w=words: ref.bloom_build(
                          k, n_words=w, n_probes=probes, valid=v),
                      G * per * (L * 4 + 1) + G * words * 4,
                      int(valid_np.sum()) * (L * 6 + 12 + probes * 5)))
    return cases, sections


def pack_prefix_before(keys_c: torch.Tensor, valid_c: torch.Tensor,
                       shared: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's two PyTorch lines that the wire route of
    ``prefix_encode`` replaced, after the shared-only kernel: the mask of
    the survivors, then ``formats.zero_prefix_lanes`` (15 PyTorch kernels
    on the card).  Timed beside the wire route; used nowhere in the
    port."""
    shared = torch.where(valid_c, shared, 0)
    return shared, formats.zero_prefix_lanes(keys_c, shared)


def probes_evaluated(filters: torch.Tensor, keys: torch.Tensor,
                     n_probes: int) -> int:
    """Probes that a test stopping at the first zero bit evaluates, summed
    over keys ``[G, Q, L]`` against filters ``[G, W]``: the probed words
    these inputs need."""
    h1, h2 = ref.bloom_hashes(keys)
    m = filters.shape[-1] * 32
    fw = ref.u32(filters)
    alive = torch.ones(h1.shape, dtype=torch.bool, device=keys.device)
    count = torch.zeros(h1.shape, dtype=torch.int64, device=keys.device)
    for i in range(n_probes):
        count += alive
        pos = ((h1 + i * h2) & ref.MASK32) % m
        word = torch.gather(fw, 1, pos >> 5)
        alive &= ((word >> (pos & 31)) & 1) == 1
    return int(count.sum())


def read_kernel_cases(rng, dev, sort_rows: dict | None = None):
    """The read path's kernels at a wave of 256 candidates of the paper
    geometry (K = 16 rows a block, L = 4, Vw = 68, 5 filter words and 6
    probes a block) -- the largest wave that ``multi_get``'s 256-key
    batches give, one candidate a key -- and again at 1,024 candidates;
    ``bloom_query`` at 1,024 groups x 256 queries; the bitonic sort of
    65,536 and 262,144 phase-2 rows.  The probe and lookup bounds count
    the bytes these inputs need, not the stacked rows: per candidate its
    key lanes and the probed words (the probes until the first zero bit),
    or its key lanes, the rows a binary search reads (log2 K + 1), the
    meta word and the value row where found.  The sort's bound counts the
    rows read once and written once, and the n log2 n row comparisons a
    sort needs (not the network's larger count).  ``sort_rows``, where
    given, receives the sort's inputs by row count."""
    g = PAPER_GEOM
    K, L, Vw = g.block_kvs, g.key_lanes, g.value_words
    nw, probes = g.bloom_words(K), g.bloom_probes
    hash_ops = L * 6 + 12
    G = 1024
    all_keys = as_i32(sorted_keys(rng, G * K, L).reshape(G, K, L), dev)
    all_filters = ref.bloom_build(all_keys, n_words=nw, n_probes=probes)
    cases = []
    for C in (MULTI_GET_BATCH, 1024):
        block_keys, filters = all_keys[:C], all_filters[:C]
        present = rng.random(C) < 0.5
        pick = block_keys[torch.arange(C, device=dev),
                          torch.from_numpy(rng.integers(0, K, C)).to(dev)]
        q = torch.where(torch.from_numpy(present).to(dev)[:, None], pick,
                        as_i32(sorted_keys(rng, C, L), dev))
        evaluated = probes_evaluated(filters, q[:, None], probes)
        cases.append((
            f"bloom_multi_probe/{C}",
            lambda f=filters, q=q: ops.bloom_multi_probe(f, q,
                                                         n_probes=probes),
            lambda f=filters, q=q: ref.bloom_multi_probe(f, q,
                                                         n_probes=probes),
            C * L * 4 + evaluated * 4 + C, C * hash_ops + evaluated * 5))

        # decoded blocks under the sentinel contract: nvalid < K in some,
        # 0 in one in sixteen; queries present (70 %) or absent
        nvalid_np = np.where(rng.random(C) < 0.2, rng.integers(1, K, C),
                             K).astype(np.int32)
        nvalid_np[rng.random(C) < 1 / 16] = 0
        keys_np = block_keys.cpu().numpy().view(np.uint32).copy()
        for i in range(C):
            keys_np[i, nvalid_np[i]:] = 0xFFFFFFFF
        lk = as_i32(keys_np, dev)
        meta = as_i32(rng.integers(0, 2**32, (C, K), dtype=np.uint32), dev)
        vals = as_i32(rng.integers(0, 2**32, (C, K, Vw), dtype=np.uint32),
                      dev)
        nvalid = torch.from_numpy(nvalid_np).to(dev)
        lq = torch.where(
            torch.from_numpy(rng.random(C) < 0.7).to(dev)[:, None],
            block_keys[:, 0], as_i32(sorted_keys(rng, C, L), dev))
        args = (lk, meta, vals, nvalid, lq)
        n_found = int(ref.lookup_blocks(*args)[0].sum())
        steps = K.bit_length()
        cases.append((
            f"lookup_blocks/{C}", lambda a=args: ops.lookup_blocks_packed(*a),
            lambda a=args: ref.lookup_blocks_packed(*a),
            C * (L * 4 + steps * L * 4 + 4) + n_found * (4 + Vw * 4) +
            C * (1 + 4 + Vw * 4), C * steps * 2 * L + n_found * Vw))

    Q = 256
    gq = as_i32(rng.integers(0, 2**32, (G, Q, L), dtype=np.uint32), dev)
    gq[:, :K] = all_keys
    evaluated = probes_evaluated(all_filters, gq, probes)
    cases.append(("bloom_query",
                  lambda: ops.bloom_query(all_filters, gq, n_probes=probes),
                  lambda: ref.bloom_query(all_filters, gq, n_probes=probes),
                  G * nw * 4 + G * Q * (L * 4 + 1),
                  G * Q * hash_ops + evaluated * 5))

    for n in (65_536, 262_144):
        rows = torch.from_numpy(tuple_runs(rng, [n], 0, L).view(np.int32))
        rows = rows[torch.from_numpy(rng.permutation(n))].contiguous().to(dev)
        if sort_rows is not None:
            sort_rows[n] = rows
        # n log2 n row comparisons of up to L + 2 lanes, two operations a
        # lane
        cases.append((f"bitonic_sort/{n}",
                      lambda r=rows: ops.bitonic_sort(r),
                      lambda r=rows: ref.sort_tuples(r),
                      2 * n * (L + 2) * 4,
                      n * (n.bit_length() - 1) * 2 * (L + 2)))
    return cases


# The read kernels' edge cases, shared with the tests: lookup block shapes
# (K, lanes, Vw) -- K = 1, a ballot chunk edge (33), two chunks and a bit
# (70); L = 8 takes 16-byte loads, L = 10 the run-time-lanes path -- and
# probe cases (filter words, probes): short rows whole in registers, long
# ones probed in batches of 8 (10 probes take a second batch).
EDGE_SHAPES = [(k, lanes, vw) for k in (1, 16, 33, 70) for lanes in (2, 4)
               for vw in (3, 68)] + [(16, 8, 68), (33, 10, 5)]
PROBE_EDGES = [(5, 1), (5, 6), (5, 10), (13, 1), (13, 6), (5120, 1),
               (5120, 6), (5120, 10)]


def edge_blocks(rng, c: int, k: int, lanes: int, vw: int):
    """numpy ``(keys, meta, vals, nvalid, queries)``, uint32 but ``nvalid``
    int32: ``c`` sorted blocks with duplicated rows, the all-ones sentinel
    at and after ``nvalid`` (0 and ``k`` among them), and queries cycling
    through: the first row, the last valid row, a duplicated row (the
    leftmost must win), an absent key and the sentinel."""
    keys = rng.integers(0, 6, (c, k, lanes)).astype(np.uint32)
    nvalid = rng.integers(1, k + 1, c).astype(np.int32)
    nvalid[0::6], nvalid[1::6] = 0, k
    queries = rng.integers(0, 6, (c, lanes)).astype(np.uint32)
    for i in range(c):
        if k > 1:   # a duplicated row
            j = int(rng.integers(0, k - 1))
            keys[i, j + 1] = keys[i, j]
        keys[i] = keys[i][np.lexsort(keys[i].T[::-1])]
        n = nvalid[i]
        kind = i % 5
        if kind == 0 and n > 0:
            queries[i] = keys[i, 0]
        elif kind == 1 and n > 0:
            queries[i] = keys[i, n - 1]
        elif kind == 2 and n > 1:
            dup = np.nonzero((keys[i, 1:n] == keys[i, :n - 1]).all(-1))[0]
            queries[i] = keys[i, dup[0] if len(dup) else 0]
        elif kind == 4:
            queries[i] = 0xFFFFFFFF
        keys[i, n:] = 0xFFFFFFFF
    meta = rng.integers(0, 2**32, (c, k), dtype=np.uint32)
    vals = rng.integers(0, 2**32, (c, k, vw), dtype=np.uint32)
    return keys, meta, vals, nvalid, queries


def one_launch(entry: str, fn):
    """``fn()``, raising unless it made exactly one launch of ``entry``
    and none of another kernel."""
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    made = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    if made != {entry: 1}:
        raise AssertionError(f"{entry}: one call made launches {made}")
    return out


def check_read_edges(dev) -> int:
    """The read kernels at their edges, bit for bit and one launch a
    call: ``lookup_blocks`` (both forms) at ``EDGE_SHAPES``;
    ``bloom_multi_probe`` and ``bloom_query`` at ``PROBE_EDGES``.
    Returns the cases checked."""
    rng = np.random.default_rng(19)
    n = 0
    for k, lanes, vw in EDGE_SHAPES:
        blocks = edge_blocks(rng, 60, k, lanes, vw)
        args = [torch.from_numpy(a.view(np.int32)).to(dev) for a in blocks]
        for entry, plain in ((ops.lookup_blocks, ref.lookup_blocks),
                             (ops.lookup_blocks_packed,
                              ref.lookup_blocks_packed)):
            got = one_launch("lookup_blocks", lambda: entry(*args))
            compare_outputs(f"lookup_blocks K={k} L={lanes} Vw={vw}", got,
                            plain(*args))
            n += 1
        found = ref.lookup_blocks(*args)[0]
        if k > 1 and (not found.any() or found.all()):
            raise AssertionError("edge blocks: found all or none")
    for n_words, probes in PROBE_EDGES:
        keys = as_i32(rng.integers(0, 2**32, (40, 16, 4),
                                   dtype=np.uint32), dev)
        filters = ref.bloom_build(keys, n_words=n_words,
                                  n_probes=probes)
        fresh = as_i32(rng.integers(0, 2**32, (40, 4), dtype=np.uint32),
                       dev)
        q = torch.where(torch.from_numpy(rng.random(40) < 0.5).to(dev)
                        [:, None], keys[:, 0], fresh)
        got = one_launch("bloom_multi_probe", lambda:
                         ops.bloom_multi_probe(filters, q,
                                               n_probes=probes))
        compare_outputs(f"bloom_multi_probe W={n_words} p={probes}", got,
                        ref.bloom_multi_probe(filters, q, n_probes=probes))
        gq = torch.cat([keys, as_i32(rng.integers(
            0, 2**32, (40, 16, 4), dtype=np.uint32), dev)], dim=1)
        got = one_launch("bloom_query", lambda: ops.bloom_query(
            filters, gq, n_probes=probes))
        compare_outputs(f"bloom_query W={n_words} p={probes}", got,
                        ref.bloom_query(filters, gq, n_probes=probes))
        n += 2
    return n


# The sort's and the bloom build's edge cases, shared with the tests.
# Sort: (rows, lanes, index lane) -- one row, two, a tile (SORT_TILE, what
# `bitonic_sort.tile_rows` gives these lanes) less one, a tile, a tile and
# one, three tiles and five, and 300,001 rows; 1 to 8 lanes on the
# register tile sort, 10 on the run-time-lanes route; with a unique last
# lane, or without (rows repeat).  Words come from SORT_WORDS, so key
# lanes tie often and the top bit is set in half of them.
SORT_TILE = 2048
SORT_LANES = (1, 3, 6, 8, 10)
SORT_EDGES = [(n, lanes, index_lane) for lanes in SORT_LANES
              for n in (1, 2, SORT_TILE - 1, SORT_TILE, SORT_TILE + 1,
                        3 * SORT_TILE + 5, 300_001)
              for index_lane in (True, False)]
SORT_WORDS = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001,
                       0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
# Bloom build: (groups, keys a group, lanes, filter words, probes, share of
# valid keys) -- the paper's block filters; one key a group; a group past
# a warp (33 keys: lanes loop); the short route's widest row (32 words)
# and the block route's narrowest (33); 219 and 5,120 words (an SST); an
# SST's keys on a short row; 1, 6 and 30 probes; no valid key and all.
BLOOM_EDGES = [(4096, 16, 4, 5, 6, 0.94), (64, 1, 4, 2, 6, 1.0),
               (40, 16, 2, 5, 1, 1.0), (40, 16, 10, 13, 30, 1.0),
               (40, 16, 4, 5, 6, 0.0), (17, 33, 4, 13, 6, 0.8),
               (9, 33, 10, 5, 30, 0.5), (5, 16, 4, 32, 6, 1.0),
               (5, 16, 4, 33, 6, 1.0), (3, 700, 4, 219, 6, 0.9),
               (2, 700, 2, 219, 30, 1.0), (1, 16_384, 4, 5_120, 6, 0.9),
               (2, 16_384, 10, 5_120, 1, 1.0), (3, 16_384, 4, 5, 6, 1.0)]


# The prefix step's edge cases, shared with the tests: (rows, lanes, restart
# interval) -- lanes 1, 4 (16-byte loads) and 5, and 2 and 8, on the
# register route, 10 on the run-time-lanes route; restart 16 (it divides
# 32: no thread loads a second row), 12 and 24 (they do not: lane 0 of a
# warp loads its predecessor); one interval alone; rows that end inside a
# warp.  The wire route runs each at `prefix_edge_counts` survivors.
PREFIX_EDGES = [(4096, 4, 16), (4096, 1, 16), (4096, 5, 16), (2048, 8, 16),
                (16, 4, 16), (3000, 4, 12), (3000, 5, 12), (12, 1, 12),
                (960, 10, 12), (4104, 2, 24)]
PREFIX_WORDS = np.array([0, 1, 0x100, 0x10000, 0x1000000, 0x75736572,
                         0x80000000, 0xFFFFFFFF], np.uint32)
# bloom_query's edge cases besides PROBE_EDGES: (groups, queries, filter
# words, probes) -- one query; queries that fill no block (300, 257); rows
# of 5 to 13,000 words (8, 9, 16 and 17 around the register rows of the
# other probe, an SST's 5,120, one past 48 KB); 1, 6 and 10 probes; more
# groups than grid.y takes (70,000)
QUERY_EDGES = [(1, 1, 5, 6), (3, 1, 5120, 6), (5, 300, 5, 6), (3, 40, 8, 6),
               (3, 40, 9, 6), (4, 1000, 16, 1), (4, 1000, 17, 10),
               (2, 257, 5120, 6), (2, 100, 13_000, 6), (70_000, 1, 5, 6)]


def prefix_edge_counts(n: int, restart: int) -> list[int]:
    """Survivor counts of a wire edge case: none, one, a restart point,
    mid-interval, all."""
    return sorted({0, 1, min(restart, n), min(3 * restart + restart // 2 + 1,
                                              n), n})


def prefix_edge_keys(n: int, lanes: int, restart: int) -> np.ndarray:
    """Sorted uint32 keys ``[n, lanes]`` of ``PREFIX_WORDS``, seeded by the
    case: lanes tie often and differ at every byte position, and rows
    repeat (drawn from n / 4 distinct ones)."""
    rng = np.random.default_rng(n * 64 + lanes * 8 + restart)
    rows = PREFIX_WORDS[rng.integers(0, len(PREFIX_WORDS),
                                     (max(n // 4, 1), lanes))]
    k = rows[rng.integers(0, len(rows), n)]
    return k[np.lexsort(tuple(k[:, i] for i in reversed(range(lanes))))]


def query_edge_inputs(groups: int, queries: int, n_words: int, probes: int,
                      dev) -> tuple[torch.Tensor, torch.Tensor]:
    """``(filters, keys)`` of a ``QUERY_EDGES`` case, seeded by the case:
    each group's filter holds the first half of its queries."""
    rng = np.random.default_rng(groups + 7 * queries + 3 * n_words + probes)
    keys = as_i32(rng.integers(0, 2**32, (groups, queries, 4),
                               dtype=np.uint32), dev)
    filters = ref.bloom_build(keys[:, :(queries + 1) // 2], n_words=n_words,
                              n_probes=probes)
    return filters, keys


def sort_edge_rows(n: int, lanes: int, index_lane: bool) -> np.ndarray:
    """uint32 ``[n, lanes]`` rows of ``SORT_WORDS``, seeded by the case;
    with ``index_lane`` the last lane is a permutation of ``n`` with the
    top bit set in about half its words (still unique)."""
    rng = np.random.default_rng(n * 16 + lanes * 2 + index_lane)
    rows = SORT_WORDS[rng.integers(0, len(SORT_WORDS), (n, lanes))]
    if index_lane:
        top = np.where(rng.random(n) < 0.5, 0x80000000, 0).astype(np.uint32)
        rows[:, -1] = rng.permutation(n).astype(np.uint32) ^ top
    return rows


def bloom_edge_inputs(groups: int, per: int, lanes: int, n_words: int,
                      probes: int, p_valid: float
                      ) -> tuple[np.ndarray, np.ndarray]:
    """uint32 keys ``[groups, per, lanes]`` and the bool valid mask of a
    ``BLOOM_EDGES`` case, seeded by the case."""
    rng = np.random.default_rng(groups * per + lanes * n_words + probes)
    keys = rng.integers(0, 2**32, (groups, per, lanes), dtype=np.uint32)
    return keys, rng.random((groups, per)) < p_valid


def check_sort_edges(dev, sort_rows: dict) -> int:
    """``bitonic_sort`` at ``SORT_EDGES`` and at phase 2's sort inputs
    (``sort_rows``): bit-identical to its plain version, the input left as
    it was, and exactly the launches its plan names.  Returns the cases."""
    cases = [(f"n={n} L={lanes} index={idx}",
              as_i32(sort_edge_rows(n, lanes, idx), dev))
             for n, lanes, idx in SORT_EDGES]
    cases += [(f"n={n} phase-2 tuples", rows)
              for n, rows in sort_rows.items()]
    for name, rows in cases:
        n, lanes = rows.shape
        kept = rows.clone()
        before = ops.launch_counts()
        got = ops.bitonic_sort(rows)
        after = ops.launch_counts()
        made = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        torch.cuda.synchronize()
        compare_outputs(f"bitonic_sort {name}", got, ref.sort_tuples(rows))
        if not torch.equal(rows, kept):
            raise AssertionError(f"bitonic_sort {name}: changed its input")
        if made != {"bitonic_sort": sort_plan.launches(n, lanes)}:
            raise AssertionError(f"bitonic_sort {name}: launches {made}, "
                                 f"planned {sort_plan.launches(n, lanes)}")
    return len(cases)


def check_bloom_edges(dev) -> int:
    """``bloom_build`` at ``BLOOM_EDGES``: bit-identical to its plain
    version, one launch a call.  Returns the cases checked."""
    for case in BLOOM_EDGES:
        keys, valid = bloom_edge_inputs(*case)
        k = as_i32(keys, dev)
        v = torch.from_numpy(valid).to(dev)
        n_words, probes = case[3], case[4]
        got = one_launch("bloom_build", lambda: ops.bloom_build(
            k, v, n_words=n_words, n_probes=probes))
        compare_outputs(f"bloom_build {case}", got, ref.bloom_build(
            k, n_words=n_words, n_probes=probes, valid=v))
    return len(BLOOM_EDGES)


def check_prefix_edges(dev) -> int:
    """``prefix_encode`` at ``PREFIX_EDGES``, both routes (the wire route at
    each of ``prefix_edge_counts``): bit-identical to the plain versions,
    one launch a call.  Returns the calls checked."""
    n_calls = 0
    for n, lanes, restart in PREFIX_EDGES:
        keys = as_i32(prefix_edge_keys(n, lanes, restart), dev)
        case = f"n={n} L={lanes} restart={restart}"
        got = one_launch("prefix_encode", lambda: ops.prefix_encode(
            keys, restart_interval=restart))
        compare_outputs(f"prefix_encode {case}", got, ref.prefix_encode(
            keys, restart_interval=restart))
        for c in prefix_edge_counts(n, restart):
            count = torch.tensor(c, dtype=torch.int64, device=dev)
            got = one_launch("prefix_encode", lambda: ops.prefix_encode_wire(
                keys, count, restart_interval=restart))
            compare_outputs(f"prefix_encode_wire {case} count={c}", got,
                            ref.prefix_encode_wire(
                                keys, count, restart_interval=restart))
            n_calls += 1
        n_calls += 1
    return n_calls


def check_query_edges(dev) -> int:
    """``bloom_query`` at ``QUERY_EDGES``: bit-identical to its plain
    version, one launch a call.  Returns the cases checked."""
    for g, q, n_words, probes in QUERY_EDGES:
        filters, keys = query_edge_inputs(g, q, n_words, probes, dev)
        got = one_launch("bloom_query", lambda: ops.bloom_query(
            filters, keys, n_probes=probes))
        compare_outputs(f"bloom_query G={g} Q={q} W={n_words} p={probes}",
                        got, ref.bloom_query(filters, keys, n_probes=probes))
    return len(QUERY_EDGES)


def unique_sort(rows: torch.Tensor) -> torch.Tensor:
    """PyTorch's nearest route to the sort, timed beside it and used
    nowhere in the port: the sign bit flipped (so int32 order is the
    words' unsigned order), ``torch.unique(dim=0)``, which returns unique
    rows sorted lexicographically, and the sign bit flipped back.  Equal
    to the sort where the rows are unique (an index lane)."""
    flip = torch.iinfo(torch.int32).min
    return torch.unique(rows ^ flip, dim=0) ^ flip


def unique_merge(rows: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes ``merge_runs``' function, timed
    beside it and used nowhere in the port: the phase-2 tuples carry an
    index lane, so every row is unique and ``unique_sort`` of them is
    their merge.  A batch ``[J, n, L]`` takes its job as a leading lane,
    so that one call merges every job's rows on their own."""
    if rows.dim() == 2:
        return unique_sort(rows)
    j, n, lanes = rows.shape
    job = torch.arange(j, dtype=rows.dtype, device=rows.device)
    tagged = torch.cat([job[:, None, None].expand(j, n, 1), rows], dim=2)
    return unique_sort(tagged.reshape(j * n, lanes + 1))[:, 1:].reshape(
        j, n, lanes)


def compare_outputs(name: str, got, want) -> tuple[int, str]:
    """Raise unless a kernel's output (a tensor or a tuple of them) equals
    its plain version's bit for bit; returns the max abs error over the
    unsigned words and the output shapes."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((ref.u32(a) - ref.u32(b)).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    if len(got) != len(want) or \
            not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err, " ".join(str(tuple(a.shape)) for a in got)


def check_kernels(dev, card: str) -> tuple[dict, dict]:
    """Phase 2.  Returns per-kernel results keyed by kernel name, and the
    sort's inputs by row count; ``card`` (name, power limit) goes beside
    every time."""
    rng = np.random.default_rng(2020)
    merge_rows: dict = {}
    cases, sections = kernel_cases(rng, dev, merge_rows)
    sort_rows: dict = {}
    cases += read_kernel_cases(rng, dev, sort_rows)
    results = {}
    for name, kern, plain, nbytes, nops in cases:
        before = sum(ops.launch_counts().values())
        got = kern()
        launches = sum(ops.launch_counts().values()) - before
        want = plain()
        torch.cuda.synchronize()
        err, shapes = compare_outputs(name, got, want)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / SCALAR_OPS_PER_S * 1e3
        for _ in range(3):   # a trace that lost most of its events
            ms, events = device_ms(kern, 50, with_events=True)
            if events >= 0.9 * launches:
                break
        res = dict(max_abs_err=err, ms=ms, events=events,
                   plain_ms=device_ms(plain, 5),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=None, call_ms=call_ms(kern, 50),
                   plain_call_ms=call_ms(plain, 5))
        log(f"  {name:22s} shape {shapes}: bit-identical; {launches} "
            f"launches a call, {events:.2f} device events a call (CUPTI); "
            f"device time kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}); one call {res['call_ms']:.4f} ms, plain "
            f"{res['plain_call_ms']:.4f} ms [{card}]")
        results[name] = res
    for case, (rows, lens) in merge_rows.items():
        # merge_runs returns the merged rows: torch.unique(dim=0) between
        # two sign flips computes that function on the same rows
        plain = ref.merge_runs_batched if rows.dim() == 3 else ref.merge_runs
        compare_outputs(f"unique_merge/{case}", unique_merge(rows),
                        plain(rows, lens))
        ms = device_ms(lambda r=rows: unique_merge(r), 20)
        results[case]["library_ms"] = ms
        log(f"  library_ms of {case}: torch.unique(dim=0) between two sign "
            f"flips{' (the job as a leading lane)' if rows.dim() == 3 else ''}"
            f", equal to the merge: device time {ms:.4f} ms, the kernel "
            f"{results[case]['ms']:.4f} ms [{card}]")
    log(f"  library_ms: none for the other kernels: {NO_LIBRARY} (a "
        "sectioned CRC, a lexicographic 6-lane sort, a prefix count, a "
        "bloom build or 6-probe test, a lower-bound search with a gather)")
    for n, rows in sort_rows.items():
        compare_outputs(f"unique_sort/{n}", unique_sort(rows),
                        ref.sort_tuples(rows))
        results[f"unique_sort/{n}"] = ms = device_ms(
            lambda r=rows: unique_sort(r), 20)
        log(f"  PyTorch's nearest route to bitonic_sort/{n} (sign flip, "
            f"torch.unique(dim=0), flip back; three calls, so not "
            f"library_ms): equal to the sort; device time {ms:.4f} ms, the "
            f"kernel {results[f'bitonic_sort/{n}']['ms']:.4f} ms [{card}]")
    # the CRC chain anchored to binascii on sampled rows
    crc = ops.crc32_sections(sections).cpu().numpy().view(np.uint32)
    host = [s.cpu().numpy().view(np.uint32) for s in sections]
    for r in rng.choice(len(crc), 64, replace=False):
        row = np.concatenate([h[r] for h in host]).astype("<u4").tobytes()
        if binascii.crc32(row) & 0xFFFFFFFF != int(crc[r]):
            raise AssertionError(f"crc32: row {r} differs from binascii")
    log("  crc32_sections: 64 sampled rows equal binascii.crc32")
    check_merge_cases(dev, card, rng)
    n = check_read_edges(dev)
    log(f"  read kernels at their edges: {n} cases bit-identical, one launch"
        " a call (lookup_blocks and its packed form at K 1/16/33/70, L 2/4, "
        "Vw 3/68, and L 8 and 10; nvalid 0 and K, queries first/last valid/"
        "duplicated/absent/sentinel; bloom_multi_probe and bloom_query at "
        "5/13/5,120 words, 1, 6 and 10 probes)")
    one = torch.zeros(1, device=dev)
    results["launch_floor_ms"] = floor = device_ms(one.zero_, 50)
    gaps = ", ".join(
        f"{c} {results[c]['ms']:.4f} ms (+{results[c]['ms'] - floor:.4f})"
        for c in ("bloom_multi_probe/256", "bloom_multi_probe/1024",
                  "lookup_blocks/256", "lookup_blocks/1024", "bloom_query",
                  "prefix_encode", "prefix_encode/wire", "bloom_build",
                  "bloom_build/1", "bloom_build/sst"))
    log(f"  launch floor (device time of a one-element zero_, CUPTI, 50 "
        f"calls): {floor:.4f} ms; the small kernels and their gap to it: "
        f"{gaps} [{card}]")
    return results, sort_rows


def check_edges(dev, sort_rows: dict) -> None:
    """Phase 2's edge tables of the sort, the bloom build, the prefix step
    and the bloom query."""
    n = check_sort_edges(dev, sort_rows)
    log(f"  bitonic_sort at its edges: {n} cases bit-identical, input kept, "
        f"the planned launches a call (1 + the merge levels of its "
        f"{SORT_TILE}-row tiles: " + ", ".join(
            f"{n_} rows {sort_plan.launches(n_, 6)}" for n_ in sort_rows) +
        f" at 6 lanes; rows of 1-10 lanes, 1 to 300,001 rows, tile edges, "
        f"with and without an index lane)")
    n = check_bloom_edges(dev)
    log(f"  bloom_build at its edges: {n} cases bit-identical, one launch a"
        " call (1 to 16,384 keys a group, 2 to 5,120 words, 1, 6 and 30 "
        "probes, no valid key and all, both routes)")
    n = check_prefix_edges(dev)
    log(f"  prefix_encode at its edges: {n} calls bit-identical, one launch "
        "a call (both routes; lanes 1/2/4/5/8/10, restart 16/12/24, one "
        "interval alone, rows ending inside a warp; the wire route at 0, 1, "
        "a restart point, mid-interval and all rows surviving)")
    n = check_query_edges(dev)
    log(f"  bloom_query at its edges: {n} cases bit-identical, one launch a "
        "call (1 to 1,000 queries, rows of 5 to 13,000 words, 1, 6 and 10 "
        "probes, 70,000 groups)")


# ---------------------------------------------------------------------------
# phase 3: the store at the paper geometry
# ---------------------------------------------------------------------------


def zipf_ranks(rng, n: int, size: int, theta: float = 0.99) -> np.ndarray:
    """YCSB's zipfian (constant 0.99) over ``n`` ranks, scrambled so hot
    keys spread over the key space."""
    p = 1.0 / np.arange(1, n + 1) ** theta
    ranks = rng.choice(n, size=size, p=p / p.sum())
    return rng.permutation(n)[ranks]


def multi_get_batches(rng, keys: list, deleted: list, n_batches: int
                      ) -> list[list[bytes]]:
    """Batches of ``MULTI_GET_BATCH`` keys: zipfian (0.99) over the loaded
    keys with about 10 % never written (inside the files' key ranges), then
    the deleted keys."""
    n_never = MULTI_GET_BATCH // 10
    hot = zipf_ranks(rng, len(keys), n_batches * (MULTI_GET_BATCH - n_never))
    batches = []
    for b in range(n_batches):
        ks = [keys[i] for i in hot[b * (MULTI_GET_BATCH - n_never):
                                   (b + 1) * (MULTI_GET_BATCH - n_never)]]
        ks += [keys[i][:-1] + b"x" for i in
               rng.choice(len(keys), n_never, replace=False)]
        rng.shuffle(ks)
        batches.append(ks)
    for i in range(0, len(deleted), MULTI_GET_BATCH):
        batches.append(deleted[i:i + MULTI_GET_BATCH])
    return batches


def check_multi_gets(store, batches, model: dict, when: str) -> dict:
    """Every batch through ``multi_get`` must equal the ``get`` loop and
    the acknowledged writes; the first batch also through a snapshot.
    Returns the batch latencies (host clock, us) and the store's counts
    of waves, staged bytes and device-stage seconds over the pass (the
    ``get`` loop adds none)."""
    lat, pruned, n_keys = [], 0, 0
    start = store.stats   # a copy: later counts come from fresh reads
    launches0 = ops.launch_counts()
    for b in batches:
        skips = store.stats.bloom_negative_skips
        c0 = time.perf_counter_ns()
        got = store.multi_get(b)
        lat.append((time.perf_counter_ns() - c0) / 1e3)
        pruned += store.stats.bloom_negative_skips - skips
        n_keys += len(b)
        if got != [model.get(k) for k in b]:
            raise AssertionError(f"{when}: multi_get disagrees with the "
                                 "acknowledged writes")
        if got != [store.get(k) for k in b]:
            raise AssertionError(f"{when}: multi_get disagrees with get")
    so = ReadOptions(snapshot=store.snapshot())
    b = batches[0]
    got = store.multi_get(b, so)
    if got != [store.get(k, so) for k in b] or \
            got != [model.get(k) for k in b]:
        raise AssertionError(f"{when}: snapshot multi_get disagrees")
    launches = {n: ops.launch_counts()[n] - launches0[n]
                for n in READ_PATH}
    end = store.stats
    return dict(lat_us=lat, keys=n_keys, pruned=pruned, launches=launches,
                waves=end.multi_get_waves - start.multi_get_waves,
                staged_bytes=end.multi_get_staged_bytes -
                start.multi_get_staged_bytes,
                stage_s=end.multi_get_stage_seconds -
                start.multi_get_stage_seconds)


def trace_multi_get(store, keys) -> dict:
    """One ``multi_get`` batch under the profiler: its waves, the stages
    that launched a kernel (by the launch counts), the host's tensor
    copies (``aten::copy_``, one to the card and one back a stage) and
    the device events by kind from the CUPTI trace.  Raises unless every
    stage made exactly one copy over and one back, and the card ran no
    kernel but the read path's hand-written ones (no concatenation or
    dtype pass).  CUPTI drops a few events now and then on this machine,
    so the device counts are reported, not required to be whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    waves = store.stats.multi_get_waves
    before = ops.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        store.multi_get(keys)
        torch.cuda.synchronize()
    waves = store.stats.multi_get_waves - waves
    launched = {n: ops.launch_counts()[n] - before[n] for n in READ_PATH}
    copies, kinds = 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            copies += e.name == "aten::copy_"
            continue
        kind = "HtoD" if "HtoD" in e.name else "DtoH" if "DtoH" in e.name \
            else next((k for fn, k in HAND_WRITTEN.items() if fn in e.name),
                      e.name)
        kinds[kind] = kinds.get(kind, 0) + 1
    stages = sum(launched.values())
    if copies != 2 * stages or set(kinds) - {"HtoD", "DtoH", *READ_PATH}:
        raise AssertionError(f"a traced multi_get made {copies} tensor "
                             f"copies and ran device events {kinds} for the "
                             f"launches {launched}")
    return dict(waves=waves, launched=launched, copies=copies, kinds=kinds)


def multi_get_line(when: str, m: dict) -> str:
    """The phase-3 report of one pass of ``check_multi_gets``."""
    lat = m["lat_us"]
    p50, p99, p999 = (float(np.percentile(lat, q)) for q in (50, 99, 99.9))
    total_s = sum(lat) / 1e6
    return (f"[3] multi_get ({when} block cache): {len(lat)} batches of <= "
            f"{MULTI_GET_BATCH} keys equal the get loop and the acknowledged"
            f" writes (and one batch through a snapshot); latency per batch "
            f"p50 {p50:.1f} us, p99 {p99:.1f} us, p99.9 {p999:.1f} us (host "
            f"clock); {m['keys'] / total_s:.0f} keys/s; "
            f"{m['waves'] / (len(lat) + 1):.2f} waves a batch; launches a "
            f"wave: " + ", ".join(f"{n} {c / m['waves']:.3f}" for n, c in
                                  m["launches"].items()) + "; "
            f"bloom_negative_skips +{m['pruned']} (candidates pruned by "
            f"the bloom probe); device "
            f"stages (stack, copy over, kernel, copy back) "
            f"{m['stage_s'] * 1e3:.1f} ms for {m['staged_bytes']} staged "
            f"bytes = {m['stage_s'] / total_s:.1%} of multi_get time")


def merge_jobs_line(jobs_seen, card: str, phase: int = 3) -> str:
    """The phase-3 (or ``phase``) report of the merges: launches and
    ``"sort"`` span a job.  Raises unless each job took ceil(log2 k')
    launches for its k input files and the padding run the engine may add
    (k' = k or k + 1), and at least one job launched the merge."""
    for inputs, launches, _ in jobs_seen:
        if not merge_levels((1,) * inputs) <= launches <= \
                merge_levels((1,) * (inputs + 1)):
            raise AssertionError(f"a job of {inputs} inputs made {launches} "
                                 "merge_runs launches")
    if not any(launches for _, launches, _ in jobs_seen):
        raise AssertionError("no compaction launched merge_runs")
    per_job = ", ".join(f"({k}, {n}, {s * 1e3:.3f})" for k, n, s in jobs_seen)
    return (f"[{phase}] merge_runs: {sum(n for _, n, _ in jobs_seen)} "
            f"launches in "
            f"{len(jobs_seen)} compaction jobs; sort span "
            f"{sum(s for *_, s in jobs_seen):.4f} s (CUDA events); a job "
            f"(input files, launches, sort ms): [{per_job}] [{card}]")


def run_store(path: str, *, device, geom: SSTGeometry,
              sched: SchedulerConfig, records: int, operations: int,
              deletes: int, value_size: int, batch: int, sample: int,
              scan_keys: int, mg_batches: int, keep_dir: str,
              seed: int = 7) -> dict:
    """Phase 3: load, YCSB-A, deletes, compaction, checked reads and
    ``multi_get`` batches, close, reopen, the same checks again.  The first
    L0->L1 job's input files are copied to ``keep_dir`` for phase 4.
    Returns the counts it saw."""
    rng = np.random.default_rng(seed)
    cfg = DBConfig(geom=geom, scheduler=sched)
    keys = [b"user%012d" % i for i in range(records)]
    vals = rng.integers(0, 256, (records + operations, value_size),
                        dtype=np.uint8)
    model: dict[bytes, bytes] = {}
    db = LsmDB(path, cfg, device=device)

    kept: dict = {}
    jobs_seen = []   # (input files, merge_runs launches, "sort" span s)
    compact_paths = db.engine.compact_paths

    def watch_job(paths, *, bottom_level=False):
        """Keep the first L0->L1 job's inputs; count each job's merge."""
        if not kept and len(paths) >= 4:
            os.makedirs(keep_dir, exist_ok=True)
            kept["paths"] = [shutil.copy(p, keep_dir) for p in paths]
            kept["bottom_level"] = bottom_level
        before = ops.launch_counts()["merge_runs"]
        out, es = compact_paths(paths, bottom_level=bottom_level)
        jobs_seen.append((len(paths),
                          ops.launch_counts()["merge_runs"] - before,
                          es.sort_seconds))
        return out, es

    db.engine.compact_paths = watch_job

    lat = {"write_batch": [], "get": [], "put": []}   # host clock, us
    clock = time.perf_counter_ns
    t0 = time.perf_counter()
    order = rng.permutation(records)
    for s in range(0, records, batch):
        ops_ = []
        for i in order[s:s + batch]:
            v = vals[i].tobytes()
            ops_.append(("put", keys[i], v))
            model[keys[i]] = v
        c0 = clock()
        db.write_batch(ops_)
        lat["write_batch"].append((clock() - c0) / 1e3)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    targets = zipf_ranks(rng, records, operations)
    is_read = rng.random(operations) < 0.5
    for j, (i, read) in enumerate(zip(targets, is_read)):
        k = keys[i]
        c0 = clock()
        if read:
            got = db.get(k)
            lat["get"].append((clock() - c0) / 1e3)
            if got != model.get(k):
                raise AssertionError(f"ycsb read of {k!r} disagrees")
        else:
            v = vals[records + j].tobytes()
            db.put(k, v)
            lat["put"].append((clock() - c0) / 1e3)
            model[k] = v
    deleted = [keys[i] for i in rng.choice(records, deletes, replace=False)]
    for k in deleted:
        db.delete(k)
        model.pop(k, None)
    db.maybe_compact()
    t_ops = time.perf_counter() - t0

    probe = [keys[i] for i in rng.choice(records, sample, replace=False)]
    lo = int(rng.integers(0, records - scan_keys))
    start, end = keys[lo], keys[lo + scan_keys]
    want_scan = sorted((k, v) for k, v in model.items() if start <= k < end)
    batches = multi_get_batches(rng, keys, deleted, mg_batches)

    def check_reads(store, when):
        for k in probe + deleted:
            if store.get(k) != model.get(k):
                raise AssertionError(f"{when}: get({k!r}) disagrees")
        if store.scan(start, end) != want_scan:
            raise AssertionError(f"{when}: scan disagrees")

    check_reads(db, "before reopen")
    mg = {"warm": check_multi_gets(db, batches, model, "before reopen")}
    stats = db.stats
    jobs = list(db.compactions)
    levels = db.level_sizes()
    db.close()
    db = LsmDB(path, cfg, device=device)   # cold block cache
    mg["cold"] = check_multi_gets(db, batches, model, "after reopen")
    check_reads(db, "after reopen")
    db.close()
    mg_trace = {}
    if torch.device(device).type == "cuda":   # one batch traced, cold, warm
        db = LsmDB(path, cfg, device=device)
        mg_trace = {when: trace_multi_get(db, batches[1])
                    for when in ("cold", "warm")}
        db.close()
    counts = ops.launch_counts()

    l0 = [r for r in jobs if r.level == 0]
    l1 = [r for r in jobs if r.level == 1]
    return dict(
        launches=counts, levels=levels, flushes=stats.flushes,
        compactions=stats.compactions, trivial_moves=stats.trivial_moves,
        l0_jobs=len(l0), l0_min_inputs=min((r.inputs for r in l0),
                                           default=0),
        l1_jobs=len(l1), bytes_in=stats.compact_bytes_in,
        bytes_out=stats.compact_bytes_out,
        device_s=stats.compact_device_seconds,
        sort_s=stats.compact_sort_seconds,
        host_s=stats.compact_host_seconds, load_s=t_load, ops_s=t_ops,
        checked=len(probe) + len(deleted) + 1, scan_rows=len(want_scan),
        dropped=stats.compact_entries_dropped,
        latency_us={op: [float(np.percentile(v, q)) for q in (50, 99, 99.9)]
                    for op, v in lat.items()},
        multi_get=mg, mg_trace=mg_trace, kept=kept, jobs_seen=jobs_seen)


# ---------------------------------------------------------------------------
# phase 4: one real job, device against CPU
# ---------------------------------------------------------------------------

# the __global__ functions of src/repro_torch/kernels/csrc, by the kernel
# (wrapper) they belong to
HAND_WRITTEN = {"crc32_sections_kernel": "crc32_sections",
                "merge_level_kernel": "merge_runs",
                "prefix_encode_kernel": "prefix_encode",
                "bloom_build_warp_kernel": "bloom_build",
                "bloom_build_block_kernel": "bloom_build",
                "multi_probe_kernel": "bloom_multi_probe",
                "bloom_query_kernel": "bloom_query",
                "lookup_kernel": "lookup_blocks",
                "sort_tile_kernel": "bitonic_sort",
                "sort_level_kernel": "bitonic_sort",
                "selective_scan_kernel": "selective_scan",
                "ssb_sweep_kernel": "selective_scan_bwd",
                "ssb_carry_kernel": "selective_scan_bwd",
                "ssb_walk_kernel": "selective_scan_bwd",
                "ssb_reduce_kernel": "selective_scan_bwd"}
# the rest of a trace: copies and fills (Memcpy, Memset), PyTorch's kernels
COPIES = "copies"
PYTORCH = "PyTorch kernels"


# CUPTI on this machine drops the first device events of a trace now and
# then, more of them after many traces (phase 4's image copies, first in
# their job, went missing after phase 2's traces); each trace starts with
# this many small kernels and a marker kernel that absorb the loss, and
# keeps only the events after the marker
TRACE_PRELUDE = 64


def trace_once(fn) -> list[tuple[str, float]]:
    """``(name, ms)`` of each device event (kernel or copy) of one call of
    ``fn``, from the profiler's CUPTI trace (``trace_timeline``)."""
    return [(name, ms) for _, name, ms in trace_timeline(fn)]


def trace_timeline(fn) -> list[tuple[float, str, float]]:
    """``(start us, name, ms)`` of each device event (kernel or copy) of
    one call of ``fn``, from the profiler's CUPTI trace, after a prelude of
    ``TRACE_PRELUDE`` one-element fills and a ``torch.cuda._sleep``
    marker (``spin_kernel``) whose events are left out; empty when the
    trace came back without the marker or without device events after
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PRELUDE):
            pad.zero_()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = [(e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [start for start, name, _ in events if "spin_kernel" in name]
    if not marks:
        return []
    return [e for e in events if e[0] > marks[-1]]


def device_trace(fn, attempts: int = 3) -> list[tuple[str, float]]:
    """``trace_once(fn)``, taken again (``fn`` called again) while it comes
    back empty, up to ``attempts`` times in all."""
    for _ in range(attempts):
        events = trace_once(fn)
        if events:
            return events
    raise RuntimeError(f"the profiler recorded no device time after its "
                       f"marker in {attempts} traces")


def device_breakdown(fn, attempts: int = 3) -> dict[str, float]:
    """Device time (ms) of one call of ``fn`` by kernel or copy name."""
    by: dict[str, float] = {}
    for name, ms in device_trace(fn, attempts):
        by[name] = by.get(name, 0.0) + ms
    return by


def event_kind(name: str) -> str:
    """The hand-written kernel that a device event's name belongs to, or
    ``COPIES`` or ``PYTORCH``."""
    hand = next((k for fn, k in HAND_WRITTEN.items() if fn in name), None)
    if hand is not None:
        return hand
    return COPIES if name.startswith(("Memcpy", "Memset")) else PYTORCH


def split_device_time(by_name: dict[str, float]) -> dict[str, float]:
    """Device time by hand-written kernel, the rest under ``COPIES`` and
    ``PYTORCH``."""
    out: dict[str, float] = {}
    for name, ms in by_name.items():
        key = event_kind(name)
        out[key] = out.get(key, 0.0) + ms
    return out


def prefix_two_lines(keys_c: torch.Tensor, count: torch.Tensor, *,
                     restart_interval: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops.prefix_encode_wire`` as the pack ran it before its wire
    route: the shared-only kernel, then ``pack_prefix_before``.  Its mask
    of the survivors is rebuilt here from ``count`` (an arange and a
    compare that the pack shared with its other passes)."""
    valid_c = torch.arange(keys_c.shape[0], device=keys_c.device) < count
    return pack_prefix_before(keys_c, valid_c, ops.prefix_encode(
        keys_c, restart_interval=restart_interval))


def job_breakdown(kept: dict, geom: SSTGeometry, device,
                  sort_mode: str = "merge", two_lines: bool = False) -> dict:
    """The kept L0->L1 job through the engine on ``device`` in
    ``sort_mode``, once to warm up and three times traced, keeping the
    trace with the most device events (CUPTI drops some now and then on
    this machine): its device time split by kernel, copies and PyTorch
    kernels, the PyTorch kernel launches, the copies by direction and host
    memory, and the largest names that are not a hand-written kernel.
    ``two_lines``: the pack's prefix step as ``prefix_two_lines``."""
    images = [sstable.read_sst(p) for p in kept["paths"]]
    eng = TorchCompactionEngine(geom, device=device, sort_mode=sort_mode)

    def job():
        return eng.compact(images, bottom_level=kept["bottom_level"])

    with (mock.patch.object(ops, "prefix_encode_wire", prefix_two_lines)
          if two_lines else contextlib.nullcontext()):
        job()
        trace = max((device_trace(job) for _ in range(3)), key=len)
    eng.close()
    by_name: dict[str, float] = {}
    for name, ms in trace:
        by_name[name] = by_name.get(name, 0.0) + ms
    split = split_device_time(by_name)
    other = sorted(((ms, n) for n, ms in by_name.items()
                    if event_kind(n) in (COPIES, PYTORCH)), reverse=True)
    return dict(total_ms=sum(split.values()), split=split, other=other,
                pytorch_launches=sum(event_kind(n) == PYTORCH
                                     for n, _ in trace),
                memcpy=memcpy_split(trace))


def memcpy_split(trace) -> dict[str, tuple[int, float]]:
    """The copies of a trace by direction and host memory, ``"HtoD
    Pinned"`` and so on: (count, ms).  CUPTI names a copy ``Memcpy HtoD
    (Pinned -> Device)`` or ``Memcpy DtoH (Device -> Pageable)``."""
    out: dict[str, tuple[int, float]] = {}
    for name, ms in trace:
        if not name.startswith("Memcpy "):
            continue
        way = name.split()[1]
        mem = "Pinned" if "Pinned" in name else \
            "Pageable" if "Pageable" in name else "Device"
        n, t = out.get(f"{way} {mem}", (0, 0.0))
        out[f"{way} {mem}"] = (n + 1, t + ms)
    return out


def breakdown_line(b: dict, card: str, sort_mode: str = "merge") -> str:
    """The phase-4 report of ``job_breakdown``."""
    total = b["total_ms"]
    parts = ", ".join(f"{k} {ms:.4f} ms ({ms / total:.1%})" for k, ms in
                      sorted(b["split"].items(), key=lambda x: -x[1]))
    top = "; ".join(f"{n[:60]} {ms:.4f} ms" for ms, n in b["other"][:6])
    share = {k: b["split"].get(k, 0.0) / total
             for k in ("crc32_sections", COPIES, PYTORCH)}
    copies = ", ".join(f"{k} {n} x {ms:.4f} ms" for k, (n, ms) in
                       sorted(b.get("memcpy", {}).items()))
    return (f"[4] the L0->L1 job on the card (sort_mode={sort_mode!r}): "
            f"{total:.4f} ms of device time "
            f"(CUPTI) = {parts}; CRC share {share['crc32_sections']:.1%}, "
            f"copies {share[COPIES]:.1%} = "
            f"{b['split'].get(COPIES, 0.0):.4f} ms ({copies}), PyTorch "
            f"kernels "
            f"{share[PYTORCH]:.1%} in {b['pytorch_launches']} launches "
            f"(largest outside the hand-written kernels: {top}) [{card}]")


def check_pinned(b: dict) -> None:
    """The job's image copies go through pinned staging: both directions
    have pinned copies, and each outweighs its pageable copies (the
    stats' read-back and other small transfers)."""
    m = b["memcpy"]
    for way in ("HtoD", "DtoH"):
        pinned = m.get(f"{way} Pinned", (0, 0.0))[1]
        if pinned <= 0 or pinned <= m.get(f"{way} Pageable", (0, 0.0))[1]:
            raise AssertionError(f"the job's {way} copies are not through "
                                 f"pinned staging: {m}")


def same_image(a, b, what: str) -> None:
    """Raise unless two host images are byte-identical."""
    for name, x, y in zip(formats.SSTImage._fields, a, b):
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            raise AssertionError(f"job output {name} differs: {what}")


def same_trimmed(a, b, what: str) -> None:
    """Raise unless two host images are byte-identical once trimmed as
    ``write_sst`` trims them (engines pad a job differently)."""
    same_image(sstable.trim_image(a), sstable.trim_image(b), what)


def compare_job(kept: dict, geom: SSTGeometry, device) -> tuple[int, dict]:
    """Run the kept job through the engine on ``device`` with
    ``sort_mode="merge"`` and ``"device"`` (the bitonic sort), on the CPU,
    and through the numpy baseline (``CpuCompactionEngine.compact_paths``,
    which launches nothing); raise unless the merge images are
    byte-identical across devices, and the device-sort and baseline
    images (trimmed as ``write_sst`` trims them: they pad the job
    differently) equal the merge one.  Returns the live rows and the
    launch counts of the device-sort run."""
    images = [sstable.read_sst(p) for p in kept["paths"]]

    def run(dev, sort_mode):
        eng = TorchCompactionEngine(geom, device=dev, sort_mode=sort_mode)
        try:
            out, es = eng.compact(images, bottom_level=kept["bottom_level"])
        finally:
            eng.close()
        if not es.crc_ok:
            raise AssertionError(f"{dev} {sort_mode}: kept job failed CRC")
        return out, es

    (a, sa), (b, sb) = run(device, "merge"), run("cpu", "merge")
    same_image(a, b, f"{device} vs cpu")
    if (sa.n_input, sa.n_live) != (sb.n_input, sb.n_live):
        raise AssertionError("job stats differ between devices")
    before = ops.launch_counts()
    d, sd = CpuCompactionEngine(geom).compact_paths(
        kept["paths"], bottom_level=kept["bottom_level"])
    if ops.launch_counts() != before:
        raise AssertionError("the numpy baseline launched a kernel")
    same_trimmed(d, a, f"numpy baseline vs {device}")
    if (sd.n_input, sd.n_live, sd.crc_ok) != (sa.n_input, sa.n_live, True):
        raise AssertionError("job stats differ: numpy baseline vs "
                             f"{device}")
    ops.reset_launch_counts()
    c, sc = run(device, "device")
    launches = ops.launch_counts()
    same_trimmed(c, a, "sort_mode device vs merge")
    if (sc.n_input, sc.n_live) != (sa.n_input, sa.n_live):
        raise AssertionError("job stats differ between sort modes")
    return sa.n_live, launches


# ---------------------------------------------------------------------------
# phase 5: serve falcon-mamba-7b at full width
# ---------------------------------------------------------------------------


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def scan_cases(rng, dev, shapes=SCAN_SHAPES, di: int = 8192, ds: int = 16,
               u_dtype=torch.bfloat16):
    """(name, args, bytes, exponentials, other fp32 operations) of the scan
    at falcon-mamba's widths: ``u`` in the compute dtype, the rest fp32, at
    the scales of the model's prefill (softplus dt, ``A_log = log(1..ds)``
    plus noise).  Bytes count each input read once and each output written
    once; the exponentials are one per (b, t, i, s) and one per A entry;
    the other operations are per (b, t, i, s) a multiply for dt * A, a
    multiply and an add for the state, a multiply and an add for y, and per
    (b, t, i) dt * u and D * u plus its add."""
    cases = []
    for b, s in shapes:
        def normal(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)
        u = normal(b, s, di).to(u_dtype)
        dt = torch.nn.functional.softplus(normal(b, s, di) - 2.0)
        a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                       device=dev).repeat(di, 1)) \
            + 0.1 * normal(di, ds)
        args = (u, dt, normal(b, s, ds), normal(b, s, ds), a_log, normal(di))
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + 4 * (b * s * di + b * di * ds)
        cases.append((f"selective_scan/{b}x{s}", args, nbytes,
                      b * s * di * ds + di * ds,
                      5 * b * s * di * ds + 3 * b * s * di))
    return cases


def check_scan(dev, card: str, clock_hz: float, cases) -> dict:
    """The kernel against its plain version at each case, timed as in
    phase 2; raises beyond ``SCAN_TOL``."""
    results = {}
    sfu_per_s = SFU_PER_CLOCK_PER_SM * H100_SMS * clock_hz
    for name, args, nbytes, n_exp, n_ops in cases:
        (y, h), (want_y, want_h) = ops.selective_scan(*args), \
            ref.selective_scan(*args)
        torch.cuda.synchronize()
        err_y = float((y - want_y).abs().max())
        err_h = float((h - want_h).abs().max())
        lim_y = SCAN_TOL * float(want_y.abs().max())
        lim_h = SCAN_TOL * float(want_h.abs().max())
        if not (err_y <= lim_y and err_h <= lim_h):
            raise AssertionError(
                f"{name}: kernel differs from its plain version: max abs "
                f"err y {err_y:.3g} (limit {lim_y:.3g}), h_last {err_h:.3g}"
                f" (limit {lim_h:.3g})")
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "exponentials": n_exp / sfu_per_s * 1e3,
                 "fp32 operations": n_ops / SCALAR_OPS_PER_S * 1e3}
        worst = max(times, key=times.get)

        def kern(a=args):
            return ops.selective_scan(*a)

        def plain(a=args):
            return ref.selective_scan(*a)

        res = dict(max_abs_err=err_y, h_err=err_h, ms=device_ms(kern, 20),
                   plain_ms=device_ms(plain, 2), bound_ms=times[worst],
                   bound_by="bytes" if worst == "bytes" else "operations",
                   library_ms=None, call_ms=call_ms(kern, 20),
                   plain_call_ms=call_ms(plain, 2))
        log(f"  {name:22s} y {tuple(y.shape)}: max abs err y {err_y:.3g} "
            f"(limit {lim_y:.3g}), h_last {err_h:.3g} (limit {lim_h:.3g}); "
            f"device time kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms by "
            f"{worst} (bytes {times['bytes']:.4f}, exponentials "
            f"{times['exponentials']:.4f} at {clock_hz / 1e6:.0f} MHz, fp32 "
            f"operations {times['fp32 operations']:.4f}); one call "
            f"{res['call_ms']:.4f} ms, plain {res['plain_call_ms']:.4f} ms "
            f"[{card}]")
        results[name] = res
    return results


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (NaNs and signed zeros compare as
    bits); other tensors as they are."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def same_state(a, b) -> bool:
    """Two trees of tensors hold the same leaves, bit for bit."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and
        torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


def last_logits_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """Max abs difference of two logit tensors over the largest |b|, and
    the share of rows whose argmax agrees."""
    ratio = float((a - b).abs().max()) / float(b.abs().max())
    return ratio, float((a.argmax(-1) == b.argmax(-1)).float().mean())


def prefill_device_share(eng, prompts) -> tuple[float, float]:
    """Device time of one prefill and of its selective-scan kernels (ms),
    from the profiler's CUPTI trace."""
    split = split_device_time(device_breakdown(lambda: lm.prefill(
        eng.params, {"tokens": prompts}, eng.cfg, eng.max_len)))
    return sum(split.values()), split.get("selective_scan", 0.0)


def drop_free(cfg):
    """``cfg`` with an MoE capacity that holds every token (``c`` = the
    tokens: ``capacity_factor`` = experts / top-k), for comparing two
    routes through the model: capacity drops legitimately differ between
    a batched prefill and a one-token step (the JAX package's
    ``test_decode_matches_forward`` raises the capacity for the same
    reason).  Other configs come back as they are."""
    if not cfg.moe_experts:
        return cfg
    return cfg.with_(capacity_factor=max(cfg.capacity_factor,
                                         cfg.moe_experts / cfg.moe_top_k))


def decode_routes(eng, cache, first, pos, steps: int, *, enc_out=None,
                  captured: bool = True) -> dict:
    """``steps`` greedy decode steps from one state, eagerly
    (``model.decode_step``) and, with ``captured``, through the engine's
    captured step, each timed a step on the host clock after a
    synchronize; every logit must be finite.  With both routes the greedy
    tokens must be equal and the last logits and cache bit for bit equal
    or, should cuBLAS take other kernels under capture, within
    ``LOGIT_TOL`` (as every other pair of routes through the model).
    Returns each route's median ms, tokens, last logits and cache, and
    ``bitwise`` and ``gap`` (None without the captured route)."""
    dev, cfg = eng.device, eng.cfg
    ways = [("eager", lambda c, t, p: lm.decode_step(
        eng.params, c, t, p, cfg, enc_out=enc_out))]
    if captured:
        ways.append(("captured", lambda c, t, p: eng._decode(
            eng.params, c, t, p)))
    runs = {}
    for how, step_fn in ways:
        c, tok, p, toks, step_s = cache, first, pos, [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            step, c = step_fn(c, tok, p)
            sync(dev)
            step_s.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(step).all()):
                raise AssertionError(f"{cfg.name}: {how} decode logits are "
                                     "not all finite")
            tok, p = step[:, 0].argmax(-1)[:, None].to(torch.int32), p + 1
            toks.append(tok[:, 0])
        runs[how] = dict(ms=statistics.median(step_s) * 1e3,
                         tokens=torch.stack(toks, 1).cpu().numpy(),
                         logits=step, cache=c)
    runs["bitwise"] = runs["gap"] = None
    if captured:
        eager, capt = runs["eager"], runs["captured"]
        if not np.array_equal(eager["tokens"], capt["tokens"]):
            raise AssertionError(f"{cfg.name}: captured decode's greedy "
                                 "tokens differ from the eager step's")
        runs["gap"] = last_logits_gap(capt["logits"][:, 0],
                                      eager["logits"][:, 0])[0]
        runs["bitwise"] = same_state((capt["logits"], capt["cache"]),
                                     (eager["logits"], eager["cache"]))
        if not runs["bitwise"] and runs["gap"] > LOGIT_TOL:
            raise AssertionError(f"{cfg.name}: captured decode's last "
                                 f"logits differ by {runs['gap']:.3g} of "
                                 "the largest |logit|")
    return runs


def prefill_then_decode_gap(eng, inputs: dict, logit, *, enc_out=None
                            ) -> tuple[float, float]:
    """The last prompt token decoded onto the shorter prefill's state
    against ``logit``, the whole prompt's prefill (``last_logits_gap``);
    an MoE model runs drop-free on both routes (``drop_free``)."""
    cfg = drop_free(eng.cfg)
    if cfg is not eng.cfg:
        logit = lm.prefill(eng.params, inputs, cfg, eng.max_len)[0]
    short = dict(inputs, tokens=inputs["tokens"][:, :-1])
    _, c1, p1 = lm.prefill(eng.params, short, cfg, eng.max_len)
    dec, _ = lm.decode_step(eng.params, c1, inputs["tokens"][:, -1:], p1,
                            cfg, enc_out=enc_out)
    return last_logits_gap(dec[:, 0], logit)


def serve_phase(cfg, dev, *, batch: int, prompt_len: int, max_new: int,
                seed: int = 0) -> dict:
    """Build ``cfg`` from a seed on ``dev``, serve ``batch`` requests of
    ``prompt_len`` tokens through ``ServeEngine.generate`` (the launch
    counts are reset just before it and read just after), time prefill and
    decode, and compare prefill-then-decode with the longer prefill and,
    for a model with mamba layers, the kernel's prefill with the plain
    scan's, and split one prefill's device time."""
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(seed, cfg, device=dev)
    n_params = sum(a.numel() for a in tree_leaves(params))
    eng = ServeEngine(cfg, params, max_len=prompt_len + max_new, device=dev)
    del params   # the engine keeps its cast copy only
    sync(dev)
    init_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() if on_card else None
    card_bytes = sum(a.numel() * a.element_size()
                     for a in tree_leaves(eng.params))
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)
    eng.generate(prompts[:, :8], max_new=2)   # warm-up, not counted

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, cache, pos = eng.generate(prompts, max_new)
    sync(dev)
    gen_s = time.perf_counter() - t0
    launches = ops.launch_counts()

    prefill_s = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        logit, cache, pos = lm.prefill(eng.params, {"tokens": prompts}, cfg,
                                       eng.max_len)
        sync(dev)
        prefill_s.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logit).all()):
        raise AssertionError("prefill logits are not all finite")
    first_tok = logit.argmax(-1)[:, None].to(torch.int32)
    # decode from the same state both ways: the eager step, and the
    # engine's captured one (captured by the warm-up's generate)
    decode = decode_routes(eng, cache, first_tok, pos, max_new - 1)
    decode_gap = prefill_then_decode_gap(eng, {"tokens": prompts}, logit)
    plain_gap = share = None
    if "mamba" in cfg.pattern:
        # the same prefill with the plain scan in the kernel's place
        with mock.patch.object(ops, "selective_scan", ref.selective_scan):
            plain, _, _ = lm.prefill(eng.params, {"tokens": prompts}, cfg,
                                     eng.max_len)
        plain_gap = last_logits_gap(logit, plain)
        share = prefill_device_share(eng, prompts) if on_card else None
    peak = torch.cuda.max_memory_allocated() if on_card else None
    return dict(n_params=n_params, card_bytes=card_bytes, init_s=init_s,
                allocated=allocated, peak=peak,
                tokens=tokens, gen_s=gen_s, launches=launches,
                prefill_ms=statistics.median(prefill_s) * 1e3,
                decode_ms=decode["eager"]["ms"],
                captured_ms=decode["captured"]["ms"],
                captured_logits_gap=decode["gap"],
                captured_bitwise=decode["bitwise"],
                tokens_per_s=tokens.size / gen_s, decode_gap=decode_gap,
                plain_gap=plain_gap, prefill_device=share, engine=eng,
                prompts=prompts)


# ---------------------------------------------------------------------------
# phase 6: the paper's evaluation, LUDA against the CPU baseline
# ---------------------------------------------------------------------------

# (label, DBConfig.engine): the LUDA store on the card, the numpy baseline
STORES = (("LUDA", "device"), ("baseline", "cpu"))
# phase 6's records, in memtables: 9 load 8 full memtables at every value
# size (2 L0->L1 jobs of 4 files), which 10 did with one to spare (cut to
# keep the script's time as phase 8 came)
PAPER_MEMTABLES = 9


def paper_records(geom: SSTGeometry, v: int, memtables: int = 10) -> int:
    """Records for ``v``-byte values: ``memtables`` memtables (one SST's
    bytes each) of 16 B keys and values.  The paper's 10 M cut to a smoke
    run; 10 keep >= 2 L0->L1 jobs of >= 4 input files in a run."""
    return memtables * (geom.sst_bytes // (16 + v))


def host_line() -> str:
    """The host CPU and its count (the baseline's numbers are the host's):
    ``/proc/cpuinfo``'s model name where it names one, else its vendor,
    family, model number and clock."""
    info: dict[str, str] = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break   # the first processor's block
            key, _, val = line.partition(":")
            info[key.strip()] = val.strip()
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', 'CPU')} family "
                f"{info.get('cpu family', '?')} model "
                f"{info.get('model', '?')} at {info.get('cpu MHz', '?')} MHz "
                "(model name not reported)")
    return f"{name}, {os.cpu_count()} CPUs"


def sst_digests(path: str) -> dict[str, str]:
    """SHA-256 of each SST file in ``path``, by name."""
    out = {}
    for n in sorted(os.listdir(path)):
        if n.endswith(".sst"):
            with open(os.path.join(path, n), "rb") as f:
                out[n] = hashlib.sha256(f.read()).hexdigest()
    return out


def paper_phase(work: str, dev, *, value_sizes=PAPER.value_sizes,
                geometry=PAPER.geometry, sched=PAPER.scheduler(),
                memtables: int = 10, report=None) -> list[dict]:
    """Phase 6: YCSB-A (zipfian 0.99, half reads, half updates) at each
    value size through ``ycsb.run``, at ``PAPER.geometry(v)`` and
    ``PAPER.scheduler()``, on the LUDA store (the device engine on
    ``dev``) and on the CPU baseline (``engine="cpu"``, ``threads=1``, on
    ``device="cpu"``); ``ycsb.run`` checks every read and a full scan
    against the acknowledged writes.  The launch counts are set to 0
    before each run and read after it.  Raises unless each run had >= 2
    L0->L1 jobs of >= 4 input files, the two stores wrote the same SST
    files, the baseline launched no kernel, and the LUDA run on the card
    launched every kernel of ``WRITE_PATH``.  Returns one row a run, each
    also passed to ``report`` as it comes.  (``geometry``, ``sched`` and
    ``memtables`` scale the phase down for a rehearsal.)"""
    rows = []
    for v in value_sizes:
        n = paper_records(geometry(v), v, memtables)
        spec = PAPER.workload(v, records=n, operations=n)
        files = {}
        for label, engine in STORES:
            cfg = DBConfig(geom=geometry(v), scheduler=sched, engine=engine,
                           threads=1)
            path = os.path.join(work, f"ycsb-{engine}-{v}")
            ops.reset_launch_counts()
            r = ycsb.run(spec, cfg, path=path,
                         device=dev if engine == "device" else "cpu")
            r.update(store=label, launches=ops.launch_counts())
            files[engine] = sst_digests(path)
            shutil.rmtree(path)
            rows.append(r)
            if report is not None:
                report(r)
            if r["l0_jobs"] < 2 or r["l0_min_inputs"] < 4:
                raise AssertionError(
                    f"v={v} {label}: {r['l0_jobs']} L0->L1 jobs, the "
                    f"smallest of {r['l0_min_inputs']} inputs")
            idle = [k for k in WRITE_PATH if not r["launches"][k]]
            if engine == "cpu" and any(r["launches"].values()):
                raise AssertionError(f"v={v}: the baseline launched "
                                     f"{r['launches']}")
            if engine == "device" and r["device"].startswith("cuda") \
                    and idle:
                raise AssertionError(f"v={v}: the LUDA store launched no "
                                     f"{idle}")
        if files["device"] != files["cpu"]:
            raise AssertionError(f"v={v}: the LUDA and baseline stores "
                                 "wrote different SST files")
    return rows


def paper_row_line(r: dict, card: str, host: str) -> str:
    """The phase-6 report of one run."""
    def lat(op):
        return "/".join(f"{x:.1f}" for x in r["latency_us"][op])
    mb = r["compact_bytes_in"] / 1e6
    line = (f"[6] v={r['value_size']} B {r['store']} ({r['engine']} "
            f"engine on {r['device']}): {r['records']} records, "
            f"{r['operations']} operations; load {r['load_ops_s']:.0f} "
            f"ops/s, run {r['run_ops_s']:.0f} ops/s; read p50/p99/p99.9 "
            f"{lat('read')} us, update {lat('update')} us (host clock); "
            f"{r['flushes']} flushes, {r['compactions']} compactions "
            f"({r['l0_jobs']} L0->L1, each >= {r['l0_min_inputs']} "
            f"inputs), {r['compact_bytes_in']} B in; compaction "
            f"{mb / r['compact_wall_s']:.1f} MB/s over "
            f"{r['compact_wall_s']:.4f} s wall")
    if r["compact_device_s"] is not None:
        line += (f", {mb / r['compact_device_s']:.1f} MB/s over "
                 f"{r['compact_device_s']:.4f} s of device time (CUDA "
                 "events; a job (level, inputs, MB in, device ms): " +
                 ", ".join(f"({lv}, {k}, {b / 1e6:.1f}, {d * 1e3:.2f})"
                           for lv, k, b, _, d in r["jobs"]) + ")")
    if r["engine"] == "device":
        line += "; launches " + ", ".join(
            f"{k} {r['launches'][k]}" for k in WRITE_PATH)
    return line + f" [{card}; host {host}]"


def paper_ratio_line(luda: dict, base: dict, card: str, host: str) -> str:
    """The phase-6 LUDA / baseline line of one value size."""
    return (f"[6] v={luda['value_size']} B, LUDA / baseline: run ops/s "
            f"{luda['run_ops_s'] / base['run_ops_s']:.3f}x, load ops/s "
            f"{luda['load_ops_s'] / base['load_ops_s']:.3f}x, compaction "
            f"bytes/s over wall "
            f"{base['compact_wall_s'] / luda['compact_wall_s']:.3f}x (the "
            f"same {luda['compact_bytes_in']} B in each) [{card}; host "
            f"{host}]")


# ---------------------------------------------------------------------------
# phase 7: the served session paged through the store on the card
# ---------------------------------------------------------------------------

# the serving launcher's store (launch/serve.py, the JAX launcher's): 4 KiB
# values (4,088-byte chunk payloads), 32 KiB blocks, 512 KiB SSTs of 256
# entries, a 256 KiB memtable, the default scheduler (L0 at 4 files, L1
# 32 MiB)
SESSION_GEOM = SSTGeometry(key_bytes=16, value_bytes=4096,
                           block_bytes=32 * 1024, sst_bytes=512 * 1024)
SESSION_NAME = "chip-smoke"
SESSION_RESUME = 8
# the kernels the session's path runs: the prefill's scan, a flush's and a
# compaction's, and a multi_get wave's
SESSION_PATH = ("selective_scan",) + WRITE_PATH + READ_PATH
# an attention model's session path: no scan
ATTN_SESSION_PATH = WRITE_PATH + READ_PATH


def session_config() -> DBConfig:
    return DBConfig(geom=SESSION_GEOM, engine="device",
                    memtable_bytes=256 * 1024)


def state_bytes(state) -> int:
    return sum(a.numel() * a.element_size() for a in tree_leaves(state))


def check_state(got, want, what: str) -> None:
    if not same_state(got, want):
        raise AssertionError(f"{what}: the loaded state differs from the "
                             "saved one")


def keep_jobs(engine, keep_dir: str | None = None, *,
              first: int | None = None) -> list[dict]:
    """Wrap ``engine.compact_paths`` (what a store's compaction calls) so
    that each job records its input count ``n``, its ``merge_runs``
    launches, its ``"sort"`` span (as phase 3 counts them), its host
    interval and the records it dropped; given ``keep_dir``, also its
    input files (hard links: the store deletes them once the job is
    installed) and a copy of its output image (the engine's may lie in
    staging that the next job reuses), for ``check_jobs``.  Given
    ``first`` (a checkpoint store's jobs are too many and too large to
    keep each one), only the first ``first`` jobs and every job that
    dropped records are kept; the others' links are removed."""
    kept: list[dict] = []
    seen = [0]
    compact_paths = engine.compact_paths

    def watch_job(paths, *, bottom_level=False):
        job = dict(n=len(paths), bottom_level=bottom_level)
        if keep_dir is not None:
            d = os.path.join(keep_dir, str(seen[0]))
            os.makedirs(d)
            job["paths"] = [os.path.join(d, os.path.basename(p))
                            for p in paths]
            for p, q in zip(paths, job["paths"]):
                os.link(p, q)
        seen[0] += 1
        t0 = time.perf_counter()
        before = ops.launch_counts()["merge_runs"]
        out, es = compact_paths(paths, bottom_level=bottom_level)
        job.update(span=(t0, time.perf_counter()), sort_s=es.sort_seconds,
                   merge_launches=ops.launch_counts()["merge_runs"] - before,
                   dropped=es.n_dropped)
        if first is not None and len(kept) >= first and not es.n_dropped:
            if keep_dir is not None:
                shutil.rmtree(d)
            return out, es
        if keep_dir is not None:
            job["out"] = formats.SSTImage(*(np.array(x) for x in out))
        kept.append(job)
        return out, es

    engine.compact_paths = watch_job
    return kept


def merges_seen(kept: list[dict]) -> list[tuple]:
    """``keep_jobs``' jobs as ``merge_jobs_line`` takes them."""
    return [(j["n"], j["merge_launches"], j["sort_s"]) for j in kept]


def keep_flushes(engine, limit: int) -> list[dict]:
    """Wrap ``engine.build_image`` (a flush's build) so that the first
    ``limit`` flushes keep a copy of their entries and of the image they
    built, for ``check_flushes``."""
    kept: list[dict] = []
    build_image = engine.build_image

    def watch(keys, meta, vals):
        args = tuple(np.array(x) for x in (keys, meta, vals))
        img = build_image(keys, meta, vals)
        if len(kept) < limit:
            kept.append(dict(args=args, out=formats.SSTImage(
                *(np.array(x) for x in img))))
        return img

    engine.build_image = watch
    return kept


def check_flushes(kept: list[dict], geom: SSTGeometry, device) -> list[int]:
    """Each kept flush built again by an engine on ``device`` with every
    kernel wrapper routed to its plain version (no kernel launches):
    raise unless its image is byte-identical to the one the store's engine
    built.  Returns the entries a flush."""
    before = ops.launch_counts()
    with mock.patch.object(ops, "_on_card", lambda t: False):
        for f in kept:
            eng = TorchCompactionEngine(geom, device=device)
            try:
                img = eng.build_image(*f["args"])
            finally:
                eng.close()
            same_image(f["out"], img, f"the store's flush of "
                       f"{len(f['args'][0])} entries vs the plain versions")
    if ops.launch_counts() != before:
        raise AssertionError("the plain rebuild launched a kernel")
    return [len(f["args"][0]) for f in kept]


def check_jobs(kept: list[dict], geom: SSTGeometry, device) -> list[tuple]:
    """Each kept job again through an engine on ``device`` with every
    kernel wrapper routed to its plain version (``ops`` dispatch forced to
    ``ref``; no kernel launches): raise unless its image is byte-identical
    to the one the store's engine installed.  Returns (inputs, merge
    launches, live rows) a job."""
    out = []
    before = ops.launch_counts()
    with mock.patch.object(ops, "_on_card", lambda t: False):
        for job in kept:
            images = [sstable.read_sst(p) for p in job["paths"]]
            eng = TorchCompactionEngine(geom, device=device)
            try:
                img, es = eng.compact(images,
                                      bottom_level=job["bottom_level"])
            finally:
                eng.close()
            if not es.crc_ok:
                raise AssertionError("a kept job failed CRC on the plain "
                                     "versions")
            same_image(job["out"], img, f"the store's {len(images)}-input "
                       "job vs the plain versions")
            out.append((len(images), job["merge_launches"], es.n_live))
    if ops.launch_counts() != before:
        raise AssertionError("the plain rerun launched a kernel")
    return out


# the read wave's two wrappers, as ``lsm.read`` calls them
WAVE_WRAPPERS = ("bloom_multi_probe", "lookup_blocks_packed")


@contextlib.contextmanager
def keep_waves(limit: int | None = None, threads: tuple[str, ...] = ("",),
               names: tuple[str, ...] = WAVE_WRAPPERS, clone: bool = False):
    """Record each call of the ``ops`` wrappers ``names`` (the read-wave
    kernels by default) made inside (the first ``limit``, from threads
    whose names start with one of ``threads``): the wrapper's name, its
    inputs and keyword arguments, and its output (a copy with ``clone``,
    for an output that its caller may write to later)."""
    calls: list[tuple] = []

    def watch(name, fn):
        def call(*args, **kw):
            got = fn(*args, **kw)
            if (limit is None or len(calls) < limit) and \
                    threading.current_thread().name.startswith(threads):
                kept = got if not clone else (
                    tuple(t.clone() for t in got) if isinstance(got, tuple)
                    else got.clone())
                calls.append((name, args, kw, kept))
            return got
        return call

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(
                ops, name, watch(name, getattr(ops, name))))
        yield calls


def check_waves(calls: list[tuple]) -> list[tuple[str, tuple]]:
    """Hold each recorded wave call against its plain version on the same
    inputs and device: raise unless bit-identical.  Returns (wrapper,
    output shape) a call."""
    for name, args, kw, got in calls:
        if not torch.equal(got, getattr(ref, name)(*args, **kw)):
            raise AssertionError(f"the load's {name} of shape "
                                 f"{tuple(got.shape)} differs from its "
                                 "plain version")
    return [(name, tuple(got.shape)) for name, _, _, got in calls]


def check_scan_calls(calls: list[tuple]) -> list[tuple]:
    """Hold each recorded ``selective_scan`` call (``keep_waves(names=
    ("selective_scan",), clone=True)``) against the plain scan on the same
    inputs and device, within ``SCAN_TOL`` of the plain output's largest
    magnitude as ``check_scan`` holds it.  Returns (u's shape, max abs
    err y, max abs err h_last) a call."""
    out = []
    for _, args, kw, (y, h) in calls:
        want_y, want_h = ref.selective_scan(*args, **kw)
        err_y = float((y - want_y).abs().max())
        err_h = float((h - want_h).abs().max())
        if not (err_y <= SCAN_TOL * float(want_y.abs().max()) and
                err_h <= SCAN_TOL * float(want_h.abs().max())):
            raise AssertionError(
                f"selective_scan at {tuple(args[0].shape)} differs from its "
                f"plain version: max abs err y {err_y:.3g}, h_last "
                f"{err_h:.3g} (limit {SCAN_TOL} of the largest magnitude)")
        out.append((tuple(args[0].shape), err_y, err_h))
    return out


def session_phase(eng, prompts, work: str, *, max_new: int = SERVE_NEW,
                  resume: int = SESSION_RESUME,
                  db_cfg: DBConfig | None = None) -> dict:
    """Phase 7: ``generate`` ``max_new`` tokens for ``prompts``, page the
    ``(cache, pos)`` into an ``LsmDB`` on ``eng.device`` at
    ``SESSION_GEOM`` with ``save_session``, load it back with
    ``load_session`` and ``load_sessions`` (beside an absent session) bit
    for bit, decode ``resume`` steps from the loaded state through the
    captured step and hold them against an uninterrupted ``generate``;
    then save the newest state over the session, flush and compact (the
    superseded pages must be dropped), load it, close, reopen, load once
    more, and drop it.  The launch counts are set to 0 before the
    generate and read after the loads.  At the path's own shapes the
    kernels are held against their plain versions: each compaction job
    of the save and the churn (``keep_jobs``, ``check_jobs``) and each
    read-wave call of the first load (``keep_waves``, ``check_waves``).
    Returns the timings and counts; raises at the first check that fails.
    On the card the session's path must launch every kernel of
    ``SESSION_PATH`` (a model with mamba layers) or ``ATTN_SESSION_PATH``.
    (``db_cfg``, by default ``session_config()``, scales the store down
    for a rehearsal.)"""
    dev = eng.device
    kernels_of_path = SESSION_PATH if "mamba" in eng.cfg.pattern \
        else ATTN_SESSION_PATH
    path = os.path.join(work, "pages")
    keep_dir = os.path.join(work, "session-jobs")
    db_cfg = db_cfg or session_config()
    db = LsmDB(path, db_cfg, device=dev)
    kept = keep_jobs(db.engine, keep_dir)
    # the engine's cast params again: no copy of the weights is made
    seng = ServeEngine(eng.cfg, eng.params, max_len=prompts.shape[1]
                       + max_new + resume, device=dev, page_store=db)
    ops.reset_launch_counts()
    tokens, cache, pos = seng.generate(prompts, max_new)
    state = (cache, pos)
    sync(dev)
    t0 = time.perf_counter()
    records = seng.save_session(SESSION_NAME, cache, pos)
    sync(dev)
    save_s = time.perf_counter() - t0
    saved = db.stats
    levels = db.level_sizes()
    jobs = [(r.level, r.inputs, r.stats.bytes_in, r.stats.device_seconds)
            for r in db.compactions]
    t0 = time.perf_counter()
    encode_state(state)   # timed alone: the save's copy to the host
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with keep_waves() as calls:
        loaded = seng.load_session(SESSION_NAME)
        sync(dev)
    load_s = time.perf_counter() - t0
    read = db.stats
    waves = check_waves(calls)
    del calls
    if not waves:
        raise AssertionError("load_session called no read-wave kernel")
    t0 = time.perf_counter()
    many = seng.load_sessions([SESSION_NAME, "absent"], missing_ok=True)
    sync(dev)
    load_many_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_state(loaded, state, "load_session")
    check_state(many[0], state, "load_sessions")
    if many[1] is not None:
        raise AssertionError("load_sessions found the absent session")
    idle = [k for k in kernels_of_path if dev.type == "cuda" and
            not launches[k]]
    if idle:
        raise AssertionError(f"the session's path launched no {idle}")

    # resume from the loaded state through the captured step
    tok = torch.from_numpy(tokens[:, -1:]).to(dev)
    c, p = loaded
    outs = []
    t0 = time.perf_counter()
    for _ in range(resume):
        logits, c = seng._decode(seng.params, c, tok, p)
        tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
        outs.append(tok[:, 0])
        p = p + 1
    resumed = torch.stack(outs, 1).cpu().numpy()
    resume_s = time.perf_counter() - t0
    full = seng.generate(prompts, max_new + resume)[0]
    if not np.array_equal(resumed, full[:, max_new:]):
        raise AssertionError("the resumed tokens differ from the "
                             "uninterrupted run's")

    # churn: the newest state over the session, superseding every page
    newest = (c, p)
    t0 = time.perf_counter()
    seng.save_session(SESSION_NAME, c, p)
    db.flush()
    db.maybe_compact()
    sync(dev)
    churn_s = time.perf_counter() - t0
    churned = db.stats
    if churned.compact_entries_dropped <= saved.compact_entries_dropped:
        raise AssertionError("the compactions after the second save "
                             "dropped no superseded page")
    check_state(seng.load_session(SESSION_NAME), newest, "after the churn")
    churn_levels = db.level_sizes()
    db.close()
    t0 = time.perf_counter()
    job_checks = check_jobs(kept, db_cfg.geom, dev)
    check_jobs_s = time.perf_counter() - t0
    del kept
    shutil.rmtree(keep_dir)

    db = LsmDB(path, db_cfg, device=dev)
    try:
        seng = ServeEngine(eng.cfg, eng.params, max_len=seng.max_len,
                           device=dev, page_store=db)
        t0 = time.perf_counter()
        check_state(seng.load_session(SESSION_NAME), newest,
                    "after a reopen")
        reopen_load_s = time.perf_counter() - t0
        if not seng.drop_session(SESSION_NAME) or \
                seng.sessions.exists(SESSION_NAME):
            raise AssertionError("drop_session left the session behind")
    finally:
        db.close()
    return dict(bytes=state_bytes(state), records=records, save_s=save_s,
                encode_s=encode_s, read=read,
                load_s=load_s, load_many_s=load_many_s, resume_s=resume_s,
                resume=resume, churn_s=churn_s, reopen_load_s=reopen_load_s,
                saved=saved, churned=churned, levels=levels, jobs=jobs,
                churn_levels=churn_levels, launches=launches,
                tokens=resumed, waves=waves, job_checks=job_checks,
                check_jobs_s=check_jobs_s)


def synthetic_state(rng, nbytes: int):
    """A seeded ``(cache, pos)`` of falcon-mamba's layout and dtypes and
    about ``nbytes`` (a quarter bf16 conv state, the rest fp32 SSM
    state)."""
    n_conv = nbytes // 8
    n_ssm = (nbytes - 2 * n_conv) // 4 - 1
    conv = torch.from_numpy(rng.standard_normal(n_conv).astype(
        np.float32)).to(torch.bfloat16)
    ssm = torch.from_numpy(rng.standard_normal(n_ssm).astype(np.float32))
    pos = torch.full((1, 1), 528, dtype=torch.int32)
    return ({"blocks": {"p0": {"conv": conv, "ssm": ssm}}, "tail": []}, pos)


def cross_device_pages(work: str, dev, *, nbytes: int = 4 * 1024 * 1024,
                       seed: int = 7, db_cfg: DBConfig | None = None
                       ) -> dict:
    """One seeded state of about ``nbytes`` paged through a store on
    ``dev`` and one on the CPU at ``SESSION_GEOM``: each save flushes and
    runs an L0->L1 job, each store must load the state back bit for bit,
    and the two must write the same SST files (every store kernel against
    its plain version at 1,024-word values and 32 KiB blocks).  The
    launch counts are read around the ``dev`` store's run.  (``db_cfg``
    as in ``session_phase``.)"""
    host = synthetic_state(np.random.default_rng(seed), nbytes)
    db_cfg = db_cfg or session_config()
    runs = []
    for i, d in enumerate((torch.device(dev), torch.device("cpu"))):
        path = os.path.join(work, f"synthetic-{i}")
        db = LsmDB(path, db_cfg, device=d)
        try:
            store = LsmSessionStore(db, host)
            state = tree_map(lambda a, d=d: a.to(d), host)
            before = ops.launch_counts()
            records = store.save("synthetic", state)
            check_state(store.load("synthetic"), state,
                        f"the synthetic state on {d}")
            after = ops.launch_counts()
            runs.append(dict(device=d, records=records, stats=db.stats,
                             levels=db.level_sizes(),
                             launches={k: after[k] - before[k]
                                       for k in after}))
        finally:
            db.close()
        runs[-1]["files"] = sst_digests(path)
        shutil.rmtree(path)
    on_dev, on_cpu = runs
    if on_dev["stats"].compactions < 1:
        raise AssertionError("the synthetic save ran no compaction")
    if on_dev["files"] != on_cpu["files"]:
        raise AssertionError(f"the {dev} and cpu stores wrote different SST "
                             "files")
    return dict(bytes=state_bytes(host), dev=on_dev, cpu=on_cpu)


def session_lines(ss: dict, xd: dict, card: str) -> str:
    """The phase-7 report of ``session_phase`` and
    ``cross_device_pages``."""
    sv, rd, ch = ss["saved"], ss["read"], ss["churned"]
    chunks = ss["records"] - 1
    jobs = ", ".join(f"({lv}, {k}, {b / 1e6:.1f}, {d * 1e3:.2f})"
                     for lv, k, b, d in ss["jobs"])
    dv, cp = xd["dev"], xd["cpu"]
    return "\n".join([
        f"[7] save_session: {ss['bytes']} B of state, {ss['records']} "
        f"records (a head and {chunks} chunks) in one write_batch, "
        f"{ss['save_s']:.3f} s (host clock after a synchronize; "
        f"encode_state alone {ss['encode_s']:.3f} s); "
        f"{sv.flushes} flush ({sv.flush_host_seconds:.3f} s of it in the "
        f"flush), {sv.compactions} compactions "
        f"({sv.compact_wall_seconds:.3f} s of wall, "
        f"{sv.compact_device_seconds:.4f} s of CUDA-event device time; a "
        f"job (level, inputs, MB in, device ms): {jobs}); levels "
        f"{ss['levels']} [{card}]",
        f"[7] load_session {ss['load_s']:.3f} s (its multi_get of {chunks} "
        f"keys: {rd.multi_get_waves - sv.multi_get_waves} waves, "
        f"{rd.multi_get_stage_seconds - sv.multi_get_stage_seconds:.3f} s "
        f"in the device stages, "
        f"{rd.multi_get_staged_bytes - sv.multi_get_staged_bytes} B "
        f"staged), load_sessions([session, 'absent']) "
        f"{ss['load_many_s']:.3f} s (host clock); both bit for bit the "
        f"saved state, the absent session None [{card}]",
        f"[7] launches from the generate through the loads: " + ", ".join(
            f"{k} {ss['launches'][k]}" for k in SESSION_PATH),
        f"[7] the kernels against their plain versions at the path's "
        f"shapes: each compaction job of the save and the churn (inputs, "
        f"merge_runs launches, live rows) {ss['job_checks']} byte-identical "
        f"to its rerun on the plain versions on the same device "
        f"({ss['check_jobs_s']:.1f} s); load_session's read-wave calls "
        + ", ".join(
            f"{n} {list(shape)}" for n, shape in ss["waves"])
        + " bit-identical to the plain versions on the same inputs",
        f"[7] resume: {ss['resume']} captured decode steps from the loaded "
        f"state in {ss['resume_s'] * 1e3:.1f} ms equal the last "
        f"{ss['resume']} tokens of an uninterrupted generate",
        f"[7] churn: the newest state saved over the session, flush and "
        f"compact: {ss['churn_s']:.3f} s, "
        f"{ch.compactions - sv.compactions} more compactions dropped "
        f"{ch.compact_entries_dropped - sv.compact_entries_dropped} "
        f"superseded entries; levels {ss['churn_levels']}; loads equal the "
        f"newest state, also after a reopen ({ss['reopen_load_s']:.3f} s); "
        f"drop_session leaves nothing [{card}]",
        f"[7] a seeded {xd['bytes']} B state, {dv['records']} records, on "
        f"{dv['device']} and on cpu: {dv['stats'].flushes} flush and "
        f"{dv['stats'].compactions} compaction each, levels {dv['levels']};"
        f" the same {len(dv['files'])} SST files, loads bit for bit; "
        f"launches on {dv['device']}: " + ", ".join(
            f"{k} {dv['launches'][k]}" for k in WRITE_PATH + READ_PATH)
        + f", on cpu {sum(cp['launches'].values())}"])


# ---------------------------------------------------------------------------
# phase 8: the sharded store, its jobs stacked into batched launches
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_MEMTABLES = 4      # full memtables a shard a round
SHARD_VALUE = 256
SHARD_ROUNDS = 3         # two deterministic rounds, one in the background
BG_OPS = 20_000          # the YCSB-A mix of the background round
BG_SAMPLE = 5_000        # loaded keys read back by get and multi_get
# the kernels a batched round runs, recorded with their inputs
BATCH_WRAPPERS = ("merge_runs", "prefix_encode_wire", "bitonic_sort")


def memtable_records(geom: SSTGeometry, value_size: int) -> int:
    """Records of a 16-byte key and ``value_size`` bytes that fill one
    memtable (``geom.sst_bytes``, the store's default): the flush comes
    with the record that reaches the limit."""
    return -(-geom.sst_bytes // (16 + value_size))


def ycsb_value(i: int, width: int) -> bytes:
    """YCSB's value of record ``i`` (``data.ycsb.YCSBWorkload``'s)."""
    return ((b"%016d" % i) * (width // 16 + 1))[:width]


def shard_keys(cuts: list[bytes], shards: int, per_shard: int
               ) -> list[list[int]]:
    """YCSB record ids routed to their shards by the boundary table, in id
    order, until each shard has ``per_shard``."""
    import bisect
    out: list[list[int]] = [[] for _ in range(shards)]
    i, full = 0, 0
    while full < shards:
        s = bisect.bisect_right(cuts, key_of(i))
        if len(out[s]) < per_shard:
            out[s].append(i)
            full += len(out[s]) == per_shard
        i += 1
    return out


def keep_batches(engine, keep_dir: str) -> list[dict]:
    """Wrap ``engine.compact_many`` (what the compaction queue calls) so
    that each round keeps, a job, its input files (hard links), its
    signature and its installed image, and the round's ``merge_runs``
    launches, for ``check_jobs`` and the device-sort batch."""
    from repro_torch.core.scheduler import batch_signature
    rounds: list[dict] = []
    compact_many = engine.compact_many

    def watch(jobs):
        kept = []
        for i, (paths, bottom) in enumerate(jobs):
            d = os.path.join(keep_dir, f"{len(rounds)}-{i}")
            os.makedirs(d)
            links = [os.path.join(d, os.path.basename(p)) for p in paths]
            for p, q in zip(paths, links):
                os.link(p, q)
            blocks = [sstable.read_sst(q).keys.shape[0] for q in links]
            kept.append(dict(paths=links, bottom_level=bottom,
                             sig=batch_signature(blocks, bottom)))
        before = ops.launch_counts()["merge_runs"]
        results = compact_many(jobs)
        merges = ops.launch_counts()["merge_runs"] - before
        for job, (out, es) in zip(kept, results):
            job.update(out=formats.SSTImage(*(np.array(x) for x in out)),
                       batched=es.batched, merge_launches=merges)
        rounds.append(dict(jobs=kept, merge_launches=merges))
        return results

    engine.compact_many = watch
    return rounds


@contextlib.contextmanager
def keep_batch_calls():
    """Record each kernel call made inside on a batch of jobs (a leading
    job axis): the wrapper, its inputs and keyword arguments, its output
    and the launches it made."""
    calls: list[tuple] = []

    def watch(name, fn):
        def call(*args, **kw):
            before = ops.launch_counts()
            got = fn(*args, **kw)
            if args[0].dim() == 3:
                after = ops.launch_counts()
                calls.append((name, args, kw, got, {
                    k: after[k] - before[k] for k in after
                    if after[k] != before[k]}))
            return got
        return call

    with contextlib.ExitStack() as stack:
        for name in BATCH_WRAPPERS:
            stack.enter_context(mock.patch.object(
                ops, name, watch(name, getattr(ops, name))))
        yield calls


def check_batch_calls(calls: list[tuple]) -> list[tuple]:
    """Hold each recorded batch call against its plain batched version on
    the same inputs and device, bit for bit, and its launches against the
    one job's on the card: ceil(log2 k') for the merge (its level plan),
    one for the prefix step, ``bitonic_sort.launches(n, lanes)`` for the
    sort.  Returns (wrapper, input shape, launches) a call."""
    out = []
    for name, args, kw, got, launches in calls:
        rows = args[0]
        if name == "merge_runs":
            want = ref.merge_runs_batched(rows, args[1])
            plan = {"merge_runs": len(merge_path.launch_tables(
                tuple(args[1]))[0])}
        elif name == "prefix_encode_wire":
            want = ref.prefix_encode_wire_batched(*args, **kw)
            plan = {"prefix_encode": 1}
        else:
            want = torch.stack([ref.sort_tuples(r) for r in rows])
            plan = {"bitonic_sort": sort_plan.launches(*rows.shape[1:])}
        plan = {k: v for k, v in plan.items() if v}
        compare_outputs(f"the batched {name} of {tuple(rows.shape)}", got,
                        want)
        if rows.device.type == "cuda" and launches != plan:
            raise AssertionError(f"the batched {name} of "
                                 f"{tuple(rows.shape)} made {launches}, "
                                 f"not the one job's {plan}")
        out.append((name, tuple(rows.shape), sum(launches.values())))
    return out


@contextlib.contextmanager
def one_round_per_notify():
    """Keep the caller's thread on the interpreter (a long switch
    interval) while ``maybe_compact`` notifies every shard, so the queue's
    worker starts its round with all of them pending: which shards share
    a round is otherwise a race with the worker."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def store_counts(db) -> dict:
    """A sharded store's batching counters: the engine's stacked launches,
    the shards' summed ``DBStats``, the queue's rounds."""
    return dict(engine=(db.engine.batch_launches, db.engine.batch_jobs,
                        db.engine.max_batch_jobs),
                stats=db.stats,
                queue=(db.queue.rounds, db.queue.jobs_run,
                       db.queue.trivial_moves))


def counts_line(what: str, c: dict) -> str:
    st = c["stats"]
    return (f"[8] {what}: engine batch_launches {c['engine'][0]}, "
            f"batch_jobs {c['engine'][1]}, max_batch_jobs "
            f"{c['engine'][2]}; batched_compactions "
            f"{st.batched_compactions} of {st.compactions} compactions, "
            f"{st.trivial_moves} trivial moves; queue rounds "
            f"{c['queue'][0]}, jobs_run {c['queue'][1]}, trivial_moves "
            f"{c['queue'][2]}")


def read_back(db, model: dict, updated: dict, keys: list, value_size: int,
              when: str) -> int:
    """``keys`` by ``multi_get`` (batches of 4,096, first, so that its
    waves find their blocks undecoded and run the bloom prune) and by
    ``get``, and every acknowledged write through one scan across all
    shards: raise on any difference.  ``model`` maps a loaded key
    to its YCSB record id, ``updated`` a key the mix wrote to its value.
    Returns the scan's rows."""
    def want(k):
        if k in updated:
            return updated[k]
        i = model.get(k)
        return None if i is None else ycsb_value(i, value_size)

    wants = [want(k) for k in keys]
    for s in range(0, len(keys), 4096):
        if db.multi_get(keys[s:s + 4096]) != wants[s:s + 4096]:
            raise AssertionError(f"{when}: multi_get disagrees")
    if [db.get(k) for k in keys] != wants:
        raise AssertionError(f"{when}: get disagrees")
    got = db.scan(b"\x00", b"\xff" * 16)
    keys_all = sorted(set(model) | set(updated))
    if [k for k, _ in got] != keys_all or \
            any(v != want(k) for k, v in got):
        raise AssertionError(f"{when}: the scan across shards disagrees "
                             "with the acknowledged writes")
    return len(got)


def stacked_against_single(jobs: list, geom: SSTGeometry, device) -> dict:
    """The same jobs through one engine as one stacked ``compact_many``
    and one ``compact_paths`` at a time (each warmed up once): host wall,
    CUDA-event span (the jobs' ``device_seconds``), ``merge_runs``
    launches, and the CUPTI trace's device time and PyTorch kernel
    launches.  Raises unless the two give the same images."""
    eng = TorchCompactionEngine(geom, device=device)

    def stacked():
        return eng.compact_many(jobs)

    def single():
        return [eng.compact_paths(p, bottom_level=b) for p, b in jobs]

    out = {}
    try:
        for name, fn in (("stacked", stacked), ("single", single)):
            fn()
            before = ops.launch_counts()["merge_runs"]
            t0 = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t0
            merges = ops.launch_counts()["merge_runs"] - before
            trace = max((device_trace(fn) for _ in range(2)), key=len)
            by_name: dict[str, float] = {}
            for n, ms in trace:
                by_name[n] = by_name.get(n, 0.0) + ms
            out[name] = dict(
                res=res, wall_s=wall, merges=merges,
                span_ms=sum(es.device_seconds for _, es in res) * 1e3,
                device_ms=sum(ms for _, ms in trace),
                pytorch=sum(event_kind(n) == PYTORCH for n, _ in trace),
                split=split_device_time(by_name),
                top=sorted(((ms, n) for n, ms in by_name.items()),
                           reverse=True)[:4])
    finally:
        eng.close()
    for (a, _), (b, _) in zip(out["stacked"]["res"], out["single"]["res"]):
        same_image(a, b, "stacked vs one at a time")
    if eng.max_batch_jobs != len(jobs) or \
            not all(es.batched for _, es in out["stacked"]["res"]):
        raise AssertionError("the timed jobs were not stacked")
    return out


def sharded_phase(work: str, dev, *, geom: SSTGeometry = PAPER_GEOM,
                  sched: SchedulerConfig = PAPER_SCHED,
                  value_size: int = SHARD_VALUE, shards: int = SHARDS,
                  memtables: int = SHARD_MEMTABLES, bg_ops: int = BG_OPS,
                  sample: int = BG_SAMPLE, seed: int = 42,
                  timing: bool = True) -> dict:
    """Phase 8: ``ShardedDB`` on ``dev``, ``shards`` shards split by
    ``boundaries_from_sample`` over the YCSB load keys.

    Two deterministic rounds (``auto_compact=False``): ``memtables`` full
    memtables a shard, then ``maybe_compact()``, the queue's round seen
    by ``keep_batches`` and its kernel calls by ``keep_batch_calls``.  A
    background round (``auto_compact=True``, the store reopened): as many
    records again through ``write_batch`` while the queue drains on its
    worker, then ``bg_ops`` of YCSB-A (zipfian 0.99), every read checked;
    every acknowledged write read back by one scan across the shards,
    and the mix's writes and a sample of the loaded keys by ``get`` and
    ``multi_get`` (``read_back``), again after a reopen.  The launch counts are set to 0 before the first round and
    read after the background round's read-back.  Then: each kept job rerun alone on
    the plain versions (``check_jobs``), the batch calls held against
    the plain batched versions, the first round's jobs as one
    ``sort_mode="device"`` batch (its images and its batched sort held
    likewise), and, with ``timing``, the first round stacked against the
    same jobs one at a time (``stacked_against_single``)."""
    from repro_torch.lsm.sharded import ShardedDB, boundaries_from_sample
    per_round = memtables * memtable_records(geom, value_size)
    cuts = boundaries_from_sample(
        [key_of(i) for i in range(4 * shards * per_round)], shards)
    ids = shard_keys(cuts, shards, SHARD_ROUNDS * per_round)
    path = os.path.join(work, "sharded")
    model: dict[bytes, int] = {}
    updated: dict[bytes, bytes] = {}
    out: dict = {"per_round": per_round, "cuts": cuts}

    ops.reset_launch_counts()
    db = ShardedDB(path, DBConfig(geom=geom, scheduler=sched,
                                  auto_compact=False),
                   shards=shards, boundaries=cuts, device=dev)
    rounds = keep_batches(db.engine, os.path.join(work, "kept"))
    calls = []
    det = []
    for r in range(2):
        t0 = time.perf_counter()
        for s in range(shards):
            for i in ids[s][r * per_round:(r + 1) * per_round]:
                k = key_of(i)
                db.put(k, ycsb_value(i, value_size))
                model[k] = i
        t_load = time.perf_counter() - t0
        flushes = [st.flushes for st in db.shard_stats()]
        if flushes != [memtables * (r + 1)] * shards:
            raise AssertionError(f"round {r + 1}: shard flushes {flushes}")
        t0 = time.perf_counter()
        with keep_batch_calls() as got, one_round_per_notify():
            db.maybe_compact()
        det.append(dict(load_s=t_load, compact_s=time.perf_counter() - t0,
                        levels=db.level_sizes(), rounds=db.queue.rounds,
                        batch_launches=db.engine.batch_launches))
        calls += got
    out["det"] = det
    first = rounds[0]["jobs"]
    if len(rounds[0]["jobs"]) != shards or \
            not all(j["batched"] for j in first) or \
            db.engine.max_batch_jobs != shards:
        raise AssertionError(f"the first round was not one stacked launch "
                             f"of {shards} jobs: {[j['sig'] for j in first]}")
    out["det_counts"] = store_counts(db)
    db.close()

    # the background round: the queue drains while the caller writes
    db = ShardedDB(path, DBConfig(geom=geom, scheduler=sched), device=dev)
    bg = keep_batches(db.engine, os.path.join(work, "kept-bg"))
    t0 = time.perf_counter()
    batch = []
    for i in sorted(i for s in range(shards)
                    for i in ids[s][2 * per_round:]):
        k = key_of(i)
        batch.append(("put", k, ycsb_value(i, value_size)))
        model[k] = i
        if len(batch) == 1000:
            db.write_batch(batch)
            batch = []
    if batch:
        db.write_batch(batch)
    t_load = time.perf_counter() - t0
    spec = WorkloadSpec.ycsb_a(records=max(model.values()) + 1,
                               operations=bg_ops, value_size=value_size,
                               seed=seed)
    t0 = time.perf_counter()
    reads = 0
    for kind, k, v in YCSBWorkload(spec).run_ops():
        if kind == "read":
            want = updated.get(k)
            if want is None and k in model:
                want = ycsb_value(model[k], value_size)
            if db.get(k) != want:
                raise AssertionError(f"a YCSB read of {k!r} disagrees")
            reads += 1
        else:
            db.put(k, v)
            updated[k] = v
    t_mix = time.perf_counter() - t0
    db.wait_idle()
    out["bg"] = dict(load_s=t_load, mix_s=t_mix, reads=reads,
                     updates=bg_ops - reads, rounds=len(bg),
                     jobs=sum(len(r["jobs"]) for r in bg),
                     groups=[[j["sig"][1] for j in r["jobs"]] for r in bg],
                     levels=db.level_sizes())
    rng = np.random.default_rng(seed)
    loaded = list(model)
    keys = list(updated) + [loaded[i] for i in rng.choice(
        len(loaded), min(sample, len(loaded)), replace=False)] + \
        [b"absent%010d" % i for i in range(200)]
    t0 = time.perf_counter()
    out["scan_rows"] = read_back(db, model, updated, keys, value_size,
                                 "before reopen")
    out["read_s"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    out["bg_counts"] = store_counts(db)
    db.close()
    db = ShardedDB(path, DBConfig(geom=geom, scheduler=sched), device=dev)
    t0 = time.perf_counter()
    if read_back(db, model, updated, keys, value_size,
                 "after reopen") != out["scan_rows"]:
        raise AssertionError("the reopened store scans other rows")
    out["reopen_read_s"] = time.perf_counter() - t0
    db.close()
    out["checked_keys"] = len(keys)

    # each job alone on the plain versions; the batch calls likewise
    t0 = time.perf_counter()
    kept = [j for r in rounds for j in r["jobs"]]
    out["job_checks"] = check_jobs(kept, geom, dev)
    out["calls"] = check_batch_calls(calls)
    out["rounds"] = [[(j["sig"][1], j["batched"]) for j in r["jobs"]]
                     + [("merge launches", r["merge_launches"])]
                     for r in rounds]

    # the first round's jobs as one sort_mode="device" batch
    jobs = [(j["paths"], j["bottom_level"]) for j in first]
    eng = TorchCompactionEngine(geom, device=dev, sort_mode="device")
    try:
        with keep_batch_calls() as dcalls:
            res = eng.compact_many(jobs)
        if eng.batch_launches != 1 or not all(es.batched for _, es in res):
            raise AssertionError("the device-sort jobs were not stacked")
    finally:
        eng.close()
    for job, (img, _) in zip(first, res):
        same_trimmed(job["out"], img, "sort_mode device batch vs merge")
    out["device_calls"] = check_batch_calls(dcalls)
    out["check_s"] = time.perf_counter() - t0
    if timing and torch.device(dev).type == "cuda":
        out["timing"] = stacked_against_single(jobs, geom, dev)
    shutil.rmtree(path)
    return out


def sharded_lines(sh: dict, card: str) -> str:
    """The phase-8 report of ``sharded_phase``."""
    lines = [
        f"[8] boundaries from the YCSB load keys: "
        f"{[c.decode() for c in sh['cuts']]}; {sh['per_round']} records a "
        f"shard a round ({SHARD_MEMTABLES} full memtables)"]
    for r, (d, groups) in enumerate(zip(sh["det"], sh["rounds"]), 1):
        lines.append(
            f"[8] deterministic round {r}: load {d['load_s']:.1f} s, "
            f"maybe_compact {d['compact_s']:.2f} s; jobs (bucket blocks, "
            f"batched) and the round's merge_runs launches: {groups}; "
            f"levels {d['levels']} [{card}]")
    bg = sh["bg"]
    lines += [
        f"[8] background round (auto_compact=True): load "
        f"{bg['load_s']:.1f} s while the queue drained ({bg['rounds']} "
        f"rounds, {bg['jobs']} jobs, buckets a round {bg['groups']}); "
        f"YCSB-A {bg['reads']} reads (each checked) and {bg['updates']} "
        f"updates in {bg['mix_s']:.1f} s; levels {bg['levels']} [{card}]",
        f"[8] every acknowledged write read back by a {sh['scan_rows']}-"
        f"row scan across the shards, and {sh['checked_keys']} keys (every "
        f"write of the mix, a sample of the loads, absent keys) by get and "
        f"multi_get ({sh['read_s']:.1f} s); the same after close and reopen "
        f"({sh['reopen_read_s']:.1f} s)",
        counts_line("the deterministic rounds", sh["det_counts"]),
        counts_line("the background round", sh["bg_counts"]),
        f"[8] launches (the rounds and the background): " + ", ".join(
            f"{k} {sh['launches'][k]}" for k in STORE_PATH),
        f"[8] each job rerun alone on the plain versions (inputs, merge "
        f"launches of its batch, live rows) {sh['job_checks']} "
        f"byte-identical; the batched calls (wrapper, shape, launches) "
        f"{sh['calls']} bit-identical to the plain batched versions; the "
        f"first round as one sort_mode='device' batch: images equal the "
        f"merge's, its calls {sh['device_calls']} ({sh['check_s']:.1f} s)"]
    tm = sh.get("timing")
    if tm:
        parts = []
        for name in ("stacked", "single"):
            t = tm[name]
            split = ", ".join(f"{k} {ms:.4f}" for k, ms in sorted(
                t["split"].items(), key=lambda x: -x[1]))
            top = "; ".join(f"{n[:50]} {ms:.4f}" for ms, n in t["top"])
            parts.append(
                f"{name}: {t['merges']} merge_runs launches, "
                f"{t['pytorch']} PyTorch kernel launches, CUDA-event span "
                f"{t['span_ms']:.3f} ms, device time {t['device_ms']:.3f} "
                f"ms (CUPTI, ms: {split}; largest: {top}), host wall "
                f"{t['wall_s'] * 1e3:.1f} ms")
        lines.append(f"[8] the first round's {SHARDS} jobs stacked against "
                     f"one at a time: " + "; ".join(parts) + f" [{card}]")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# phase 9: the async write path (ROADMAP A8)
# ---------------------------------------------------------------------------

# LUDA's paper geometry at 1,024 B values: 4,033 records a 4 MB memtable
ASYNC_VALUE = 1024
ASYNC_GEOM = PAPER.geometry(ASYNC_VALUE)
ASYNC_MEMTABLES = 8          # (a): full memtables of the seeded stream
ASYNC_FLUSH_WORKERS = 3      # (a), (d)
ASYNC_PENDING = 4            # (a), (d): max_pending_memtables
HALT_MEMTABLES = 3           # (d): memtables queued when the build fails
READERS = 2                  # (c): reader threads beside the writer
READER_SAMPLE = 64           # (c): the fixed keys they read
READER_PAUSE = 0.025         # (c): seconds a reader rests between passes
ASYNC_SHARD_OPS = 20_000     # (e): the YCSB-A mix
ASYNC_SHARD_SAMPLE = 2_000   # (e): loaded keys read back
CAPTURE_BATCH = 2            # (f): a batch size phases 5 and 7 never capture
CAPTURE_WAIT = 120.0         # (f): seconds the gated flush and capture wait
KEPT_FLUSHES = 2             # (a): flushes rebuilt on the plain versions
KEPT_WAVES = 8               # (a), (c): wave calls held against ``ref``
# the async store's background threads, by name
WORKERS = ("flush-", "compact-", "shard-compact-")


@contextlib.contextmanager
def launch_log():
    """Record every kernel launch made while the block runs, as ``(thread
    name, kernel, launches, host time)``: ``_build.launch`` is where every
    wrapper launches and counts."""
    log: list[tuple[str, str, int, float]] = []
    real = _build.launch

    def launch(name, *args, launched=None):
        real(name, *args, launched=launched)
        log.append((threading.current_thread().name, name,
                    1 if launched is None else launched.value,
                    time.perf_counter()))

    with mock.patch.object(_build, "launch", launch):
        yield log


def launches_by(log, prefixes, spans=None) -> dict[str, int]:
    """Launches a kernel in ``log`` made on threads whose names start with
    one of ``prefixes`` (and, given ``spans``, inside one of those host
    intervals)."""
    out: collections.Counter = collections.Counter()
    for thread, name, n, t in log:
        if thread.startswith(prefixes) and (
                spans is None or any(a <= t <= b for a, b in spans)):
            out[name] += n
    return dict(out)


class TimedLock:
    """The engine's lock, recording how long each ``with`` waited to take
    it, by thread kind (the thread's name without its number): a flush
    worker waits there behind another build or a compaction.  ``on_wait``,
    if set, is called with the kind before each ``with`` takes the lock."""

    def __init__(self, lock):
        self._lock = lock
        self.waits: dict[str, list[float]] = collections.defaultdict(list)
        self.on_wait = None

    def __enter__(self):
        kind = threading.current_thread().name.rstrip("0123456789")
        if self.on_wait is not None:
            self.on_wait(kind)
        t0 = time.perf_counter()
        self._lock.acquire()
        self.waits[kind].append(time.perf_counter() - t0)
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def summary(self) -> dict[str, tuple[int, float, float]]:
        """Per thread kind: entries, total and longest wait in ms."""
        return {k: (len(w), 1e3 * sum(w), 1e3 * max(w))
                for k, w in sorted(self.waits.items())}


def seeded_stream(seed: int, n: int, value_size: int) -> list:
    """``n`` seeded writes over ``2 n`` YCSB keys: puts of values stamped
    with their op number (``ycsb_value(i)``), overwrites among them, and
    one delete in ten (``None``)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2 * n, n)
    dels = rng.random(n) < 0.1
    return [(key_of(int(k)), None if d else ycsb_value(i, value_size))
            for i, (k, d) in enumerate(zip(ids, dels))]


def apply_stream(db, stream, model: dict) -> None:
    for k, v in stream:
        if v is None:
            db.delete(k)
            model.pop(k, None)
        else:
            db.put(k, v)
            model[k] = v


def check_model(db, model: dict, keys, when: str,
                waves: list | None = None) -> int:
    """``keys`` by ``multi_get`` (first, so its waves reach the bloom
    prune) and by ``get`` against ``model``; raises on a difference.
    With ``waves``, the ``multi_get``'s first ``KEPT_WAVES`` wave calls
    are held against their plain versions (``check_waves``) and their
    (wrapper, shape) appended to it.  Returns the keys read."""
    keys = list(keys)
    want = [model.get(k) for k in keys]
    with contextlib.nullcontext([]) if waves is None else \
            keep_waves(limit=KEPT_WAVES) as calls:
        got = db.multi_get(keys)
    if waves is not None:
        waves.extend(check_waves(calls))
    if got != want:
        raise AssertionError(f"{when}: multi_get disagrees with the "
                             "acknowledged writes")
    if [db.get(k) for k in keys] != want:
        raise AssertionError(f"{when}: get disagrees with the "
                             "acknowledged writes")
    return len(keys)


def async_config(geom, sched, **kw) -> DBConfig:
    return DBConfig(geom=geom, scheduler=sched, async_compaction=True,
                    flush_workers=ASYNC_FLUSH_WORKERS,
                    max_pending_memtables=ASYNC_PENDING, **kw)


def drain(db, on_card: bool) -> float | None:
    """``maybe_compact()`` + ``wait_idle()``: the compaction drain, on the
    store's compaction worker when it is async.  On the card it runs once
    under the profiler, and the CUPTI device time (ms) of all the card ran
    meanwhile, kernels and copies, is returned: nothing else runs then, so
    it is the drain's own.  None on the CPU, or when the trace lost its
    marker (``trace_once``)."""
    def run():
        db.maybe_compact()
        db.wait_idle()
    if not on_card:
        run()
        return None
    events = trace_once(run)
    return sum(ms for _, ms in events) if events else None


def flush_behind_compaction(db, lock: TimedLock, model: dict, *,
                            geom: SSTGeometry, sched: SchedulerConfig,
                            value_size: int, keys: list, first: int,
                            seed: int) -> dict:
    """Phase 9 (a), last: a flush's wait at the engine lock behind a
    running compaction, on the async store ``db`` (``auto_compact=False``,
    drained).  ``sched.l0_trigger + 1`` memtables of overwrites of
    ``keys`` (values numbered from ``first``) fill L0; ``maybe_compact()``
    starts a job, which takes the engine lock and holds it (here, not in
    the package) until a flush worker waits there, while the writer
    rotates one more memtable.  Returns the flush's wait and the job's
    host time inside the lock (ms): the wait is the rest of the job."""
    recs = memtable_records(geom, value_size)
    rng = np.random.default_rng(seed)
    i = first

    def put(k):
        nonlocal i
        db.put(k, ycsb_value(i, value_size))
        model[k] = ycsb_value(i, value_size)
        i += 1

    for j in rng.integers(0, len(keys), (sched.l0_trigger + 1) * recs):
        put(keys[j])
    db.wait_idle()
    l0 = db.level_sizes()[0]
    if l0 < sched.l0_trigger:
        raise AssertionError(f"(a) {l0} L0 files make no compaction")
    compacting, waiting = threading.Event(), threading.Event()
    job_ms: list[float] = []
    real = db.engine.compact_paths

    def gated(paths, *, bottom_level=False):
        if compacting.is_set():
            return real(paths, bottom_level=bottom_level)
        with lock:
            compacting.set()
            if not waiting.wait(timeout=CAPTURE_WAIT):
                raise AssertionError("(a) no flush came to the engine lock")
            t0 = time.perf_counter()
            try:
                return real(paths, bottom_level=bottom_level)
            finally:
                job_ms.append(1e3 * (time.perf_counter() - t0))

    db.engine.compact_paths = gated
    lock.on_wait = lambda kind: kind == "flush-" and waiting.set()
    mark = len(lock.waits["flush-"])
    try:
        db.maybe_compact()
        if not compacting.wait(timeout=CAPTURE_WAIT):
            raise AssertionError("(a) maybe_compact() started no job")
        for j in rng.integers(0, len(keys), 2 * recs):
            put(keys[j])
            if db.imm:
                break
        else:
            raise AssertionError("(a) no memtable rotated")
        db.wait_idle()
    finally:
        lock.on_wait = None
        db.engine.compact_paths = real
    waits = lock.waits["flush-"][mark:]
    if len(waits) != 1 or not job_ms:
        raise AssertionError(f"(a) {len(waits)} flushes behind the job")
    return dict(l0=l0, wait_ms=1e3 * waits[0], job_ms=job_ms[0],
                puts=i - first)


def async_files_phase(work: str, dev, *, geom: SSTGeometry,
                      sched: SchedulerConfig, value_size: int = ASYNC_VALUE,
                      memtables: int = ASYNC_MEMTABLES, seed: int = 26
                      ) -> dict:
    """Phase 9 (a): one seeded stream of puts and deletes (``memtables``
    full memtables and a quarter) into a sync store and an async one
    (``flush_workers=3``, ``max_pending_memtables=4``), both with
    ``auto_compact=False``.  After ``wait_idle()`` the SST files must be
    byte-identical; again after the compaction drain (``drain``: on the
    card its CUPTI device time, beside the jobs' CUDA-event spans).  Each
    job's merge must take one launch a level of its merge tree; on the
    card every write-path kernel must have launched from the async store's
    worker threads.  A sample of keys is read back from both.  Then, on
    the async store, one flush queued behind a running compaction
    (``flush_behind_compaction``); and the async store's compaction jobs
    and first ``KEPT_FLUSHES`` flushes are run again on the plain versions
    (``check_jobs``, ``check_flushes``: byte-identical), and the wave
    calls of its read-back held against ``ref`` (``check_waves``)."""
    n = memtables * memtable_records(geom, value_size) * 5 // 4
    stream = seeded_stream(seed, n, value_size)
    keys = sorted(set(k for k, _ in stream))
    on_card = torch.device(dev).type == "cuda"
    out: dict = {"ops": n}
    files = {}
    keep_dir = os.path.join(work, "files-kept")
    with launch_log() as log:
        for mode in ("sync", "async"):
            path = os.path.join(work, f"files-{mode}")
            cfg = async_config(geom, sched, auto_compact=False)
            if mode == "sync":
                cfg = dataclasses.replace(cfg, async_compaction=False)
            db = LsmDB(path, cfg, device=dev)
            jobs = keep_jobs(db.engine,
                             keep_dir if mode == "async" else None)
            if mode == "async":
                flushes = keep_flushes(db.engine, KEPT_FLUSHES)
            db.engine._lock = lock = TimedLock(db.engine._lock)
            model: dict = {}
            mark = len(log)
            t0 = time.perf_counter()
            apply_stream(db, stream, model)
            write_s = time.perf_counter() - t0
            db.wait_idle()
            drain_s = time.perf_counter() - t0 - write_s
            l0 = sst_digests(path)
            span0 = db.stats.compact_device_seconds
            t0 = time.perf_counter()
            drain_ms = drain(db, on_card)
            compact_s = time.perf_counter() - t0
            span_ms = 1e3 * (db.stats.compact_device_seconds - span0)
            after = sst_digests(path)
            rng = np.random.default_rng(seed)
            sample = [keys[i] for i in rng.choice(
                len(keys), min(2000, len(keys)), replace=False)]
            with keep_waves(limit=KEPT_WAVES) as waves:
                checked = check_model(db, model, sample, f"(a) {mode}")
            st = db.stats
            out[mode] = dict(
                write_s=write_s, drain_s=drain_s, compact_s=compact_s,
                flushes=st.flushes, compactions=st.compactions,
                trivial_moves=st.trivial_moves, stalls=st.write_stalls,
                l0_files=len(l0), files=len(after), levels=db.level_sizes(),
                checked=checked, lock_waits=lock.summary(),
                drain_device_ms=drain_ms, drain_span_ms=span_ms,
                drain_jobs=len(jobs),
                workers=launches_by(log[mark:], WORKERS))
            if mode == "async":
                out["behind"] = flush_behind_compaction(
                    db, lock, model, geom=geom, sched=sched,
                    value_size=value_size, keys=keys, first=n, seed=seed)
                check_model(db, model, sample, "(a) after the flush behind "
                            "a compaction")
                out["jobs_seen"] = merges_seen(jobs)
            db.close()
            files[mode] = (l0, after)
            shutil.rmtree(path)
    s, a = out["sync"], out["async"]
    if files["sync"][0] != files["async"][0]:
        raise AssertionError("(a) the async store's L0 files differ from "
                             "the sync store's")
    if files["sync"][1] != files["async"][1]:
        raise AssertionError("(a) after the compaction drain the async "
                             "store's files differ from the sync store's")
    if s["flushes"] != a["flushes"] or a["flushes"] < memtables or \
            a["compactions"] < 1:
        raise AssertionError(f"(a) flushes {s['flushes']} / {a['flushes']}"
                             f", compactions {a['compactions']}")
    t0 = time.perf_counter()
    out["job_checks"] = check_jobs(jobs, geom, dev)
    out["flush_checks"] = check_flushes(flushes, geom, dev)
    out["wave_checks"] = check_waves(waves)
    out["check_s"] = time.perf_counter() - t0
    shutil.rmtree(keep_dir)
    if len(out["flush_checks"]) != KEPT_FLUSHES or \
            {name for name, _ in out["wave_checks"]} != set(WAVE_WRAPPERS):
        raise AssertionError(f"(a) {len(out['flush_checks'])} flushes and "
                             f"{out['wave_checks']} wave calls checked")
    if on_card:
        merge_jobs_line(out["jobs_seen"], "")   # raises unless a launch a level
        idle = [k for k in WRITE_PATH if not a["workers"].get(k)]
        if idle:
            raise AssertionError(f"(a) no launch of {idle} from the async "
                                 f"store's workers: {a['workers']}")
    return out


class WatchedDB(LsmDB):
    """An ``LsmDB`` with ``readers`` threads beside its writer (phase 9 (b),
    (c)): each ``multi_get``s the keys of ``sample`` and ``get``s every
    sixteenth of them, with ``ReadOptions(fill_cache=False)`` so that each
    wave reaches the bloom prune, then rests ``READER_PAUSE`` s, until the
    store closes.  A read must
    return a value the writer issued to that key and none older than the
    last one acknowledged before the read began (``None`` only before the
    first); the store's puts of ``sample`` keys record both.  Each
    compaction job lands in ``jobs`` (``keep_jobs``), with its host
    interval."""

    OPTS = ReadOptions(fill_cache=False)

    def __init__(self, path, cfg, *, device, sample, readers: int, **kw):
        super().__init__(path, cfg, device=device, **kw)
        self.sample = list(sample)
        self.issued = {k: [] for k in self.sample}   # values, put order
        self.acked = {k: 0 for k in self.sample}     # puts that returned
        self.errors: list = []
        self.reads = [0] * readers
        self.jobs = keep_jobs(self.engine)
        self.engine._lock = self.lock = TimedLock(self.engine._lock)
        self._stop = threading.Event()
        self._readers = [threading.Thread(target=self._read_loop, args=(i,),
                                          name=f"reader-{i}", daemon=True)
                         for i in range(readers)]
        for t in self._readers:
            t.start()

    def put(self, key: bytes, value: bytes):
        hist = self.issued.get(key)
        if hist is None:
            return super().put(key, value)
        hist.append(value)
        super().put(key, value)
        self.acked[key] += 1

    def _check(self, key, got, floor: int) -> None:
        ok = floor == 0 if got is None else \
            got in self.issued[key][max(floor - 1, 0):]
        if not ok:
            self.errors.append((key, got, floor))

    def _read_loop(self, i: int) -> None:
        try:
            while not self._stop.is_set():
                floors = [self.acked[k] for k in self.sample]
                got = self.multi_get(self.sample, self.OPTS)
                for k, v, f in zip(self.sample, got, floors):
                    self._check(k, v, f)
                for k in self.sample[i::16]:
                    f = self.acked[k]
                    self._check(k, self.get(k, self.OPTS), f)
                self.reads[i] += len(self.sample) + len(self.sample[i::16])
                self._stop.wait(READER_PAUSE)
        except BaseException as e:   # noqa: BLE001 - raised at close
            self.errors.append(("reader failed", repr(e), -1))

    def close(self):
        self._stop.set()
        for t in self._readers:
            t.join(timeout=60)
        alive = any(t.is_alive() for t in self._readers)
        super().close()
        if alive or self.errors:
            raise AssertionError(f"readers beside the writer: alive {alive},"
                                 f" errors {self.errors[:5]}")


def watched_db(made: list, path, cfg, device=None, *, sample,
               readers: int, **kw) -> WatchedDB:
    """``ycsb.run``'s store as a ``WatchedDB``, kept in ``made`` (``kw``:
    the registry and tracer ``ycsb.run`` passes on)."""
    made.append(WatchedDB(path, cfg, device=device, sample=sample,
                          readers=readers, **kw))
    return made[-1]


def async_ycsb_phase(work: str, dev, *, geometry=PAPER.geometry,
                     sched: SchedulerConfig = PAPER_SCHED,
                     value_size: int = ASYNC_VALUE,
                     memtables: int = PAPER_MEMTABLES,
                     readers: int = READERS, sample: int = READER_SAMPLE
                     ) -> dict:
    """Phase 9 (b) and (c): YCSB-A through ``ycsb.run`` at
    ``geometry(value_size)`` (the LUDA store on ``dev``), ``memtables``
    memtables of records and as many operations (phase 6's sizing), on a
    sync store and on an async one (``ycsb.store_config(async_mode=True)``,
    two flush workers): the same op streams, every read, the full scan and
    a post-drain ``get`` of every key checked by ``ycsb.run``.  In both
    runs ``readers`` reader threads read a fixed sample of the load keys
    (``WatchedDB``); the async run's first ``KEPT_WAVES`` wave calls on
    the reader threads are held against ``ref`` (``check_waves``); on the
    card, ``bloom_multi_probe`` and ``lookup_blocks`` must have launched
    on the readers while the async store's compaction worker ran a job."""
    n = paper_records(geometry(value_size), value_size, memtables)
    spec = PAPER.workload(value_size, records=n, operations=n)
    sample_keys = [key_of(i) for i in range(0, n, max(1, n // sample))]
    on_card = torch.device(dev).type == "cuda"
    rows = {}
    for mode in ("sync", "async"):
        cfg = dataclasses.replace(
            ycsb.store_config(value_size, paper=True,
                              async_mode=mode == "async"),
            geom=geometry(value_size), scheduler=sched)
        made: list[WatchedDB] = []
        make = functools.partial(watched_db, made, sample=sample_keys,
                                 readers=readers)
        path = os.path.join(work, f"ycsb-{mode}")
        with launch_log() as log, mock.patch.object(ycsb, "LsmDB", make), \
                keep_waves(limit=KEPT_WAVES if mode == "async" else 0,
                           threads=("reader-",)) as waves:
            r = ycsb.run(spec, cfg, device=dev, path=path, check_gets=True)
        shutil.rmtree(path)
        db = made[0]
        spans = [j["span"] for j in db.jobs]
        r.update(reads=sum(db.reads), jobs_run=len(spans),
                 lock_waits=db.lock.summary(),
                 reader_launches=launches_by(log, ("reader-",)),
                 during_jobs=launches_by(log, ("reader-",), spans))
        rows[mode] = r
    a = rows["async"]
    a["wave_checks"] = check_waves(waves)
    if {name for name, _ in a["wave_checks"]} != set(WAVE_WRAPPERS):
        raise AssertionError(f"(c) the readers' wave calls checked: "
                             f"{a['wave_checks']}")
    if a["compactions"] < 1 or a["jobs_run"] < 1:
        raise AssertionError("(b) the async store ran no compaction")
    if on_card:
        idle = [k for k in READ_PATH if not a["during_jobs"].get(k)]
        if idle:
            raise AssertionError(f"(c) the readers launched no {idle} "
                                 "while a background compaction ran: "
                                 f"{a['during_jobs']}")
    return rows


def fail_build_of(engine, first_key: np.ndarray, gate: threading.Event
                  ) -> list:
    """Make ``engine.build_image`` raise ``RuntimeError`` once, for the
    memtable whose smallest packed key is ``first_key`` (whichever worker
    builds it), after ``gate`` is set.  Returns the list that receives
    the failing thread's name."""
    real = engine.build_image
    failed: list[str] = []

    def build(keys, meta, vals):
        if not failed and np.array_equal(np.asarray(keys)[0], first_key):
            failed.append(threading.current_thread().name)
            gate.wait(timeout=CAPTURE_WAIT)
            raise RuntimeError("injected build failure (phase 9 d)")
        return real(keys, meta, vals)

    engine.build_image = build
    return failed


def async_halt_phase(work: str, dev, *, geom: SSTGeometry,
                     sched: SchedulerConfig, value_size: int = ASYNC_VALUE,
                     memtables: int = HALT_MEMTABLES) -> dict:
    """Phase 9 (d): an async store (``auto_compact=False``) whose second
    memtable's ``build_image`` raises ``RuntimeError`` (the engine wrapped
    here, not in the package).  Memtable 1 installs, then ``memtables - 1``
    more rotations queue and the build fails; the failure halts the
    pipeline: ``wait_idle()`` raises ``BackgroundError``,
    the queued tables stay readable, no younger table installs
    (``level_sizes()[0]`` stays at the first flush's), and the next
    rotation raises ``BackgroundError`` too.  After ``resume()``,
    ``flush()`` and ``wait_idle()`` every write reads back and the L0
    files equal a sync store's for the same stream."""
    from repro_torch.lsm.faults import BackgroundError
    recs = memtable_records(geom, value_size)
    keys = [key_of(i) for i in range((memtables + 1) * recs)]
    first, rest = keys[:memtables * recs], keys[memtables * recs:]
    doomed = formats.pack_key_bytes(min(keys[recs:2 * recs]),
                                    geom.key_bytes)
    out: dict = {}
    files = {}
    model: dict = {}
    for mode in ("async", "sync"):
        path = os.path.join(work, f"halt-{mode}")
        cfg = async_config(geom, sched, auto_compact=False)
        if mode == "sync":
            cfg = dataclasses.replace(cfg, async_compaction=False)
        db = LsmDB(path, cfg, device=dev)
        queued_all = threading.Event()
        if mode == "async":
            failed = fail_build_of(db.engine, doomed, queued_all)
        for i, k in enumerate(first):
            db.put(k, ycsb_value(i, value_size))
            model[k] = ycsb_value(i, value_size)
            if i == recs - 1:
                # memtable 1 installs before the failure: a failure halts
                # every install after it, an older table's too
                db.wait_idle()
        queued_all.set()
        if mode == "async":
            try:
                db.wait_idle()
            except BackgroundError as e:
                out["wait_idle"] = repr(e)
            else:
                raise AssertionError("(d) wait_idle did not raise the "
                                     "failed build")
            l0 = db.level_sizes()[0]
            queued = len(db.imm)
            check_model(db, model, first, "(d) while halted")
        for i, k in enumerate(rest, len(first)):
            try:
                db.put(k, ycsb_value(i, value_size))
            except BackgroundError as e:
                if mode == "sync" or i != len(keys) - 1:
                    raise
                out["rotation"] = repr(e)
            model[k] = ycsb_value(i, value_size)
        if mode == "async":
            if "rotation" not in out:
                raise AssertionError("(d) the rotation after the failure "
                                     "did not raise")
            if db.level_sizes()[0] != l0 or queued != memtables - 1:
                raise AssertionError(f"(d) while halted: L0 {l0} -> "
                                     f"{db.level_sizes()[0]}, {queued} "
                                     "tables queued")
            out.update(l0_halted=l0, queued=queued, failed_on=failed[0],
                       resumed=db.resume())
        db.flush()
        db.wait_idle()
        out[f"{mode}_checked"] = check_model(db, model, keys,
                                             f"(d) {mode}")
        out[f"{mode}_levels"] = db.level_sizes()
        db.close()
        files[mode] = sst_digests(path)
        shutil.rmtree(path)
    if files["async"] != files["sync"] or not files["sync"]:
        raise AssertionError("(d) after resume() the L0 files differ from "
                             "the sync store's")
    out["files"] = len(files["sync"])
    return out


def async_sharded_phase(work: str, dev, *, geom: SSTGeometry,
                        sched: SchedulerConfig,
                        value_size: int = ASYNC_VALUE, shards: int = SHARDS,
                        memtables: int = SHARD_MEMTABLES,
                        mix_ops: int = ASYNC_SHARD_OPS,
                        sample: int = ASYNC_SHARD_SAMPLE, seed: int = 42
                        ) -> dict:
    """Phase 9 (e): ``ShardedDB`` of ``shards`` async shards
    (``async_compaction=True``, two flush workers a shard, one queue):
    ``memtables`` full memtables a shard through ``put`` while the queue
    compacts, then ``mix_ops`` of YCSB-A (zipfian 0.99), every read
    checked; after ``wait_idle()`` every acknowledged write read back by a
    scan across the shards and a sample by ``get`` and ``multi_get``
    (``read_back``), and again after close and reopen."""
    from repro_torch.lsm.sharded import ShardedDB, boundaries_from_sample
    per_shard = memtables * memtable_records(geom, value_size)
    cuts = boundaries_from_sample(
        [key_of(i) for i in range(shards * per_shard)], shards)
    ids = shard_keys(cuts, shards, per_shard)
    cfg = DBConfig(geom=geom, scheduler=sched, async_compaction=True,
                   flush_workers=2)
    path = os.path.join(work, "async-sharded")
    model: dict[bytes, int] = {}
    updated: dict[bytes, bytes] = {}
    db = ShardedDB(path, cfg, shards=shards, boundaries=cuts, device=dev)
    t0 = time.perf_counter()
    for i in sorted(i for s in ids for i in s):
        k = key_of(i)
        db.put(k, ycsb_value(i, value_size))
        model[k] = i
    load_s = time.perf_counter() - t0
    spec = WorkloadSpec.ycsb_a(records=max(model.values()) + 1,
                               operations=mix_ops, value_size=value_size,
                               seed=seed)
    t0 = time.perf_counter()
    reads = 0
    for kind, k, v in YCSBWorkload(spec).run_ops():
        if kind == "read":
            want = updated.get(k)
            if want is None and k in model:
                want = ycsb_value(model[k], value_size)
            if db.get(k) != want:
                raise AssertionError(f"(e) a YCSB read of {k!r} disagrees")
            reads += 1
        else:
            db.put(k, v)
            updated[k] = v
    mix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.wait_idle()
    drain_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    loaded = list(model)
    keys = list(updated) + [loaded[i] for i in rng.choice(
        len(loaded), min(sample, len(loaded)), replace=False)] + \
        [b"absent%010d" % i for i in range(200)]
    rows = read_back(db, model, updated, keys, value_size,
                     "(e) before reopen")
    counts = store_counts(db)
    levels = db.level_sizes()
    db.close()
    db = ShardedDB(path, cfg, device=dev)
    if read_back(db, model, updated, keys, value_size,
                 "(e) after reopen") != rows:
        raise AssertionError("(e) the reopened store scans other rows")
    db.close()
    shutil.rmtree(path)
    st = counts["stats"]
    if st.flushes < shards * memtables or st.compactions < 1:
        raise AssertionError(f"(e) {st.flushes} flushes, {st.compactions} "
                             "compactions")
    return dict(per_shard=per_shard, load_s=load_s, mix_s=mix_s,
                drain_s=drain_s, reads=reads, updates=mix_ops - reads,
                scan_rows=rows, checked=len(keys), counts=counts,
                levels=levels)


def capture_beside_flush(eng, prompts, work: str, *,
                         nbytes: int = 4 * 1024 * 1024, seed: int = 7,
                         batch: int = CAPTURE_BATCH, max_new: int = SERVE_NEW,
                         db_cfg: DBConfig | None = None) -> dict:
    """Phase 9 (f): a seeded ``nbytes`` served state (as phase 7's
    cross-device check pages it) saved into an async store on the
    engine's device: the save's rotation hands a flush to a worker.
    Before the store's ``wait_idle()``, ``generate`` serves ``batch``
    requests, a batch size not yet captured, so its first decode step
    captures a CUDA graph; on the card the flush's build is held until
    the capture begins, and the capture is held open until the build has
    run (both here, not in the package), so the worker's allocations,
    copies and kernels run inside the capture.  The tokens must equal an
    uninterrupted eager run's (prefill, then ``model.decode_step``) and
    the state must load back bit for bit after ``wait_idle()``."""
    dev = eng.device
    on_card = dev.type == "cuda"
    p = prompts[:batch]
    if batch in eng._graphs:
        raise AssertionError(f"(f) batch {batch} is captured already")
    # the uninterrupted run: eager decode, the store not yet open
    logit, cache, pos = lm.prefill(eng.params, {"tokens": p}, eng.cfg,
                                   eng.max_len)
    tok = logit.argmax(-1)[:, None].to(torch.int32)
    eager = []
    for i in range(max_new):
        eager.append(tok[:, 0])
        if i + 1 == max_new:
            break
        logits, cache = lm.decode_step(eng.params, cache, tok, pos, eng.cfg)
        tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
        pos = pos + 1
    eager = torch.stack(eager, 1).cpu().numpy()
    del cache, logit

    host = synthetic_state(np.random.default_rng(seed), nbytes)
    cfg = dataclasses.replace(db_cfg or session_config(),
                              async_compaction=True, flush_workers=2)
    path = os.path.join(work, "capture-async")
    db = LsmDB(path, cfg, device=dev)
    started, built = threading.Event(), threading.Event()
    times: dict[str, float] = {}
    real = db.engine.build_image

    def build(*a, **kw):
        if on_card and not started.wait(timeout=CAPTURE_WAIT):
            raise AssertionError("(f) the capture never began")
        times["build0"] = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            times["build1"] = time.perf_counter()
            built.set()

    class Graph(torch.cuda.graph):
        """The engine's capture, held open until the flush has built."""

        def __enter__(self):
            super().__enter__()
            times["capture0"] = time.perf_counter()
            started.set()

        def __exit__(self, *exc):
            built.wait(timeout=CAPTURE_WAIT)
            times["capture1"] = time.perf_counter()
            return super().__exit__(*exc)

    db.engine.build_image = build
    try:
        store = LsmSessionStore(db, host)
        state = tree_map(lambda a: a.to(dev), host)
        records = store.save("synthetic", state)
        queued = len(db.imm)
        with mock.patch.object(torch.cuda, "graph", Graph):
            tokens = eng.generate(p, max_new)[0]
        db.wait_idle()
        check_state(store.load("synthetic"), state,
                    "(f) the state saved beside the capture")
        st = db.stats
    finally:
        db.close()
        shutil.rmtree(path)
    if not np.array_equal(tokens, eager):
        raise AssertionError("(f) the tokens of the decode captured beside "
                             "a flush differ from the eager run's")
    if queued < 1 or st.flushes < 1:
        raise AssertionError(f"(f) the save queued {queued} memtables")
    inside = None
    if on_card:
        if batch not in eng._graphs:
            raise AssertionError(f"(f) no graph captured for batch {batch}")
        inside = times["capture0"] <= times["build0"] and \
            times["build1"] <= times["capture1"]
        if not inside:
            raise AssertionError(f"(f) the flush's build did not run inside "
                                 f"the capture: {times}")
    return dict(records=records, bytes=state_bytes(host), queued=queued,
                flushes=st.flushes, compactions=st.compactions,
                tokens=tokens, inside=inside,
                build_s=times.get("build1", 0.0) - times.get("build0", 0.0),
                capture_s=(times["capture1"] - times["capture0"]
                           if "capture1" in times else None))


def async_part_lines(part: str, r: dict, card: str) -> list[str]:
    """The phase-9 report of part ``part`` (``"a"``, ``"b"``, ``"d"``,
    ``"e"``, ``"f"``; (c) reports with (b)), with its seconds."""
    took = f" ({r['seconds']:.1f} s)"
    if part == "a":
        s_, a = r["sync"], r["async"]
        lines = [
            f"[9] (a) {r['ops']} seeded puts and deletes, sync against "
            f"async (flush_workers={ASYNC_FLUSH_WORKERS}, "
            f"max_pending_memtables={ASYNC_PENDING}, auto_compact=False): "
            f"{a['flushes']} flushes, {a['l0_files']} L0 files "
            f"byte-identical; after maybe_compact() + wait_idle() "
            f"{a['files']} files byte-identical ({a['compactions']} "
            f"compactions, levels {a['levels']}); writes sync "
            f"{s_['write_s']:.2f} s / async {a['write_s']:.2f} s (+ drain "
            f"{a['drain_s']:.2f} s, {a['stalls']} write stalls); launches "
            f"from the async store's workers {a['workers']}; the engine "
            f"lock's waits (entries, total ms, longest ms) "
            f"{a['lock_waits']} [{card}]" + took]
        drains = []
        for mode in ("sync", "async"):
            m = r[mode]
            ms = m["drain_device_ms"]
            drains.append(
                f"{mode} {m['drain_jobs']} jobs, device time "
                + ("not measured" if ms is None else f"{ms:.4f} ms (CUPTI)")
                + f", CUDA-event spans {m['drain_span_ms']:.4f} ms")
        bh = r["behind"]
        lines += [
            f"[9] (a) the compaction drain alone on the card: "
            + "; ".join(drains) + f" [{card}]",
            f"[9] (a) a flush queued behind a running compaction "
            f"({bh['l0']} L0 files, {bh['puts']} puts of overwrites): it "
            f"waited {bh['wait_ms']:.3f} ms at the engine lock; the job "
            f"ran {bh['job_ms']:.3f} ms inside the lock (host clock) "
            f"[{card}]",
            f"[9] (a) on the plain versions on the same inputs: the async "
            f"store's jobs (inputs, merge launches, live rows) "
            f"{r['job_checks']} byte-identical, its first flushes "
            f"(entries) {r['flush_checks']} byte-identical; its read-back's "
            f"wave calls (wrapper, shape) {r['wave_checks']} bit-identical "
            f"({r['check_s']:.1f} s)"]
        if any(n for _, n, _ in r["jobs_seen"]):
            lines.append(merge_jobs_line(r["jobs_seen"], card, phase=9))
        return lines
    if part == "b":
        lines = []
        for mode in ("sync", "async"):
            m = r[mode]
            p50, p99, p999 = m["latency_us"]["put"]
            dev_s, span_s = m["compact_device_s"], m["compact_span_s"]
            lines.append(
                f"[9] (b) YCSB-A {mode:<5} v={m['value_size']} "
                f"{m['records']} records + {m['operations']} ops: load "
                f"{m['load_ops_s']:,.0f} ops/s, run {m['run_ops_s']:,.0f} "
                f"ops/s; put p50 {p50:.1f} / p99 {p99:.1f} / p99.9 "
                f"{p999:.1f} / max {m['put_max_us']:.1f} us (host clock); "
                f"{m['write_stalls']} write stalls; {m['flushes']} "
                f"flushes, {m['compactions']} compactions, "
                f"compact_device_s "
                + ("not measured" if dev_s is None else f"{dev_s:.4f}")
                + ("" if span_s is None or dev_s is not None else
                   f" (the jobs' CUDA-event spans {span_s:.4f} s hold the "
                   f"readers' waves and the worker's waits)")
                + f"; drain {m['drain_s']:.2f} s; the engine lock's waits "
                f"{m['lock_waits']} [{card}]")
        ratio = r["async"]["latency_us"]["put"][1] / \
            r["sync"]["latency_us"]["put"][1]
        lines.append(
            f"[9] (b) async / sync p99 put {ratio:.3f} (a timing, not a "
            f"gate); in both modes the {r['async']['scan_rows']}-row scan "
            f"and a get of each key after the drain equal the acknowledged "
            f"writes" + took)
        for mode in ("sync", "async"):
            m = r[mode]
            lines.append(
                f"[9] (c) {mode}: {READERS} readers read {m['reads']} keys "
                f"beside the writer, every value issued and none stale; "
                f"their launches {m['reader_launches']}, of them inside "
                f"the {m['jobs_run']} compaction jobs {m['during_jobs']}"
                + ("" if mode == "sync" else
                   f"; their first wave calls (wrapper, shape) "
                   f"{m['wave_checks']} bit-identical to the plain "
                   f"versions"))
        return lines
    if part == "d":
        return [
            f"[9] (d) halt: the build of memtable 2 raised on "
            f"{r['failed_on']}; wait_idle raised {r['wait_idle'][:90]}...; "
            f"{r['queued']} tables queued and readable, L0 held at "
            f"{r['l0_halted']}; the next rotation raised too; resume() -> "
            f"{r['resumed']}; {r['async_checked']} keys read back, "
            f"{r['files']} L0 files equal the sync store's" + took]
    if part == "e":
        return [
            f"[9] (e) async ShardedDB ({SHARDS} shards, {r['per_shard']} "
            f"records a shard): load {r['load_s']:.1f} s while the queue "
            f"compacted, YCSB-A {r['reads']} reads (each checked) and "
            f"{r['updates']} updates in {r['mix_s']:.1f} s, drain "
            f"{r['drain_s']:.2f} s; {r['scan_rows']}-row scan and "
            f"{r['checked']} keys by get and multi_get agree before and "
            f"after reopen; levels {r['levels']} [{card}]" + took,
            counts_line("(e) the async shards", r["counts"]).replace(
                "[8]", "[9]")]
    capture = ("no capture on the CPU" if r["inside"] is None else
               f"build {r['build_s'] * 1e3:.1f} ms inside the capture, "
               f"which was held {r['capture_s']:.2f} s")
    return [
        f"[9] (f) a {r['bytes']:,} B state ({r['records']} records) saved "
        f"into an async store, {r['queued']} memtable queued; decode of "
        f"{CAPTURE_BATCH} requests captured while its flush built "
        f"({capture}); tokens equal the eager run's; the state loads back "
        f"bit for bit ({r['flushes']} flushes, {r['compactions']} "
        f"compactions)" + took]


def async_lines(p9: dict, card: str) -> str:
    """The phase-9 report."""
    return "\n".join(ln for part in "abdef"
                     for ln in async_part_lines(part, p9[part], card))


def async_phase(work: str, dev, eng, prompts, *, geom=ASYNC_GEOM,
                sched=PAPER_SCHED, geometry=PAPER.geometry,
                memtables=PAPER_MEMTABLES, session_cfg=None, report=None,
                **sharded_kw) -> dict:
    """Phase 9: (a)-(f) on ``dev``, the launch counts set to 0 just before
    and read just after; each part's result (with its ``seconds``) is
    passed to ``report(part, result)`` as it comes.  (``geom``,
    ``geometry``, ``memtables``, ``session_cfg`` and ``sharded_kw`` scale
    it down for a rehearsal.)"""
    parts = {
        "a": lambda: async_files_phase(work, dev, geom=geom, sched=sched),
        "b": lambda: async_ycsb_phase(work, dev, geometry=geometry,
                                      sched=sched, memtables=memtables),
        "d": lambda: async_halt_phase(work, dev, geom=geom, sched=sched),
        "e": lambda: async_sharded_phase(work, dev, geom=geom, sched=sched,
                                         **sharded_kw),
        "f": lambda: capture_beside_flush(eng, prompts, work,
                                          db_cfg=session_cfg)}
    ops.reset_launch_counts()
    out = {}
    for part, run in parts.items():
        t0 = time.perf_counter()
        out[part] = run()
        out[part]["seconds"] = time.perf_counter() - t0
        if report is not None:
            report(part, out[part])
    out["launches"] = ops.launch_counts()
    return out


# ---------------------------------------------------------------------------
# phase 10: the crash-consistency matrix and the fault paths on the card

FAULT_N = 600              # (a), (b): operations a matrix cell (its own n)
FAULT_OPS = 600            # (c)-(f): puts of the fault workload
SABOTAGE = (("sync", "compact.install"), ("async", "compact.install"),
            ("sharded", "compact.round"))
KEPT_FAULT_FLUSHES = 2     # (g): flushes a store rebuilt on the plain versions
FAULT_WAIT = 120.0         # seconds a barrier or a parked build may take


def fault_config(**kw) -> DBConfig:
    """The crash matrix's store (``crashmatrix._open_store``): the LUDA
    engine at the default geometry (the paper's 16 B keys, 256 B values and
    4 KB blocks), 640 B memtables, every write synced."""
    return DBConfig(engine="device", sync_writes=True, memtable_bytes=640,
                    **kw)


def fault_writes(db, n: int, model: dict, *, shards: bool = False) -> None:
    """``n`` puts of ``n`` keys in the matrix's coprime stride (so that
    successive memtables overlap and compactions merge); with ``shards``,
    the keys alternate between ``k0..`` and ``k{n/2}..``, so the two shards
    of a ``[k{n/2}]`` boundary get the same shapes (values are of one
    width)."""
    for i in range(n):
        j = (i * 7919) % n
        if shards:
            j = (i // 2 * 7919) % (n // 2) + (i % 2) * (n // 2)
        k, v = b"k%05d" % j, b"v%05d.%05d" % (j, i)
        db.put(k, v)
        model[k] = v


def tree_digests(path: str) -> dict[str, str]:
    """``sst_digests`` of ``path`` and of each directory below it."""
    out = {}
    for root, _, _ in sorted(os.walk(path)):
        rel = os.path.relpath(root, path)
        out.update({f"{rel}/{n}": d for n, d in sst_digests(root).items()})
    return out


@contextlib.contextmanager
def no_cpu_engine():
    """Fail if anything builds the numpy ``CpuCompactionEngine`` inside
    (the port has no fallback to it)."""
    def refuse(self, *a, **kw):
        raise AssertionError("a CpuCompactionEngine was built")
    with mock.patch.object(CpuCompactionEngine, "__init__", refuse):
        yield


def waves_of_both(waves: list, what: str) -> list:
    """Fail unless ``waves`` (``check_waves``' record) holds a call of each
    read-wave wrapper; returns it."""
    if {name for name, _ in waves} != set(WAVE_WRAPPERS):
        raise AssertionError(f"{what}: the read-back's wave calls held "
                             f"against the plain versions: {waves}")
    return waves


def fault_matrix(work: str, dev, *, n: int = FAULT_N) -> dict:
    """Phase 10 (a) and (b): every cell of the crash matrix
    (``repro_torch.testing.crashmatrix.run_matrix``) on the LUDA store on
    ``dev``, each recovered store's ``multi_get`` of every acknowledged
    key held against its ``get`` loop; then sabotage, one cell a mode,
    which must fail.  Each recovered store's first ``KEPT_WAVES`` wave
    calls, and every batched kernel call of the matrix, are held against
    their plain versions on the same inputs.  Every engine the matrix
    builds keeps its compaction jobs and first flushes for (g), and must
    end with no launch retry."""
    from repro_torch.testing import crashmatrix
    engines, jobs, rounds, flushes = [], [], [], []
    real_init = TorchCompactionEngine.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        engines.append(self)
        keep = os.path.join(work, f"keep-{len(engines)}")
        os.makedirs(keep)
        jobs.append(keep_jobs(self, keep))
        rounds.append(keep_batches(self, keep))
        flushes.append(keep_flushes(self, KEPT_FAULT_FLUSHES))

    checked, waves = [], []

    def verify(db, acked):
        keys = sorted(acked)
        with keep_waves(limit=KEPT_WAVES) as calls:
            got = db.multi_get(keys)
        if got != [db.get(k) for k in keys]:
            raise AssertionError("multi_get disagrees with the get loop")
        waves.extend(check_waves(calls))
        checked.append(len(keys))

    out: dict = {}
    before = ops.launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(TorchCompactionEngine, "__init__", init), \
            keep_batch_calls() as batched:
        cells = crashmatrix.run_matrix(device=dev, n=n, verbose=False,
                                       verify=verify,
                                       workdir=os.path.join(work, "matrix"))
        os.rmdir(os.path.join(work, "matrix"))   # every cell cleaned up
        out["matrix_s"] = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        bad = [r.line() for r in cells if not (r.crashed and r.ok)]
        if bad:
            raise AssertionError("(a) crash matrix cells failed:\n" +
                                 "\n".join(bad))
        if len(checked) != len(cells):
            raise AssertionError(f"(a) {len(checked)} of {len(cells)} "
                                 "recovered stores checked by multi_get")
        retries = [e.launch_retries for e in engines]
        if any(retries):
            raise AssertionError(f"(a) launch retries {retries} with no "
                                 "engine failpoint armed")
        out.update(
            cells=len(cells), engines=len(engines), checked=sum(checked),
            launched=launched, batched=check_batch_calls(batched),
            waves=waves_of_both(waves, "(a)"),
            by_mode={m: [(r.point, r.acked, r.seconds) for r in cells
                         if r.mode == m] for m in crashmatrix.MODES})
        t0 = time.perf_counter()
        sabotage = []
        for mode, point in SABOTAGE:
            cell = os.path.join(work, f"sabotage-{mode}")
            r = crashmatrix.run_cell(point, mode, n=n, sabotage=True,
                                     workdir=cell, device=dev)
            shutil.rmtree(cell)
            if not r.crashed or r.ok:
                raise AssertionError(f"(b) sabotaged {mode} {point} "
                                     "passed: the checks check nothing")
            sabotage.append((mode, point, len(r.errors)))
        out.update(sabotage=sabotage, sabotage_s=time.perf_counter() - t0)
    out["jobs"] = [j for kept in jobs for j in kept] + \
        [j for kept in rounds for rnd in kept for j in rnd["jobs"]]
    out["flushes"] = [f for kept in flushes for f in kept]
    return out


def engine_retry(work: str, dev, *, n: int = FAULT_OPS) -> dict:
    """Phase 10 (c): ``engine.launch=raise:x1`` on a sync store: exactly
    one ``launch_retries`` and the clean store's SST files; then
    ``engine.crc=raise:x1`` on a stacked round of a 2-shard store (the
    batched kernels launch, the verdict's failpoint fires): the round's
    jobs run again one by one, one ``launch_retries``, the clean sharded
    store's files.  Each round's batched kernel calls, and each store's
    first read-back wave calls, are held against their plain versions on
    the same inputs."""
    from repro_torch.lsm import faults
    from repro_torch.lsm.sharded import ShardedDB
    out: dict = {}
    files: dict = {}
    waves: list = []
    for name, spec in (("clean", None), ("fault", "engine.launch=raise:x1")):
        path = os.path.join(work, f"retry-{name}")
        db = LsmDB(path, fault_config(failpoints=spec), device=dev)
        model: dict = {}
        try:
            with no_cpu_engine():
                fault_writes(db, n, model)
                db.flush()
            out[f"{name}_retries"] = db.engine.launch_retries
            out[f"{name}_compactions"] = db.stats.compactions
            check_model(db, model, sorted(model), f"(c) {name}", waves)
        finally:
            faults.FAILPOINTS.clear()
        db.close()
        files[name] = sst_digests(path)
        shutil.rmtree(path)
    if out["fault_retries"] != 1 or out["clean_retries"] != 0 or \
            files["fault"] != files["clean"] or not out["clean_compactions"]:
        raise AssertionError(f"(c) the transient launch fault: {out}, "
                             "files equal: "
                             f"{files['fault'] == files['clean']}")
    out["files"] = len(files["clean"])
    for name, spec in (("clean", None), ("fault", "engine.crc=raise:x1")):
        path = os.path.join(work, f"round-{name}")
        db = ShardedDB(path, fault_config(auto_compact=False,
                                          failpoints=spec),
                       boundaries=[b"k%05d" % (n // 2)], device=dev)
        model = {}
        try:
            fault_writes(db, n, model, shards=True)
            db.flush()
            with no_cpu_engine(), keep_batch_calls() as calls, \
                    one_round_per_notify():
                db.maybe_compact()
            if not calls:
                raise AssertionError(f"(c) the {name} round made no "
                                     "batched kernel call")
            out[f"round_{name}"] = dict(
                retries=db.engine.launch_retries,
                stacked=db.engine.batch_launches,
                batched_calls=check_batch_calls(calls),
                batched_compactions=db.stats.batched_compactions,
                compactions=db.stats.compactions)
            check_model(db, model, sorted(model), f"(c) round {name}",
                        waves)
        finally:
            faults.FAILPOINTS.clear()
        db.close()
        files[name] = tree_digests(path)
        shutil.rmtree(path)
    rc, rf = out["round_clean"], out["round_fault"]
    if rc["stacked"] < 1 or rc["retries"] or rf["retries"] != 1 or \
            not rf["batched_calls"] or rf["batched_compactions"] or \
            files["fault"] != files["clean"]:
        raise AssertionError(f"(c) the stacked round's fault: {rc}, {rf}, "
                             "files equal: "
                             f"{files['fault'] == files['clean']}")
    out["round_files"] = len(files["clean"])
    out["waves"] = waves_of_both(waves, "(c)")
    return out


def engine_raises(work: str, dev, *, n: int = FAULT_OPS) -> dict:
    """Phase 10 (d): ``engine.launch=raise`` (every launch fails).  On a
    sync store ``compact_once()`` raises ``FaultInjected`` after the job
    and its one retry, with the level files unchanged and no
    ``CpuCompactionEngine`` built.  On an async store the compaction
    worker retries the job ``bg_max_retries`` times, each with the
    engine's retry, then halts with a transient ``BackgroundError``; after
    ``clear()`` and ``resume()`` its files are the clean store's (the
    clean store retries no launch).  The read-backs' first wave calls are
    held against their plain versions."""
    from repro_torch.lsm import faults
    out: dict = {}
    waves: list = []
    point = "engine.launch"
    db = LsmDB(os.path.join(work, "raise-sync"),
               fault_config(auto_compact=False), device=dev)
    model: dict = {}
    fault_writes(db, n, model)
    levels, files = db.level_sizes(), sst_digests(db.path)
    fired = faults.FAILPOINTS.fired(point)
    try:
        with no_cpu_engine(), faults.FAILPOINTS.active(f"{point}=raise"):
            db.compact_once()
    except faults.FaultInjected as e:
        out["sync_raised"] = repr(e)
    else:
        raise AssertionError("(d) compact_once() did not raise")
    out["sync_fired"] = faults.FAILPOINTS.fired(point) - fired
    if out["sync_fired"] != 2 or db.engine.launch_retries != 1 or \
            db.level_sizes() != levels or sst_digests(db.path) != files:
        raise AssertionError(f"(d) sync: {out}, retries "
                             f"{db.engine.launch_retries}, levels "
                             f"{levels} -> {db.level_sizes()}")
    out["sync_levels"] = levels
    if not db.compact_once():
        raise AssertionError("(d) no job after the fault was cleared")
    check_model(db, model, sorted(model), "(d) sync", waves)
    db.close()
    shutil.rmtree(db.path)
    files = {}
    for name in ("clean", "fault"):
        path = os.path.join(work, f"raise-async-{name}")
        db = LsmDB(path, fault_config(async_compaction=True,
                                      auto_compact=False), device=dev)
        model = {}
        fault_writes(db, n, model)
        db.flush()
        db.wait_idle(timeout=FAULT_WAIT)
        if name == "fault":
            fired = faults.FAILPOINTS.fired(point)
            faults.FAILPOINTS.install(f"{point}=raise")
            try:
                with no_cpu_engine():
                    db.maybe_compact()
                    db.wait_idle(timeout=FAULT_WAIT)
            except faults.BackgroundError as e:
                out["async_error"] = (e.severity, repr(e.cause))
            else:
                raise AssertionError("(d) the async store did not halt")
            finally:
                faults.FAILPOINTS.clear()
            out["async_fired"] = faults.FAILPOINTS.fired(point) - fired
            out["async_bg_retries"] = db.stats.bg_retries
            out["async_launch_retries"] = db.engine.launch_retries
            out["resumed"] = db.resume()
            want = (db.cfg.bg_max_retries + 1) * 2
            if out["async_error"][0] != "transient" or \
                    out["async_fired"] != want or \
                    out["async_bg_retries"] != db.cfg.bg_max_retries:
                raise AssertionError(f"(d) async: {out}, want {want} fires")
        db.maybe_compact()
        db.wait_idle(timeout=FAULT_WAIT)
        check_model(db, model, sorted(model), f"(d) async {name}", waves)
        out[f"async_{name}_compactions"] = db.stats.compactions
        out[f"async_{name}_launch_retries"] = db.engine.launch_retries
        db.close()
        files[name] = sst_digests(path)
        shutil.rmtree(path)
    if files["fault"] != files["clean"] or not files["clean"]:
        raise AssertionError("(d) after resume() the files differ from the "
                             "clean store's")
    if out["async_clean_launch_retries"]:
        raise AssertionError(f"(d) the clean async store: {out}")
    out["async_files"] = len(files["clean"])
    out["waves"] = waves_of_both(waves, "(d)")
    return out


def flush_retry(work: str, dev, *, n: int = FAULT_OPS) -> dict:
    """Phase 10 (e): ``flush.build=raise:x2`` on an async store: the flush
    worker retries, ``bg_retries == 2``, and the SST files are a sync
    store's for the same writes; neither store retries a launch.  The
    read-backs' first wave calls are held against their plain
    versions."""
    from repro_torch.lsm import faults
    out: dict = {}
    files = {}
    waves: list = []
    for mode in ("sync", "async"):
        path = os.path.join(work, f"flush-{mode}")
        cfg = fault_config(auto_compact=False,
                           async_compaction=mode == "async",
                           failpoints="flush.build=raise:x2"
                           if mode == "async" else None)
        db = LsmDB(path, cfg, device=dev)
        model: dict = {}
        try:
            fault_writes(db, n, model)
            db.flush()
            db.wait_idle(timeout=FAULT_WAIT)
        finally:
            faults.FAILPOINTS.clear()
        out[f"{mode}_retries"] = db.stats.bg_retries
        out[f"{mode}_flushes"] = db.stats.flushes
        out[f"{mode}_launch_retries"] = db.engine.launch_retries
        check_model(db, model, sorted(model), f"(e) {mode}", waves)
        db.close()
        files[mode] = sst_digests(path)
        shutil.rmtree(path)
    if out["async_retries"] != 2 or files["async"] != files["sync"] or \
            not files["sync"] or out["sync_launch_retries"] or \
            out["async_launch_retries"]:
        raise AssertionError(f"(e) {out}, files equal "
                             f"{files['async'] == files['sync']}")
    out["files"] = len(files["sync"])
    out["waves"] = waves_of_both(waves, "(e)")
    return out


def shed_writes(work: str, dev, *, n: int = FAULT_OPS) -> dict:
    """Phase 10 (f): an async store (``max_pending_memtables=1``) whose one
    flush is parked: ``WriteOptions(wait_stall=False)`` raises ``IOError``
    at the next rotation instead of stalling, and after the drain every
    acknowledged write (the one that met the full queue too) reads back by
    ``multi_get`` and ``get``, whose first wave calls are held against
    their plain versions; no launch is retried."""
    from repro_torch.lsm import WriteOptions
    path = os.path.join(work, "shed")
    db = LsmDB(path, fault_config(async_compaction=True, auto_compact=False,
                                  max_pending_memtables=1), device=dev)
    gate = threading.Event()
    real = db.engine.build_image

    def parked(*a):
        gate.wait(FAULT_WAIT)
        return real(*a)

    db.engine.build_image = parked
    model: dict = {}
    shed = None
    try:
        for i in range(n):
            k, v = b"k%05d" % ((i * 7919) % n), b"v%05d" % i
            try:
                db.put(k, v, WriteOptions(wait_stall=False))
            except IOError as e:
                shed = (i, str(e))
                model[k] = v   # in the WAL and the memtable before the raise
                break
            model[k] = v
    finally:
        gate.set()
    if shed is None or "wait_stall" not in shed[1]:
        raise AssertionError(f"(f) no write was shed: {shed}")
    db.wait_idle(timeout=FAULT_WAIT)
    db.flush()
    db.wait_idle(timeout=FAULT_WAIT)
    waves: list = []
    out = dict(shed_at=shed[0], stalls=db.stats.write_stalls,
               checked=check_model(db, model, sorted(model), "(f)", waves),
               launch_retries=db.engine.launch_retries)
    db.close()
    shutil.rmtree(path)
    if out["stalls"] or out["launch_retries"]:
        raise AssertionError(f"(f) {out}")
    out["waves"] = waves_of_both(waves, "(f)")
    return out


def fault_phase(work: str, dev, *, n: int = FAULT_N, ops_n: int = FAULT_OPS,
                report=None) -> dict:
    """Phase 10: (a)-(f) on ``dev``, the launch counts set to 0 just before
    and read just after; then (g), the kept jobs and flushes of (a) rebuilt
    on the plain versions.  Each part's result (with its ``seconds``) is
    passed to ``report(part, result)`` as it comes.  (``n`` and ``ops_n``
    scale it down for a rehearsal.)"""
    parts = {
        "a": lambda: fault_matrix(work, dev, n=n),
        "c": lambda: engine_retry(work, dev, n=ops_n),
        "d": lambda: engine_raises(work, dev, n=ops_n),
        "e": lambda: flush_retry(work, dev, n=ops_n),
        "f": lambda: shed_writes(work, dev, n=ops_n)}
    ops.reset_launch_counts()
    out: dict = {}
    for part, run in parts.items():
        t0 = time.perf_counter()
        out[part] = run()
        out[part]["seconds"] = time.perf_counter() - t0
        if report is not None:
            report(part, out[part])
    out["launches"] = ops.launch_counts()
    t0 = time.perf_counter()
    geom = SSTGeometry()
    out["g"] = dict(jobs=check_jobs(out["a"].pop("jobs"), geom, dev),
                    flushes=check_flushes(out["a"].pop("flushes"), geom,
                                          dev))
    out["g"]["seconds"] = time.perf_counter() - t0
    if report is not None:
        report("g", out["g"])
    return out


def fault_part_lines(part: str, r: dict, card: str) -> list[str]:
    """The phase-10 report of part ``part`` (``"a"``, ``"c"``-``"g"``; (b)
    reports with (a)), with its seconds."""
    took = f" ({r['seconds']:.1f} s)"
    held = ""
    if "waves" in r:
        held = (f"; {len(r['waves'])} read-back wave calls (wrapper, shape) "
                f"{sorted(set(r['waves']))} bit-identical to the plain "
                f"versions")
    if part == "a":
        lines = [
            f"[10] (a) the crash matrix on the LUDA store: {r['cells']} "
            f"cells crashed at their failpoint and passed (durability, "
            f"batch atomicity, integrity, liveness) in "
            f"{r['matrix_s']:.1f} s; {r['engines']} engines, no launch "
            f"retry; multi_get of {r['checked']} acknowledged keys equal "
            f"to the get loop in every recovered store{held}; launches "
            f"{r['launched']}; {len(r['batched'])} batched calls, each "
            f"bit-identical to its plain batched version [{card}]"]
        for mode, cells in r["by_mode"].items():
            secs = [s for _, _, s in cells]
            lines.append(
                f"[10] (a) {mode}: {len(cells)} cells, "
                f"{sum(secs) / len(secs):.2f} s a cell (min {min(secs):.2f}, "
                f"max {max(secs):.2f}); acked "
                + ", ".join(f"{p} {a}" for p, a, _ in cells))
        lines.append(
            f"[10] (b) sabotage failed as it must in every mode: "
            + ", ".join(f"{m} {p} ({e} errors)" for m, p, e in r["sabotage"])
            + f" ({r['sabotage_s']:.1f} s)" + took)
        return lines
    if part == "c":
        rf = r["round_fault"]
        return [
            f"[10] (c) engine.launch=raise:x1 on a sync store: "
            f"launch_retries {r['fault_retries']}, {r['fault_compactions']} "
            f"compactions, {r['files']} SST files byte-identical to the "
            f"clean store's",
            f"[10] (c) engine.crc=raise:x1 on a stacked round of 2 shards: "
            f"the batched calls (wrapper, shape, launches) "
            f"{rf['batched_calls']} ran, bit-identical to the plain batched "
            f"versions (the clean round's {r['round_clean']['batched_calls']}"
            f" too), the round's jobs ran again one by one (launch_retries "
            f"{rf['retries']}, batched_compactions "
            f"{rf['batched_compactions']} of {rf['compactions']}); "
            f"{r['round_files']} SST files byte-identical to the clean "
            f"stacked round's{held}" + took]
    if part == "d":
        return [
            f"[10] (d) engine.launch=raise: sync compact_once() raised "
            f"{r['sync_raised']} after {r['sync_fired']} launches, levels "
            f"{r['sync_levels']} unchanged, no CpuCompactionEngine; async: "
            f"{r['async_error'][0]} BackgroundError after "
            f"{r['async_bg_retries']} store retries ({r['async_fired']} "
            f"fires, launch_retries {r['async_launch_retries']}); resume() "
            f"-> {r['resumed']}, {r['async_files']} SST files equal the "
            f"clean store's{held}" + took]
    if part == "e":
        return [
            f"[10] (e) flush.build=raise:x2 on an async store: bg_retries "
            f"{r['async_retries']}, {r['async_flushes']} flushes; "
            f"{r['files']} SST files byte-identical to the sync store's, no "
            f"launch retry{held}" + took]
    if part == "f":
        return [
            f"[10] (f) WriteOptions(wait_stall=False) shed put "
            f"{r['shed_at']} with IOError at the full queue, "
            f"{r['stalls']} stalls, no launch retry; {r['checked']} "
            f"acknowledged keys read back after the drain{held}" + took]
    jobs, flushes = r["jobs"], r["flushes"]
    return [
        f"[10] (g) on the plain versions on the same inputs: (a)'s "
        f"{len(jobs)} compaction jobs ({min(j[0] for j in jobs)}-"
        f"{max(j[0] for j in jobs)} inputs, merge launches "
        f"{sorted({j[1] for j in jobs})}, {sum(j[2] for j in jobs)} live "
        f"rows) and {len(flushes)} first flushes ({sum(flushes)} entries) "
        f"rebuilt byte-identical" + took]


# ---------------------------------------------------------------------------
# phase 11: metrics and tracing on the card

OBS_VALUE = 256
OBS_GEOM = PAPER.geometry(OBS_VALUE)
OBS_COST_MEMTABLES = 1   # the cost of tracing: puts of (a)'s first
#   memtable into a traced and an untraced store, twice each way
OBS_ASYNC_MEMTABLES = 4  # (b): memtables of puts into the async store
OBS_SHARDS = 2           # (c)
OBS_SHARD_MEMTABLES = 4  # (c): full memtables a shard before the round
OBS_NEW = 4              # (d): new tokens of the one request served
OBS_JOB_RUNS = 3         # the L0->L1 job traced and untraced, each this often
LAUNCH_SPANS = ("compact.execute", "compact.batch_launch")
# a child phase against the CUPTI trace of its job: CUDA events and CUPTI
# timestamps are two clocks, so each comparison allows 1 % and this much
CUPTI_SLACK_MS = 0.005


def check_nesting(events) -> int:
    """Spans on one thread nest (the check of JAX's
    ``tests/test_obs.py::_check_nesting``): raise at the first span that
    straddles another.  Returns the spans checked."""
    per_tid: dict = {}
    for e in events:
        if e.get("ph") == "X":
            per_tid.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
    if not per_tid:
        raise AssertionError("the trace has no spans")
    for tid, spans in per_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for t0, t1, name in spans:
            # 1 ns of slack: timestamps are ns over 1,000 as floats
            while stack and t0 >= stack[-1][1] - 1e-3:
                stack.pop()
            if stack and t1 > stack[-1][1] + 1e-3:
                raise AssertionError(
                    f"thread {tid}: {name} [{t0}, {t1}) straddles "
                    f"{stack[-1][2]} [{stack[-1][0]}, {stack[-1][1]})")
            stack.append((t0, t1, name))
    return sum(len(s) for s in per_tid.values())


def check_launches(events, clock: str, what: str) -> dict:
    """Each launch span (``LAUNCH_SPANS``) must be followed, on its
    thread, by its three child phases (``PHASE_SPANS``, in order) with
    ``"clock": clock``, starting at its start and summing to at most its
    wall.  Returns the launches, the most jobs one took, the children's
    measured seconds (each duration over its ``scale``), the walls'
    seconds, and how many were scaled or on a shared stream."""
    xs = [e for e in events if e.get("ph") == "X"]
    out = dict(launches=0, max_jobs=0, children_s=0.0, wall_s=0.0,
               scaled=0, shared=0, clock=clock)
    for i, e in enumerate(xs):
        if e["name"] not in LAUNCH_SPANS:
            continue
        kids = list(itertools.islice(
            (k for k in itertools.islice(xs, i + 1, None)
             if k["tid"] == e["tid"]), 3))
        if [k["name"] for k in kids] != list(PHASE_SPANS):
            raise AssertionError(f"{what}: {e['name']} is followed by "
                                 f"{[k['name'] for k in kids]}")
        args = [k.get("args") or {} for k in kids]
        if any(a.get("clock") != clock for a in args):
            raise AssertionError(f"{what}: child clocks {args}, not {clock}")
        if abs(kids[0]["ts"] - e["ts"]) > 1e-3 or \
                sum(k["dur"] for k in kids) > e["dur"] + 1e-3:
            raise AssertionError(f"{what}: the children of {e['name']} "
                                 f"({[(k['ts'], k['dur']) for k in kids]}) "
                                 f"leave it ({e['ts']}, {e['dur']})")
        out["launches"] += 1
        out["max_jobs"] = max(out["max_jobs"], e["args"]["jobs"])
        out["children_s"] += sum(k["dur"] / a.get("scale", 1.0)
                                 for k, a in zip(kids, args)) / 1e6
        out["wall_s"] += e["dur"] / 1e6
        out["scaled"] += "scale" in args[0]
        out["shared"] += args[0].get("stream") == "shared"
    return out


def check_counters(reg, stats: dict, what: str, **labels) -> int:
    """Every ``lsm.<field>`` counter of ``reg`` (with ``labels``) equals
    the field of ``stats`` (a ``DBStats`` as a dict).  Returns the
    fields checked."""
    for name, want in stats.items():
        got = reg.counter(f"lsm.{name}", **labels).value
        if got != want:
            raise AssertionError(f"{what}: counter lsm.{name}{labels} "
                                 f"{got} != DBStats {want}")
    return len(stats)


def check_hist_counts(reg, stats: dict, what: str, **labels) -> dict:
    """``lsm.op.latency_us{op}`` counts against their ``DBStats`` fields."""
    counts = {op: reg.find("lsm.op.latency_us", op=op, **labels).count
              for op in ("put", "get", "multi_get", "write_batch")}
    want = {"put": stats["puts"], "get": stats["gets"],
            "multi_get": stats["multi_gets"],
            "write_batch": stats["write_batches"]}
    if counts != want:
        raise AssertionError(f"{what}: histogram counts {counts}, DBStats "
                             f"{want}")
    return counts


def stall_culprits(rows: list, stalls: int, what: str) -> list:
    """The report's stall rows: every ``write_stall`` counted, each with
    a culprit (a background span, or ``none-active``)."""
    if sum(r["count"] for r in rows) != stalls or \
            not all(r["culprit"] for r in rows):
        raise AssertionError(f"{what}: {stalls} stalls, report rows {rows}")
    return [(r["cause"], r["culprit"], r["count"]) for r in rows]


def report_cli(path: str) -> dict:
    """``python -m repro_torch.obs.report <path> --json`` in a child
    process: it must exit 0; returns its report."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                        path, "--json"], env=env, capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"obs.report exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return json.loads(r.stdout)


def obs_sync(work: str, dev, *, geom: SSTGeometry, sched: SchedulerConfig,
             value_size: int, memtables: int) -> dict:
    """(a): YCSB-A through ``ycsb.run`` as phase 6 sizes it at
    ``value_size`` (``memtables`` memtables of records and as many
    operations) on a synchronous LUDA store with a ``MetricsRegistry``
    and a ``Tracer``; its compaction jobs and first flushes kept
    (``keep_jobs``, ``keep_flushes``) for the plain versions.  Checks: the
    counters equal ``DBStats``, the put histogram's count the puts, the
    launcher's ``ycsb.op.latency_us{op=put}`` p99 the exact p99 within
    2**0.5, the spans nest, each launch span holds its three child
    phases, whose measured sum equals ``compact_device_seconds`` within
    1 % on the card.  The store runs on one thread, so on the card no
    child may be scaled down to fit its launch span's host wall (CUDA
    events that overran it would be) or say its stream was shared."""
    from repro_torch.obs import MetricsRegistry, Tracer
    on_card = torch.device(dev).type == "cuda"
    n = paper_records(geom, value_size, memtables)
    spec = PAPER.workload(value_size, records=n, operations=n)
    cfg = dataclasses.replace(ycsb.store_config(value_size, paper=True),
                              geom=geom, scheduler=sched)
    reg, tr = MetricsRegistry(), Tracer()
    made: list = []
    keep_dir = os.path.join(work, "obs-jobs")

    def make(path, cfg, device=None, **kw):
        db = LsmDB(path, cfg, device=device, **kw)
        made.append(dict(jobs=keep_jobs(db.engine, keep_dir),
                         flushes=keep_flushes(db.engine, KEPT_FLUSHES)))
        return db

    path = os.path.join(work, "obs-sync")
    with mock.patch.object(ycsb, "LsmDB", make):
        r = ycsb.run(spec, cfg, device=dev, path=path, metrics=reg,
                     tracer=tr)
    shutil.rmtree(path)
    st = r["db_stats"]
    out = dict(row=r, kept=made[0], spec=spec, cfg=cfg)
    out["counters"] = check_counters(reg, st, "(a)")
    out["hists"] = check_hist_counts(reg, st, "(a)")
    est, exact, ok = ycsb.check_histogram_p99(reg, r["latency_us"]["put"][1],
                                              "put")
    if not ok:
        raise AssertionError(f"(a) the put histogram's p99 {est} us is not "
                             f"within 2**0.5 of the exact {exact} us")
    out["p99_check"] = (est, exact)
    events = tr.to_chrome()["traceEvents"]
    out["spans"] = check_nesting(events)
    out["launch"] = check_launches(events, "cuda_event" if on_card
                                   else "host", "(a)")
    if out["launch"]["launches"] != st["compactions"]:
        raise AssertionError(f"(a) {out['launch']['launches']} launch spans "
                             f"for {st['compactions']} compactions")
    if out["launch"]["scaled"] or out["launch"]["shared"]:
        raise AssertionError(f"(a) a sync store's launch children were "
                             f"scaled or shared: {out['launch']}")
    if on_card and abs(out["launch"]["children_s"] -
                       st["compact_device_seconds"]) > \
            0.01 * st["compact_device_seconds"]:
        raise AssertionError(
            f"(a) the child phases sum to {out['launch']['children_s']} s, "
            f"compact_device_seconds is {st['compact_device_seconds']} s")
    out["device_s"] = st["compact_device_seconds"]
    out["names"] = collections.Counter(e["name"] for e in events
                                       if e["ph"] == "X")
    out["events"] = len(events)
    return out


def obs_async(work: str, dev, *, geom: SSTGeometry, sched: SchedulerConfig,
              value_size: int, memtables: int = OBS_ASYNC_MEMTABLES,
              readers: int = READERS) -> dict:
    """(b): ``memtables`` memtables of YCSB records into an async store
    (``flush_workers=3``, the background compaction worker) with a
    registry and a tracer, while ``readers`` reader threads ``multi_get``
    and ``get`` acknowledged keys (``fill_cache=False``, so that waves
    reach the bloom prune).  Checks: every value read is the one written;
    the readers' ``get`` / ``multi_get`` counts (bumped outside the
    store's lock) are exact; the counters equal ``DBStats`` and the
    histograms' counts their fields; spans nest on every thread; each
    launch span holds its child phases; the exported trace goes through
    ``python -m repro_torch.obs.report``, which gives every
    ``write_stall`` a culprit; the readers' first wave calls are held
    against the plain versions.  How many launches say ``"stream":
    "shared"`` depends on whether a reader's wave fell inside them; it is
    reported."""
    from repro_torch.obs import MetricsRegistry, Tracer
    on_card = torch.device(dev).type == "cuda"
    reg, tr = MetricsRegistry(), Tracer()
    db = LsmDB(os.path.join(work, "obs-async"),
               async_config(geom, sched, metrics=reg, tracer=tr), device=dev)
    n = memtables * memtable_records(geom, value_size)
    writes = [(key_of(i), ycsb_value(i, value_size)) for i in range(n)]
    acked = [0]
    counts = [[0, 0, 0] for _ in range(readers)]   # gets, multi_gets, keys
    errors: list = []
    stop = threading.Event()
    opts = ReadOptions(fill_cache=False)

    def read_loop(i: int) -> None:
        rng = np.random.default_rng(i)
        try:
            while not stop.is_set():
                hi = acked[0]
                if hi < 64:
                    stop.wait(0.002)
                    continue
                idx = rng.integers(0, hi, 32)
                got = db.multi_get([writes[j][0] for j in idx], opts)
                counts[i][1] += 1
                counts[i][2] += len(idx)
                for j in idx[:4]:
                    got.append(db.get(writes[j][0], opts))
                    counts[i][0] += 1
                want = [writes[j][1] for j in idx] + \
                    [writes[j][1] for j in idx[:4]]
                if got != want:
                    errors.append(("stale or wrong value", i))
                stop.wait(READER_PAUSE)
        except BaseException as e:   # noqa: BLE001 - raised below
            errors.append(("reader failed", repr(e)))

    threads = [threading.Thread(target=read_loop, args=(i,),
                                name=f"reader-{i}", daemon=True)
               for i in range(readers)]
    t0 = time.perf_counter()
    with keep_waves(limit=KEPT_WAVES, threads=("reader-",)) as calls:
        for t in threads:
            t.start()
        for j, (k, v) in enumerate(writes):
            db.put(k, v)
            acked[0] = j + 1
        db.wait_idle(timeout=FAULT_WAIT)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    write_s = time.perf_counter() - t0
    st = dataclasses.asdict(db.stats)
    db.close()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"(b) readers: {errors[:5]}")
    out = dict(puts=n, write_s=write_s, stats=st)
    gets, mgets, keys = (sum(c[i] for c in counts) for i in range(3))
    if (st["puts"], st["gets"], st["multi_gets"], st["multi_get_keys"]) != \
            (n, gets, mgets, keys):
        raise AssertionError(f"(b) counts puts/gets/multi_gets/keys "
                             f"{st['puts'], st['gets'], st['multi_gets']}"
                             f"{st['multi_get_keys']} != {n, gets, mgets}"
                             f"{keys}")
    out.update(gets=gets, multi_gets=mgets, keys=keys)
    out["counters"] = check_counters(reg, st, "(b)")
    out["hists"] = check_hist_counts(reg, st, "(b)")
    events = tr.to_chrome()["traceEvents"]
    out["spans"] = check_nesting(events)
    out["threads"] = len({e["tid"] for e in events if e["ph"] == "X"})
    out["launch"] = check_launches(events, "cuda_event" if on_card
                                   else "host", "(b)")
    if st["compactions"] < 1 or out["launch"]["launches"] < 1:
        raise AssertionError("(b) the async store ran no compaction")
    t0 = time.perf_counter()
    trace_path = os.path.join(work, "obs-async-trace.json")
    tr.export(trace_path)
    out["export_s"] = time.perf_counter() - t0
    out["trace_bytes"] = os.path.getsize(trace_path)
    t0 = time.perf_counter()
    rep = report_cli(trace_path)
    out["report_s"] = time.perf_counter() - t0
    os.remove(trace_path)
    out["stalls"] = stall_culprits(rep["stalls"], st["write_stalls"], "(b)")
    out["events"] = rep["n_events"]
    out["names"] = collections.Counter(e["name"] for e in events
                                       if e["ph"] == "X")
    out["waves"] = check_waves(calls)
    if {name for name, _ in out["waves"]} != set(WAVE_WRAPPERS):
        raise AssertionError(f"(b) the readers' wave calls checked: "
                             f"{out['waves']}")
    return out


def obs_sharded(work: str, dev, *, geom: SSTGeometry, sched: SchedulerConfig,
                value_size: int, shards: int = OBS_SHARDS,
                memtables: int = OBS_SHARD_MEMTABLES) -> dict:
    """(c): a ``ShardedDB`` of ``shards`` shards with one registry and one
    tracer, ``memtables`` full memtables of puts a shard (a flush each,
    as in phase 8), then one ``maybe_compact()`` whose round stacks the
    shards' L0->L1 jobs into one launch.  Checks: a
    ``compact.batch_launch`` of ``jobs >= 2`` with its child phases; each
    shard's counters equal its ``DBStats``; the merged per-shard put
    histograms equal the shards' buckets summed; the batched kernel calls
    bit-identical to the plain batched versions; a read-back by
    ``multi_get``."""
    from repro_torch.lsm.sharded import ShardedDB, boundaries_from_sample
    from repro_torch.obs import MetricsRegistry, Tracer, merge_histograms
    on_card = torch.device(dev).type == "cuda"
    reg, tr = MetricsRegistry(), Tracer()
    per = memtables * memtable_records(geom, value_size)
    cuts = boundaries_from_sample(
        [key_of(i) for i in range(4 * shards * per)], shards)
    ids = shard_keys(cuts, shards, per)
    db = ShardedDB(os.path.join(work, "obs-sharded"), DBConfig(
        geom=geom, scheduler=sched, auto_compact=False, metrics=reg,
        tracer=tr), shards=shards, boundaries=cuts, device=dev)
    t0 = time.perf_counter()
    for s in range(shards):
        for i in ids[s]:
            db.put(key_of(i), ycsb_value(i, value_size))
    load_s = time.perf_counter() - t0
    with keep_batch_calls() as calls, one_round_per_notify():
        db.maybe_compact()
    sample = [i for s in range(shards) for i in ids[s][::max(1, per // 500)]]
    got = db.multi_get([key_of(i) for i in sample])
    if got != [ycsb_value(i, value_size) for i in sample]:
        raise AssertionError("(c) multi_get disagrees with the writes")
    shard_stats = [dataclasses.asdict(s) for s in db.shard_stats()]
    total = dataclasses.asdict(db.stats)
    batch = (db.engine.batch_launches, db.engine.max_batch_jobs)
    db.close()
    out = dict(load_s=load_s, stats=total, batch=batch, read=len(sample))
    out["counters"] = sum(check_counters(reg, st, f"(c) shard {i}",
                                         shard=str(i))
                          for i, st in enumerate(shard_stats))
    hists = [reg.find("lsm.op.latency_us", op="put", shard=str(i))
             for i in range(shards)]
    merged = merge_histograms(hists)
    summed: collections.Counter = collections.Counter()
    for h in hists:
        summed.update(h.snapshot()[0])
    if merged.snapshot()[0] != dict(summed) or not total["puts"] \
            or merged.count != total["puts"]:
        raise AssertionError("(c) the merged per-shard put histograms "
                             "differ from the shards' sums")
    out["hist"] = (merged.count, [h.count for h in hists],
                   merged.percentile(99.0))
    events = tr.to_chrome()["traceEvents"]
    out["spans"] = check_nesting(events)
    out["launch"] = check_launches(events, "cuda_event" if on_card
                                   else "host", "(c)")
    if out["launch"]["max_jobs"] < 2 or batch[0] < 1:
        raise AssertionError(f"(c) no stacked launch: {out['launch']}, "
                             f"engine {batch}")
    out["rounds"] = [e["args"] for e in events
                     if e["ph"] == "X" and e["name"] == "compact.round"]
    out["batched"] = check_batch_calls(calls)
    if not out["batched"]:
        raise AssertionError("(c) the stacked round made no batched call")
    return out


@contextlib.contextmanager
def capture_windows():
    """Record each CUDA graph capture made inside: the capturing thread
    and the host interval of its ``torch.cuda.graph`` block."""
    wins: list = []
    real = torch.cuda.graph

    @contextlib.contextmanager
    def timed(*a, **kw):
        t0 = time.perf_counter_ns()
        with real(*a, **kw) as g:
            yield g
        wins.append((threading.get_ident(), t0, time.perf_counter_ns()))

    with mock.patch.object(torch.cuda, "graph", timed):
        yield wins


def obs_serve(eng, prompts, work: str, *, max_new: int = OBS_NEW,
              db_cfg: DBConfig | None = None) -> dict:
    """(d): a ``ServeEngine`` (phase 5's params, no copy) over a new page
    store at phase 7's session geometry with a registry and a tracer,
    which the engine takes as its own: one ``generate`` of one request
    (its decode batch size captured anew), ``save_session`` and
    ``load_session``.  Checks: the state loads back bit for bit; one
    ``serve.generate`` / ``serve.page_out`` / ``serve.page_in`` span and
    histogram count each; no event of the capturing thread begins inside
    a capture, and no ``serve.*`` span lies inside one; the prefill's
    first ``selective_scan`` call (at this request's shape) and the
    load's wave calls held against the plain versions."""
    from repro_torch.obs import MetricsRegistry, Tracer
    dev = eng.device
    reg, tr = MetricsRegistry(), Tracer()
    db = LsmDB(os.path.join(work, "obs-pages"), db_cfg or session_config(),
               device=dev, metrics=reg, tracer=tr)
    p = prompts[:1]
    seng = ServeEngine(eng.cfg, eng.params, max_len=p.shape[1] + max_new,
                       device=dev, page_store=db)
    if seng.metrics is not reg or seng.tracer is not tr:
        raise AssertionError("(d) the engine did not take the store's "
                             "registry and tracer")
    t0 = time.perf_counter()
    with capture_windows() as wins, keep_waves(
            limit=1, names=("selective_scan",), clone=True) as scans:
        _, cache, pos = seng.generate(p, max_new)
    gen_s = time.perf_counter() - t0
    scan = check_scan_calls(scans)
    del scans
    if dev.type == "cuda" and [c[0][:2] for c in scan] != [tuple(p.shape)]:
        raise AssertionError(f"(d) the prefill's scan calls checked: {scan}")
    t0 = time.perf_counter()
    records = seng.save_session(SESSION_NAME, cache, pos)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with keep_waves(limit=KEPT_WAVES) as calls:
        loaded = seng.load_session(SESSION_NAME)
    load_s = time.perf_counter() - t0
    check_state(loaded, (cache, pos), "(d) load_session")
    waves = check_waves(calls)
    del calls
    db.close()
    raw = list(tr._events)
    serve = [(name, ts, dur, tid) for ph, name, ts, dur, tid, _ in raw
             if ph == "X" and name.startswith("serve.")]
    names = sorted(name for name, _, _, _ in serve)
    if names != ["serve.generate", "serve.page_in", "serve.page_out"]:
        raise AssertionError(f"(d) serve spans {names}")
    hists = {op: reg.find("serve.op.latency_us", op=op).count
             for op in ("generate", "page_out", "page_in")}
    if hists != {"generate": 1, "page_out": 1, "page_in": 1}:
        raise AssertionError(f"(d) serve histograms {hists}")
    if dev.type == "cuda" and not wins:
        raise AssertionError("(d) the generate captured no decode step")
    for ident, c0, c1 in wins:
        inside = [name for _, name, ts, _, tid, _ in raw
                  if tid == ident and c0 <= ts < c1]
        inside += [name for name, ts, dur, _ in serve
                   if c0 <= ts and ts + dur <= c1]
        if inside:
            raise AssertionError(f"(d) recorded inside a capture: {inside}")
    if {name for name, _ in waves} != set(WAVE_WRAPPERS):
        raise AssertionError(f"(d) the load's wave calls checked: {waves}")
    return dict(bytes=state_bytes((cache, pos)), records=records,
                gen_s=gen_s, save_s=save_s, load_s=load_s, hists=hists,
                scan=scan,
                captures=[(c1 - c0) / 1e6 for _, c0, c1 in wins],
                serve=[(name, dur / 1e6) for name, _, dur, _ in serve],
                waves=waves, events=len(raw))


def hold_children_on_cupti(engine, paths, attempts: int = 3) -> dict:
    """One traced job of ``engine`` (``compact_paths(paths)``) under the
    profiler (``trace_timeline``), its three child phases held against the
    CUPTI trace of the same call.  The job's device events run in order
    on one stream, so each phase's span must cover the extent (first
    start to last end) of the hand-written kernels launched in it: phase
    1's before the first ``merge_runs`` kernel, phase 2's ``merge_runs``
    kernels, phase 3's after the last; and the three together must lie
    within the extent of all the call's device events, which begin with
    the staging copies before the pipeline's first event and end with the
    read-back after its last.  Each comparison allows 1 % and
    ``CUPTI_SLACK_MS``.  Returns the children's and the extents' ms."""
    events = []
    for _ in range(attempts):
        events = sorted(trace_timeline(lambda: engine.compact_paths(paths)))
        if events:
            break
    if not events:
        raise RuntimeError(f"the profiler recorded no device time after its "
                           f"marker in {attempts} traces")
    xs = [e for e in engine.tracer.to_chrome()["traceEvents"]
          if e["ph"] == "X"][-4:]
    if [e["name"] for e in xs] != ["compact.execute", *PHASE_SPANS] or \
            any("scale" in e["args"] for e in xs[1:]):
        raise AssertionError(f"(e) the traced job's spans: {xs}")
    child_ms = [e["dur"] / 1e3 for e in xs[1:]]
    hand = [(t, kind, ms) for t, name, ms in events
            if (kind := event_kind(name)) not in (COPIES, PYTORCH)]
    merges = [i for i, (_, kind, _) in enumerate(hand)
              if kind == "merge_runs"]
    if not merges or any(k != "merge_runs" for _, k, _ in
                         hand[merges[0]:merges[-1] + 1]):
        raise AssertionError(f"(e) the job's hand-written kernels in order: "
                             f"{[k for _, k, _ in hand]}")

    def extent_ms(evs) -> float:
        if not evs:
            return 0.0
        return (max(t + ms * 1e3 for t, _, ms in evs) -
                min(t for t, _, _ in evs)) / 1e3

    parts = (hand[:merges[0]], hand[merges[0]:merges[-1] + 1],
             hand[merges[-1] + 1:])
    if not (parts[0] and parts[2]):
        raise AssertionError(f"(e) no hand-written kernel before or after "
                             f"the merge: {[k for _, k, _ in hand]}")
    kernels_ms = [extent_ms(p) for p in parts]
    call_ms = extent_ms(events)
    for name, got, least in zip(PHASE_SPANS, child_ms, kernels_ms):
        if got < least * 0.99 - CUPTI_SLACK_MS:
            raise AssertionError(
                f"(e) {name} spans {got:.4f} ms, less than the "
                f"{least:.4f} ms of its kernels in the CUPTI trace")
    if sum(child_ms) > call_ms * 1.01 + CUPTI_SLACK_MS:
        raise AssertionError(
            f"(e) the children sum to {sum(child_ms):.4f} ms, more than the "
            f"{call_ms:.4f} ms the job's device events span in the CUPTI "
            f"trace")
    return dict(children_ms=child_ms, kernels_ms=kernels_ms,
                call_ms=call_ms)


def timed_puts(db, stream) -> list[int]:
    lat = []
    clock = time.perf_counter_ns
    for k, v in stream:
        t0 = clock()
        db.put(k, v)
        lat.append(clock() - t0)
    return lat


def obs_cost(work: str, dev, a: dict, *, geom: SSTGeometry,
             value_size: int, memtables: int = OBS_COST_MEMTABLES,
             job_runs: int = OBS_JOB_RUNS) -> dict:
    """The cost of tracing.  Puts: the first ``memtables`` memtables of
    (a)'s load stream into a store with a registry and a tracer and into
    one with ``NULL_REGISTRY`` / ``NULL_TRACER``, alternated twice; p50
    and p99 a side.  One job: (a)'s first L0->L1 job through an engine
    with a tracer and one without, alternated ``job_runs`` times after a
    warm-up call each: device seconds (CUDA events), host wall, and the
    CUDA events made a call, which must be equal (tracing adds none).  On
    the card, one more traced call's child phases are held against the
    CUPTI trace of that call (``hold_children_on_cupti``)."""
    from repro_torch.obs import (NULL_REGISTRY, NULL_TRACER,
                                 MetricsRegistry, Tracer)
    n = memtables * memtable_records(geom, value_size)
    stream = [(k, v) for _, k, v in itertools.islice(
        YCSBWorkload(a["spec"]).load_ops(), n)]
    lat: dict[str, list[int]] = {"untraced": [], "traced": []}
    for rnd in range(2):
        for side in ("untraced", "traced"):
            obs = (dict(metrics=MetricsRegistry(), tracer=Tracer())
                   if side == "traced" else
                   dict(metrics=NULL_REGISTRY, tracer=NULL_TRACER))
            path = os.path.join(work, f"obs-cost-{side}-{rnd}")
            db = LsmDB(path, dataclasses.replace(a["cfg"], **obs),
                       device=dev)
            lat[side] += timed_puts(db, stream)
            db.close()
            shutil.rmtree(path)
    puts = {side: (float(np.percentile(v, 50)) / 1e3,
                   float(np.percentile(v, 99)) / 1e3)
            for side, v in lat.items()}

    job = next(j for j in a["kept"]["jobs"] if j["n"] >= 4)
    made = []
    real_event = torch.cuda.Event

    def counted(*args, **kw):
        made.append(1)
        return real_event(*args, **kw)

    engines = {"untraced": TorchCompactionEngine(geom, device=dev),
               "traced": TorchCompactionEngine(geom, device=dev,
                                               tracer=Tracer())}
    runs: dict[str, list] = {side: [] for side in engines}
    try:
        for side, e in engines.items():
            e.compact_paths(job["paths"])   # warm: staging buffers
        for _ in range(job_runs):
            for side, e in engines.items():
                del made[:]
                t0 = time.perf_counter()
                with mock.patch.object(torch.cuda, "Event", counted):
                    _, es = e.compact_paths(job["paths"])
                runs[side].append((es.device_seconds,
                                   time.perf_counter() - t0, len(made)))
        cupti = (hold_children_on_cupti(engines["traced"], job["paths"])
                 if torch.device(dev).type == "cuda" else None)
    finally:
        for e in engines.values():
            e.close()
    events = {side: sorted({r[2] for r in v}) for side, v in runs.items()}
    if events["traced"] != events["untraced"]:
        raise AssertionError(f"tracing changed the CUDA events a job "
                             f"records: {events}")
    job_out = {side: (statistics.median(r[0] for r in v),
                      statistics.median(r[1] for r in v))
               for side, v in runs.items()}
    return dict(puts=puts, n=n, job=job_out, job_inputs=job["n"],
                events=events["traced"], runs=job_runs, cupti=cupti)


def obs_phase(work: str, dev, eng, prompts, *, geom=OBS_GEOM,
              sched=PAPER_SCHED, value_size: int = OBS_VALUE,
              memtables: int = PAPER_MEMTABLES, session_cfg=None,
              report=None) -> dict:
    """Phase 11: (a)-(d) on ``dev`` with the launch counts set to 0 just
    before and read just after; then the kernels of (a)'s compaction jobs
    and first flushes rebuilt on the plain versions (``check_jobs``,
    ``check_flushes``; (b), (c) and (d) held their read-wave and batched
    calls as they ran), and (e) the cost of tracing.  Each part's result
    (with its ``seconds``) goes to ``report(part, result)`` as it comes.
    (``geom``, ``memtables`` and ``session_cfg`` scale it down for a
    rehearsal.)"""
    kw = dict(geom=geom, sched=sched, value_size=value_size)
    parts = {
        "a": lambda: obs_sync(work, dev, memtables=memtables, **kw),
        "b": lambda: obs_async(work, dev, **kw),
        "c": lambda: obs_sharded(work, dev, **kw),
        "d": lambda: obs_serve(eng, prompts, work, db_cfg=session_cfg)}
    ops.reset_launch_counts()
    out = {}
    for part, run in parts.items():
        t0 = time.perf_counter()
        out[part] = run()
        out[part]["seconds"] = time.perf_counter() - t0
        if report is not None:
            report(part, out[part])
    out["launches"] = ops.launch_counts()
    t0 = time.perf_counter()
    kept = out["a"]["kept"]
    out["held"] = dict(jobs=check_jobs(kept["jobs"], geom, dev),
                       flushes=check_flushes(kept["flushes"], geom, dev),
                       seconds=time.perf_counter() - t0)
    if report is not None:
        report("held", out["held"])
    t0 = time.perf_counter()
    out["e"] = obs_cost(work, dev, out["a"], geom=geom,
                        value_size=value_size)
    out["e"]["seconds"] = time.perf_counter() - t0
    if report is not None:
        report("e", out["e"])
    return out


def obs_part_lines(part: str, r: dict, card: str) -> list[str]:
    """The report lines of one part of phase 11."""
    took = f" ({r['seconds']:.1f} s)"
    if part == "a":
        row = r["row"]
        p50, p99, p999 = row["latency_us"]["put"]
        la = r["launch"]
        return [
            f"[11] (a) YCSB-A v={row['value_size']} {row['records']} records "
            f"+ {row['operations']} ops on a sync store with a registry and "
            f"a tracer: load {row['load_ops_s']:,.0f} ops/s, run "
            f"{row['run_ops_s']:,.0f} ops/s; put p50 {p50:.1f} / p99 "
            f"{p99:.1f} / p99.9 {p999:.1f} us (host clock); {r['counters']} "
            f"lsm.* counters equal DBStats, histogram counts {r['hists']}; "
            f"ycsb.op.latency_us{{op=put}} p99 {r['p99_check'][0]:.1f} us vs "
            f"exact {r['p99_check'][1]:.1f} us [{card}]" + took,
            f"[11] (a) {r['spans']} spans nest ({dict(r['names'])}); "
            f"{la['launches']} launch spans, each with its 3 child phases "
            f"inside it (clock {la['clock']}, {la['scaled']} scaled): "
            f"children {la['children_s'] * 1e3:.4f} ms vs "
            f"compact_device_seconds {r['device_s'] * 1e3:.4f} ms, launch "
            f"walls {la['wall_s'] * 1e3:.4f} ms; {r['events']} events "
            f"[{card}]"]
    if part == "b":
        la = r["launch"]
        return [
            f"[11] (b) async store (flush_workers={ASYNC_FLUSH_WORKERS}): "
            f"{r['puts']} puts in {r['write_s']:.2f} s beside {READERS} "
            f"readers ({r['gets']} gets, {r['multi_gets']} multi_gets of "
            f"{r['keys']} keys, counted exactly); {r['stats']['flushes']} "
            f"flushes, {r['stats']['compactions']} compactions, "
            f"{r['stats']['write_stalls']} write stalls {r['stalls']}; "
            f"{r['counters']} counters equal DBStats; {r['spans']} spans "
            f"nest on {r['threads']} threads; {la['launches']} launch spans "
            f"with their child phases ({la['shared']} on a shared stream); "
            f"trace of {r['events']} events, {r['trace_bytes']:,} B, "
            f"exported in {r['export_s']:.2f} s; obs.report exit 0 in "
            f"{r['report_s']:.2f} s; the readers' wave calls {r['waves']} "
            f"bit-identical to the plain versions [{card}]" + took]
    if part == "c":
        la = r["launch"]
        return [
            f"[11] (c) ShardedDB of {OBS_SHARDS} shards, one registry and "
            f"tracer: load {r['load_s']:.1f} s; rounds {r['rounds']}; "
            f"engine batch_launches {r['batch'][0]}, max_batch_jobs "
            f"{r['batch'][1]}; {la['launches']} launch spans (most jobs "
            f"{la['max_jobs']}) with their child phases; {r['counters']} "
            f"per-shard counters equal the shards' DBStats; merged put "
            f"histogram {r['hist'][0]} = {r['hist'][1]}, p99 "
            f"{r['hist'][2]:.1f} us; batched calls {r['batched']} "
            f"bit-identical; {r['read']} keys read back [{card}]" + took]
    if part == "d":
        return [
            f"[11] (d) ServeEngine over a page store with the store's "
            f"registry and tracer: generate {r['gen_s'] * 1e3:.1f} ms "
            f"(captures {[round(c, 3) for c in r['captures']]} ms, nothing "
            f"recorded inside), save_session {r['bytes']:,} B as "
            f"{r['records']} records {r['save_s']:.3f} s, load_session "
            f"{r['load_s']:.3f} s, bit for bit; spans "
            f"{[(n, round(d, 3)) for n, d in r['serve']]} ms; histogram "
            f"counts {r['hists']}; the prefill's first selective_scan "
            f"(u shape, max abs err y, h_last) {r['scan']} within "
            f"{SCAN_TOL} of the plain scan; wave calls {r['waves']} "
            f"bit-identical [{card}]" + took]
    if part == "held":
        return [
            f"[11] (a)'s jobs (inputs, merge launches, live rows) "
            f"{r['jobs']} and first flushes (entries) {r['flushes']} "
            f"rebuilt byte-identical on the plain versions "
            f"({r['seconds']:.1f} s)"]
    (un50, un99), (tr50, tr99) = r["puts"]["untraced"], r["puts"]["traced"]
    (ud, uw), (td, tw) = r["job"]["untraced"], r["job"]["traced"]
    return [
        f"[11] (e) the cost of tracing, put ({r['n']} puts of (a)'s load "
        f"stream, twice each way): untraced p50 {un50:.2f} / p99 "
        f"{un99:.2f} us, with a registry and a tracer p50 {tr50:.2f} / p99 "
        f"{tr99:.2f} us (host clock) [{card}]",
        f"[11] (e) one L0->L1 job ({r['job_inputs']} inputs, median of "
        f"{r['runs']}): untraced device {ud * 1e3:.4f} ms / host wall "
        f"{uw * 1e3:.2f} ms, traced device {td * 1e3:.4f} ms / host wall "
        f"{tw * 1e3:.2f} ms; CUDA events a call {r['events']} either way "
        f"[{card}]" + took] + ([] if r["cupti"] is None else [
            f"[11] (e) one traced job against its CUPTI trace: children "
            f"{[round(x, 4) for x in r['cupti']['children_ms']]} ms cover "
            f"their hand-written kernels' extents "
            f"{[round(x, 4) for x in r['cupti']['kernels_ms']]} ms and sum "
            f"to at most the call's device extent "
            f"{r['cupti']['call_ms']:.4f} ms (1 % + {CUPTI_SLACK_MS} ms) "
            f"[{card}]"])


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 12: the attention, MoE and encoder-decoder archs on the card
# ---------------------------------------------------------------------------

GEMMA, GRANITE_MOE = "gemma3-4b", "granite-moe-3b-a800m"
WHISPER, JAMBA = "whisper-medium", "jamba-1.5-large-398b"
# (a): the ring wrap: a prompt inside a windowed layer's 1,024 slots, then
# teacher-forced decode steps past them, each held against ``forward``
RING_PROMPT, RING_STEPS = 1_000, 48
# (c): card against CPU at fp32 compute (fp32 scan), full width, cut in
# depth; the logits within XDEV_TOL of the largest |logit|
XDEV = ((GEMMA, 6), (GRANITE_MOE, 2), (FALCON, 4))
XDEV_TOKENS = 64
XDEV_TOL = 1e-3
# (d): every other arch once, at full width: cut to 2 layers where full
# depth does not fit the card (the fp32 init and the bf16 copy: qwen3-14b
# alone would take 59 + 29.5 GB), whisper at full depth, jamba at its
# smoke config; a prompt of 248 tokens and 8 decode steps (max_len 256, a
# multiple of the smoke config's 32-key attention chunks), whisper over
# 1,500 frames (its 30 s window), internvl2 behind 256 patches
CUT_ARCHS = ("qwen3-14b", "yi-34b", "granite-20b", "phi3.5-moe-42b-a6.6b",
             "internvl2-26b")
ARCH_BATCH, ARCH_PROMPT, ARCH_STEPS = 2, 248, 8
WHISPER_FRAMES = 1_500
# (e): one gemma3 request of 128 prompt tokens paged through the store
ARCH_SESSION_PROMPT = 128


def arch_configs() -> dict:
    """Phase 12's configurations at the card's sizes: (a)-(b) served,
    (c) card against CPU, (d) the rest once."""
    return {"serve": (get_config(GEMMA), get_config(GRANITE_MOE)),
            "xdev": tuple(get_config(n).with_(n_layers=k) for n, k in XDEV),
            "once": tuple(get_config(n).with_(n_layers=2) for n in CUT_ARCHS)
            + (get_config(WHISPER), get_smoke_config(JAMBA))}


def free_card(dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _subtrees(tree, has: str):
    """The dicts of ``tree`` that hold the key ``has``."""
    if isinstance(tree, dict):
        if has in tree:
            yield tree
            return
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _subtrees(t, has)


def decode_step_bytes(eng, cache, tok, pos) -> dict:
    """The bytes one decode step of ``tok`` at ``pos`` from ``cache`` must
    read, for its bound.  ``weight_bytes``: every leaf of the engine's
    tree but an untied embedding table (a step gathers its rows only; a
    tied table is the head, read whole) and, of each MoE layer's experts,
    only those that the step's routing hits (``experts_hit``, one count a
    MoE layer, read off one eager step).  ``cache_bytes``: each attention
    layer's filled slots after the step's insert (K, V and the position)
    and each mamba layer's whole state."""
    n = state_bytes(eng.params)
    if "head" in eng.params:
        n -= state_bytes(eng.params["embed"])
    hit = []
    route = moe._route

    def watch(rp, xt, c):
        r = route(rp, xt, c)
        hit.append(int(torch.unique(r[1]).numel()))
        return r

    with mock.patch.object(moe, "_route", watch):
        _, new = lm.decode_step(eng.params, cache, tok, pos, eng.cfg)
    if hit:
        experts = sum(state_bytes([f[w] for w in ("wi", "wg", "wo")
                                   if w in f])
                      for f in _subtrees(eng.params, "router"))
        per_expert = experts // (len(hit) * eng.cfg.moe_experts)
        n += sum(hit) * per_expert - experts
    kv = 0
    for c in _subtrees(new, "pos"):
        k = c["k"]
        slot = k.shape[-2] * k.shape[-1] * k.element_size()
        kv += int((c["pos"] >= 0).sum()) * (2 * slot
                                            + c["pos"].element_size())
    kv += state_bytes(new) - sum(state_bytes(c)
                                 for c in _subtrees(new, "pos"))
    return dict(weight_bytes=n, cache_bytes=kv, experts_hit=hit)


def moe_drops(eng, prompts) -> list[tuple[int, int, int]]:
    """(dropped, routed, capacity) slots of each MoE layer in one prefill
    of ``prompts``: the layers' ranks within their experts, against the
    capacity ``moe_ffn`` computes for the prefill's tokens."""
    seen = []
    rank = moe._positions_in_expert

    def watch(flat_e, e):
        pos = rank(flat_e, e)
        seen.append(pos)
        return pos

    with mock.patch.object(moe, "_positions_in_expert", watch):
        lm.prefill(eng.params, {"tokens": prompts}, eng.cfg, eng.max_len)
    out = []
    for pos in seen:
        c = moe.capacity(eng.cfg, pos.numel() // eng.cfg.moe_top_k)
        out.append((int((pos >= c).sum()), pos.numel(), c))
    return out


def ring_wrap(eng, dev, *, prompt_len: int = RING_PROMPT,
              steps: int = RING_STEPS, seed: int = 12) -> dict:
    """One request of ``prompt_len`` tokens prefilled with ``max_len =
    prompt_len + steps``, then ``steps`` teacher-forced steps of the
    engine's captured decode (a new engine over the same cast params: no
    copy), so that the windowed layers' positions run past their ring of
    slots; the prefill's and every step's logits held against ``forward``
    over all the tokens, within ``LOGIT_TOL`` of the largest |logit|."""
    cfg = eng.cfg
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, prompt_len + steps)).astype(np.int32)).to(dev)
    reng = ServeEngine(cfg, eng.params, max_len=prompt_len + steps,
                       device=dev)
    full, _ = lm.forward(reng.params, {"tokens": toks}, cfg)
    logit, cache, pos = lm.prefill(reng.params,
                                   {"tokens": toks[:, :prompt_len]}, cfg,
                                   reng.max_len)
    gaps = [last_logits_gap(logit, full[:, prompt_len - 1])]
    for i in range(prompt_len, prompt_len + steps):
        step, cache = reng._decode(reng.params, cache, toks[:, i:i + 1],
                                   pos)
        gaps.append(last_logits_gap(step[:, 0], full[:, i]))
        pos = pos + 1
    slots = min(w for w in cfg.windows if w)
    ring_pos = [int(p) for p in cache["blocks"]["p0"]["pos"][0, 0]]
    worst = max(g for g, _ in gaps)
    if worst > LOGIT_TOL:
        raise AssertionError(f"the ring wrap: logits differ from forward's "
                             f"by {worst:.3g} of the largest |logit|")
    if sorted(ring_pos) != list(range(prompt_len + steps - slots,
                                      prompt_len + steps)):
        raise AssertionError("the windowed layers' ring does not hold the "
                             "last positions")
    return dict(prompt_len=prompt_len, steps=steps, gaps=gaps, worst=worst,
                slots=slots,
                wrapped=prompt_len + steps - slots,
                agree=sum(a for _, a in gaps) / len(gaps),
                graphs=len(reng._graphs))


def device_profile(fn, attempts: int = 3) -> dict | None:
    """One call of ``fn`` in a CUPTI trace (``trace_timeline``): its
    device events, their summed time, the span from the first one's start
    to the last one's end, the idle share of that span and the three
    names that took the most time; None when ``attempts`` traces came
    back empty."""
    for _ in range(attempts):
        tl = trace_timeline(fn)
        if tl:
            break
    else:
        return None
    busy = sum(ms for _, _, ms in tl)
    span = (max(t + ms * 1e3 for t, _, ms in tl) - min(t for t, _, _ in tl)
            ) / 1e3
    by: dict[str, float] = collections.defaultdict(float)
    for _, name, ms in tl:
        by[name] += ms
    top = sorted(by.items(), key=lambda kv: -kv[1])[:3]
    return dict(events=len(tl), busy_ms=busy, span_ms=span,
                idle=1 - busy / span if span > 0 else 0.0, top=top)


def served_arch(cfg, dev, *, seed: int = 0, ring: dict | None = None,
                batch: int = SERVE_BATCH, prompt_len: int = SERVE_PROMPT,
                max_new: int = SERVE_NEW) -> dict:
    """(a), (b): ``cfg`` served as phase 5 serves falcon
    (``serve_phase``), the bytes of its decode step's bound, the MoE
    prefill's capacity drops, and (``ring``: ``ring_wrap``'s arguments)
    the ring wrap."""
    sv = serve_phase(cfg, dev, batch=batch, prompt_len=prompt_len,
                     max_new=max_new, seed=seed)
    eng = sv["engine"]
    sv.update(cfg=cfg, batch=batch, prompt_len=prompt_len, max_new=max_new)
    if cfg.moe_experts:
        sv["drops"] = moe_drops(eng, sv["prompts"])
    batch_in = {"tokens": sv["prompts"]}
    logit, cache, pos = lm.prefill(eng.params, batch_in, cfg, eng.max_len)
    tok = logit.argmax(-1)[:, None].to(torch.int32)
    sv.update(decode_step_bytes(eng, cache, tok, pos))
    if torch.device(dev).type == "cuda":
        sv["prefill_profile"] = device_profile(lambda: lm.prefill(
            eng.params, batch_in, cfg, eng.max_len))
        sv["step_profile"] = device_profile(lambda: eng._decode(
            eng.params, cache, tok, pos))
    del logit, cache
    if ring is not None:
        sv["ring"] = ring_wrap(eng, dev, **ring)
    if sv["decode_gap"][0] > LOGIT_TOL:
        raise AssertionError(f"{cfg.name}: prefill-then-decode differs from "
                             f"the longer prefill by {sv['decode_gap'][0]:.3g}"
                             " of the largest |logit|")
    if not ((sv["tokens"] >= 0) & (sv["tokens"] < lm.padded_vocab(cfg))
            ).all():
        raise AssertionError(f"{cfg.name}: tokens outside the padded vocab")
    return sv


def card_against_cpu(cfg, dev, *, tokens: int = XDEV_TOKENS,
                     seed: int = 0) -> dict:
    """(c): ``cfg`` at fp32 compute and an fp32 scan, one set of weights
    (made on the card, copied to the CPU): ``forward`` over ``tokens``
    tokens and a prefill of all but the last followed by one decode step,
    on the card and on the CPU.  The MoE routing must be equal and the
    logits within ``XDEV_TOL`` of the largest |logit| (the CPU route is
    the one the CPU tests hold against JAX)."""
    cfg = cfg.with_(dtype="float32", ssm_scan_dtype="float32")
    params = lm.init(seed, cfg, device=dev)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, tokens)).astype(np.int32))
    out = {}
    route = moe._route
    for where, d in (("card", torch.device(dev)), ("cpu", torch.device(
            "cpu"))):
        p = params if where == "card" else tree_map(lambda a: a.cpu(),
                                                    params)
        t = toks.to(d)
        routes = []

        def watch(rp, xt, c, routes=routes):
            r = route(rp, xt, c)
            routes.append(r[1].cpu())
            return r

        with mock.patch.object(moe, "_route", watch):
            logits, aux = lm.forward(p, {"tokens": t}, cfg)
            _, cache, pos = lm.prefill(p, {"tokens": t[:, :-1]}, cfg, tokens)
            step, _ = lm.decode_step(p, cache, t[:, -1:], pos, cfg)
        out[where] = dict(logits=logits.cpu(), step=step[:, 0].cpu(),
                          aux=float(aux), routes=routes)
        del p, logits, cache, step
    del params
    card, cpu = out["card"], out["cpu"]
    res = dict(name=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               tokens=tokens,
               forward_gap=last_logits_gap(card["logits"], cpu["logits"])[0],
               step_gap=last_logits_gap(card["step"], cpu["step"])[0],
               aux=(card["aux"], cpu["aux"]), routes=len(cpu["routes"]))
    if len(card["routes"]) != len(cpu["routes"]) or not all(
            torch.equal(a, b) for a, b in zip(card["routes"],
                                              cpu["routes"])):
        raise AssertionError(f"{cfg.name}: the MoE routing differs between "
                             "the card and the CPU")
    if max(res["forward_gap"], res["step_gap"]) > XDEV_TOL:
        raise AssertionError(f"{cfg.name}: card against CPU at fp32: logits "
                             f"differ by {res['forward_gap']:.3g} / "
                             f"{res['step_gap']:.3g} of the largest |logit|")
    return res


def arch_once(cfg, dev, *, batch: int = ARCH_BATCH,
              prompt_len: int = ARCH_PROMPT, steps: int = ARCH_STEPS,
              frames: int = WHISPER_FRAMES, seed: int = 0) -> dict:
    """(d): ``cfg`` built from a seed, a prefill of ``batch`` x
    ``prompt_len`` tokens (with ``frames`` frames for the encoder-decoder
    arch, behind ``cfg.frontend_len`` patches for the vision arch) and
    ``steps`` decode steps, eager, and for an arch the engine serves also
    through the engine's captured step from the same state (the greedy
    tokens equal, the logits bit for bit or within ``LOGIT_TOL``); every
    logit finite; prefill-then-decode against the longer prefill within
    ``LOGIT_TOL`` (``decode_routes``, ``prefill_then_decode_gap``).  The
    launch counts are set to 0 before the prefill and read after the
    decode steps."""
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(seed, cfg, device=dev)
    n_params = sum(a.numel() for a in tree_leaves(params))
    prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
    eng = ServeEngine(cfg, params, max_len=prefix + prompt_len + steps,
                      device=dev)
    del params
    sync(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    inputs = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)}
    if cfg.frontend == "vision":
        inputs["patches"] = normal(batch, cfg.frontend_len, cfg.d_model)
    enc = None
    if cfg.enc_dec:
        inputs["frames"] = normal(batch, frames, cfg.d_model)
        enc, _ = lm._encode(eng.params, inputs["frames"], cfg)
    served = not (cfg.enc_dec or cfg.frontend)
    ops.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    logit, cache, pos = lm.prefill(eng.params, inputs, cfg, eng.max_len)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logit).all()):
        raise AssertionError(f"{cfg.name}: prefill logits not all finite")
    first = logit.argmax(-1)[:, None].to(torch.int32)
    runs = decode_routes(eng, cache, first, pos, steps, enc_out=enc,
                         captured=served)
    launches = ops.launch_counts()
    decode_gap = prefill_then_decode_gap(eng, inputs, logit, enc_out=enc)
    if decode_gap[0] > LOGIT_TOL:
        raise AssertionError(f"{cfg.name}: prefill-then-decode differs from "
                             f"the longer prefill by {decode_gap[0]:.3g}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    res = dict(name=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               n_params=n_params, init_s=init_s, prefill_ms=prefill_ms,
               eager_ms=runs["eager"]["ms"],
               captured_ms=runs["captured"]["ms"] if served else None,
               bitwise=runs["bitwise"], captured_gap=runs["gap"],
               decode_gap=decode_gap,
               launches=launches, peak=peak, served=served,
               tokens=runs["eager"]["tokens"])
    del eng, runs, cache, enc, inputs
    free_card(dev)
    return res


def archs_phase(work: str, dev, *, configs: dict | None = None,
                serve_sizes: dict | None = None, ring: dict | None = None,
                xdev_tokens: int = XDEV_TOKENS, once_sizes: dict | None
                = None, session_prompt: int = ARCH_SESSION_PROMPT,
                db_cfg: DBConfig | None = None, report=None) -> dict:
    """Phase 12: (a) gemma3-4b served (``served_arch``) with the ring
    wrap, (e) one of its requests paged through the store
    (``session_phase`` on its engine, the store's kernels), then the model
    freed; (b) granite-moe-3b-a800m served with its capacity drops; (c)
    card against CPU at fp32 (``card_against_cpu``); (d) the other archs
    once (``arch_once``).  ``report(part, result)`` is called as each part
    ends.  Returns the parts' results and ``launches``, the kernel
    launches of (d) and (e), each counted from 0 around its path.
    (``configs``, the sizes, ``ring`` and ``db_cfg`` scale the phase down
    for a rehearsal.)"""
    configs = configs or arch_configs()
    serve_sizes = serve_sizes or {}
    once_sizes = once_sizes or {}
    report = report or (lambda part, r: None)
    launches = collections.Counter()
    out = {}
    gemma, granite = configs["serve"]
    t0 = time.perf_counter()
    out["a"] = served_arch(gemma, dev, ring=ring or {}, **serve_sizes)
    out["a"]["seconds"] = time.perf_counter() - t0
    report("a", out["a"])
    t0 = time.perf_counter()
    prompts = out["a"]["prompts"][:1, :session_prompt]
    out["e"] = session_phase(out["a"].pop("engine"), prompts, work,
                             db_cfg=db_cfg)
    out["e"]["seconds"] = time.perf_counter() - t0
    launches.update(out["e"]["launches"])
    report("e", out["e"])
    del out["a"]["prompts"]
    free_card(dev)
    t0 = time.perf_counter()
    out["b"] = served_arch(granite, dev, **serve_sizes)
    del out["b"]["engine"], out["b"]["prompts"]
    out["b"]["seconds"] = time.perf_counter() - t0
    report("b", out["b"])
    free_card(dev)
    t0 = time.perf_counter()
    out["c"] = [card_against_cpu(cfg, dev, tokens=xdev_tokens)
                for cfg in configs["xdev"]]
    free_card(dev)
    report("c", dict(rows=out["c"], seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    out["d"] = []
    for cfg in configs["once"]:
        r = arch_once(cfg, dev, **once_sizes)
        launches.update(r["launches"])
        out["d"].append(r)
    report("d", dict(rows=out["d"], seconds=time.perf_counter() - t0))
    out["launches"] = dict(launches)
    return out


def served_lines(part: str, sv: dict, card: str) -> list[str]:
    """The phase-12 report of (a) or (b)."""
    cfg, batch = sv["cfg"], sv["batch"]
    bound_ms = (sv["weight_bytes"] + sv["cache_bytes"]) / HBM_BYTES_PER_S \
        * 1e3
    experts = "" if not sv["experts_hit"] else (
        f"; of each MoE layer's {cfg.moe_experts} experts only the "
        f"{min(sv['experts_hit'])}-{max(sv['experts_hit'])} that the step's "
        f"routing hits, {sum(sv['experts_hit'])} over "
        f"{len(sv['experts_hit'])} layers")
    peak = "not measured" if sv["peak"] is None else \
        f"{sv['peak'] / 1e9:.2f} GB"
    lines = [
        f"[12] ({part}) {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.kv_heads} kv heads "
        f"of {cfg.resolved_head_dim}, vocab {cfg.vocab} padded to "
        f"{lm.padded_vocab(cfg)}, {cfg.dtype}; {sv['n_params']:,} "
        f"parameters (config count {cfg.param_count():,}), built in "
        f"{sv['init_s']:.1f} s; the engine holds "
        f"{sv['card_bytes'] / 1e9:.2f} GB; peak allocated {peak} [{card}]",
        f"[12] ({part}) generate: {batch} requests x {sv['prompt_len']} "
        f"prompt tokens, {sv['max_new']} new each in "
        f"{sv['gen_s'] * 1e3:.1f} ms = {sv['tokens_per_s']:.1f} tokens/s "
        f"(captured decode); prefill {sv['prefill_ms']:.1f} ms (host clock "
        f"after a synchronize, median of 3) [{card}]"]
    for how, ms in (("eager (model.decode_step)", sv["decode_ms"]),
                    ("captured (ServeEngine._decode, one CUDA graph)",
                     sv["captured_ms"])):
        lines.append(
            f"[12] ({part}) decode {how}: {ms:.2f} ms a step of {batch} = "
            f"{batch / ms * 1e3:.1f} tokens/s (host clock after a "
            f"synchronize, median of {sv['max_new'] - 1}); bound "
            f"{bound_ms:.3f} ms (the step's {sv['weight_bytes'] / 1e9:.3f} GB"
            f" of weights{experts}, and {sv['cache_bytes'] / 1e9:.3f} GB of "
            f"the KV cache's filled slots, over 3.35 TB/s) [{card}]")
    same = "bit for bit equal" if sv["captured_bitwise"] else (
        f"differ, by {sv['captured_logits_gap']:.3g} of the largest |logit| "
        f"(limit {LOGIT_TOL})")
    lines.append(
        f"[12] ({part}) captured against eager: greedy tokens equal; last "
        f"logits and cache {same}; prefill of {sv['prompt_len'] - 1} + "
        f"decode vs prefill of {sv['prompt_len']}: last logits "
        f"{sv['decode_gap'][0]:.3g} of the largest (limit {LOGIT_TOL}), "
        f"argmax agrees in {sv['decode_gap'][1]:.0%}; req0 "
        f"{sv['tokens'][0].tolist()}")
    for what, key in (("one prefill", "prefill_profile"),
                      ("one captured decode step", "step_profile")):
        pr = sv.get(key)
        if key in sv:
            lines.append(
                f"[12] ({part}) {what} in a CUPTI trace: " + (
                    "no device events came back" if pr is None else
                    f"{pr['events']} device events, {pr['busy_ms']:.3f} ms "
                    f"busy over a {pr['span_ms']:.3f} ms span (idle "
                    f"{pr['idle']:.1%}); most time: " + "; ".join(
                        f"{n[:60]} {ms:.3f} ms" for n, ms in pr["top"]))
                + f" [{card}]")
    if "drops" in sv:
        d = sv["drops"]
        lines.append(
            f"[12] ({part}) the prefill's MoE capacity: c = {d[0][2]} slots "
            f"an expert for {d[0][1]} routed slots "
            f"({d[0][1] // cfg.moe_top_k} tokens x top-{cfg.moe_top_k} of "
            f"{cfg.moe_experts} experts); dropped "
            f"{sum(x for x, _, _ in d)} of {sum(n for _, n, _ in d)} over "
            f"{len(d)} layers ({min(x for x, _, _ in d)}-"
            f"{max(x for x, _, _ in d)} a layer)")
    if "ring" in sv:
        rg = sv["ring"]
        lines.append(
            f"[12] ({part}) the ring wrap: 1 request of {rg['prompt_len']} "
            f"prompt tokens, then {rg['steps']} teacher-forced captured "
            f"decode steps: positions {rg['prompt_len']}-"
            f"{rg['prompt_len'] + rg['steps'] - 1}, {rg['wrapped']} of them "
            f"past the windowed layers' {rg['slots']} slots; the prefill's "
            f"and every step's logits against forward over all "
            f"{rg['prompt_len'] + rg['steps']} tokens: worst "
            f"{rg['worst']:.3g} of the largest |logit| (limit {LOGIT_TOL}), "
            f"argmax agrees at {rg['agree']:.0%} of the positions")
    lines.append(f"[12] ({part}) {sv['seconds']:.1f} s")
    return lines


def archs_part_lines(part: str, r: dict, card: str) -> list[str]:
    """The report lines of one part of phase 12."""
    if part in ("a", "b"):
        return served_lines(part, r, card)
    if part == "e":
        return [
            f"[12] (e) one gemma3-4b request's (cache, pos), "
            f"{r['bytes']:,} B, paged through an LsmDB at phase 7's geometry:"
            f" {r['records']} records, save {r['save_s']:.3f} s, "
            f"load_session {r['load_s']:.3f} s and load_sessions "
            f"{r['load_many_s']:.3f} s bit for bit; {r['resume']} captured "
            f"steps resumed from the loaded state equal an uninterrupted "
            f"run; churn, reopen and drop as in phase 7; the jobs "
            f"{r['job_checks']} byte-identical to their reruns on the plain "
            f"versions, the load's wave calls bit-identical [{card}]",
            "[12] (e) launches: " + ", ".join(
                f"{k} {r['launches'][k]}" for k in ATTN_SESSION_PATH),
            f"[12] (e) {r['seconds']:.1f} s"]
    if part == "c":
        lines = [
            f"[12] (c) {x['name']} cut to {x['layers']} layers at full width "
            f"(d_model {x['d_model']}), fp32 compute and scan, 1 x "
            f"{x['tokens']} tokens, the same weights: card against CPU, "
            f"forward logits {x['forward_gap']:.3g} and prefill-then-decode "
            f"logits {x['step_gap']:.3g} of the largest |logit| (limit "
            f"{XDEV_TOL}); aux {x['aux'][0]:.6g} / {x['aux'][1]:.6g}; "
            f"{x['routes']} MoE routings equal" for x in r["rows"]]
        return lines + [f"[12] (c) {r['seconds']:.1f} s"]
    lines = []
    for x in r["rows"]:
        peak = "not measured" if x["peak"] is None else \
            f"{x['peak'] / 1e9:.2f} GB"
        cap = (f", captured {x['captured_ms']:.2f} ms, "
               + ("bit for bit" if x["bitwise"] else
                  f"logits within {x['captured_gap']:.3g}")
               + " of eager, tokens equal") if x["served"] else \
            " (not served by the engine: eager only)"
        kern = {k: n for k, n in x["launches"].items() if n}
        lines.append(
            f"[12] (d) {x['name']}: {x['layers']} layers, d_model "
            f"{x['d_model']}, {x['n_params']:,} parameters, peak {peak}; "
            f"prefill {x['prefill_ms']:.1f} ms, decode eager "
            f"{x['eager_ms']:.2f} ms a step{cap}; logits finite; "
            f"prefill-then-decode vs the longer prefill "
            f"{x['decode_gap'][0]:.3g} of the largest (limit {LOGIT_TOL}); "
            f"kernel launches {kern or 'none'} [{card}]")
    return lines + [f"[12] (d) {r['seconds']:.1f} s"]


# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------

# (a): falcon-mamba-7b at full width cut to 4 of 64 layers (its fp32
# params, grads and two AdamW moments whole would take ~116 GB), bf16
# compute with fp32 master weights and moments, remat as the config says;
# 4 x 512 tokens of BigramStream a step, 6 steps
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 512, 6
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2)
# the backward kernel against the plain backward on the kept inputs: max
# abs error <= SCAN_TOL of each gradient's largest magnitude (both fp32;
# ex2.approx against exp, and other summation orders)
SCAN_GRADS = ("du", "ddt", "db", "dc", "da_log", "dd_skip", "dh0")
# (b): the same model cut to 2 layers and d_model 64, the vocab kept
# (~8.5 M parameters, a 0.1 GB TrainState, ~25,400 records a save): a
# save at (a)'s size would be ~11.5 GB, ~2.9 M puts, and at d_model 128
# (0.2 GB, 51,058 puts) the six saves took 89 s of the card run at
# 10-21 MB/s; 8 steps of 4 x 128, a checkpoint every 3 steps, 2 kept, a
# failure at step 5
CKPT_D_MODEL, CKPT_LAYERS = 64, 2
CKPT_LOOP = dict(steps=8, batch=4, seq=128, ckpt_every=3, keep_ckpts=2,
                 log_every=100)
CKPT_FAIL = 5
KEPT_CKPT_FLUSHES = 2      # (b): flushes a store rebuilt on the plain versions
KEPT_CKPT_JOBS = 3         # (b): jobs a store rebuilt on the plain versions,
#                            besides every job that dropped records
TWIN_STEPS = 4             # (b): saves of the trimmed state into a cuda and
#                            a cpu store
# (c): the launcher on the card, as a user would run it
LAUNCH_ARGS = ("--arch", FALCON, "--smoke", "--steps", "8", "--ckpt-every",
               "3", "--fail-at", "5")
LAUNCH_TIMEOUT = 300
# the card's peak rates for the step's bound (NVIDIA H100 SXM data sheet):
# bf16 products on the tensor cores; fp32 products outside them
BF16_FLOPS_PER_S = h100.PEAK_FLOPS_BF16


def train_configs() -> dict:
    """Phase 13's configurations: (a) full width cut in depth, (b) the
    checkpoint run's cut."""
    full = get_config(FALCON)
    return {"full": full.with_(n_layers=TRAIN_LAYERS),
            "ckpt": full.with_(n_layers=CKPT_LAYERS, d_model=CKPT_D_MODEL)}


def train_step_bound(cfg, batch: int, seq: int, n_params: int) -> dict:
    """The step's least time on the card (ms), part by part, each the
    larger of its FLOPs over the rate for its dtype and its bytes over the
    HBM rate: the layers' products (bf16; forward, remat's recompute and
    the two backward products), the fp32 head (JAX's ``layers.logits``
    computes in fp32; the loss chunk's forward, its recompute and two
    backward products) and AdamW with the gradients (fp32 params read and
    written, the gradient read, m and v read and written: 28 B a
    parameter)."""
    d, di, ds, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    tokens, pred = batch * seq, batch * (seq - 1)
    vocab = lm.padded_vocab(cfg)
    passes = 4 if cfg.remat else 3
    macs = d * 2 * di + di * (dr + 2 * ds) + dr * di + di * d
    layer_flops = 2 * tokens * macs * cfg.n_layers * passes
    layer_bytes = 2 * macs * cfg.n_layers * passes   # bf16 weights a pass
    head_flops = 2 * pred * vocab * d * 4
    head_bytes = 4 * (vocab * d + pred * vocab) * 4  # fp32 head, logits
    parts = {
        "layers": (layer_flops, max(layer_flops / BF16_FLOPS_PER_S,
                                    layer_bytes / HBM_BYTES_PER_S) * 1e3),
        "head": (head_flops, max(head_flops / SCALAR_OPS_PER_S,
                                 head_bytes / HBM_BYTES_PER_S) * 1e3),
        "optimizer": (28 * n_params, 28 * n_params / HBM_BYTES_PER_S * 1e3)}
    return dict(parts=parts, ms=sum(ms for _, ms in parts.values()))


@contextlib.contextmanager
def keep_scan_bwd(dev, kept: list):
    """Record the inputs of the first scan backward call made inside (on
    the card the kernel's wrapper, on the CPU the plain one, as ``ops``
    dispatches), cloned, into ``kept``: ``(*args, dy, dh_last)``."""
    from repro_torch.kernels import selective_scan as scan_kernel
    owner = scan_kernel if torch.device(dev).type == "cuda" else ref
    real = owner.selective_scan_bwd

    def watch(*args):
        if not kept:
            kept.append(tuple(None if a is None else a.detach().clone()
                              for a in args))
        return real(*args)

    with mock.patch.object(owner, "selective_scan_bwd", watch):
        yield kept


@contextlib.contextmanager
def count_plain_scan_calls():
    """Count the plain scan's calls as ``ops`` dispatches them on the CPU,
    where the wrappers launch nothing: yields ``{"selective_scan":
    forwards, "selective_scan_bwd": backwards}``, the backward's own
    recompute of the forward not counted.  On the card the launch counts
    say the same."""
    counts = {"selective_scan": 0, "selective_scan_bwd": 0}
    inside = [0]
    fwd, bwd = ref.selective_scan, ref.selective_scan_bwd

    def forward(*a, **kw):
        counts["selective_scan"] += not inside[0]
        return fwd(*a, **kw)

    def backward(*a, **kw):
        counts["selective_scan_bwd"] += 1
        inside[0] += 1
        try:
            return bwd(*a, **kw)
        finally:
            inside[0] -= 1

    with mock.patch.multiple(ref, selective_scan=forward,
                             selective_scan_bwd=backward):
        yield counts


def check_scan_bwd_call(dev, call) -> tuple[dict, float | None]:
    """The backward on ``call``'s inputs (the kernel on the card, as the
    training path ran it) twice, and the plain backward once: raise unless
    the two runs are equal bit for bit and each gradient is within
    ``SCAN_TOL`` of the plain one's largest magnitude; a bf16 ``du`` (both
    sides round their fp32 sums once) also within one bf16 ulp of the
    plain value, ``BF16_ULP`` of it.  Returns the max abs errors by
    gradient, and the plain call's ms by CUDA events (None on the CPU)."""
    from repro_torch.kernels import selective_scan as scan_kernel
    on_card = torch.device(dev).type == "cuda"
    fn = scan_kernel.selective_scan_bwd if on_card \
        else ref.selective_scan_bwd
    got, again = fn(*call), fn(*call)
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    want = ref.selective_scan_bwd(*call)
    plain_ms = None
    if on_card:
        ev[1].record()
        ev[1].synchronize()
        plain_ms = ev[0].elapsed_time(ev[1])
    errs = {}
    for name, g, a, w in zip(SCAN_GRADS, got, again, want):
        if w is None:
            continue
        if not torch.equal(bits(g), bits(a)):
            raise AssertionError(f"selective_scan_bwd {name}: two runs on "
                                 "the same inputs differ")
        if g.dtype != w.dtype:
            raise AssertionError(f"selective_scan_bwd {name}: {g.dtype}, "
                                 f"the plain backward's {w.dtype}")
        err, w = (g.float() - w.float()).abs(), w.float()
        errs[name] = float(err.max())
        ulp = BF16_ULP if g.dtype == torch.bfloat16 else 0.0
        if not bool((err <= SCAN_TOL * float(w.abs().max())
                     + ulp * w.abs()).all()):
            raise AssertionError(
                f"selective_scan_bwd {name} at {tuple(call[0].shape)} differs "
                f"from the plain backward: max abs err {errs[name]:.3g} "
                f"(limit {SCAN_TOL} of {float(w.abs().max()):.3g}"
                + (f" plus {ulp} of each value)" if ulp else ")"))
    return errs, plain_ms


def train_full(cfg, dev, *, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
               steps: int = TRAIN_STEPS, opt: dict | None = None) -> dict:
    """(a): ``steps`` train steps of ``cfg`` from ``init_state(0)`` on
    ``BigramStream`` batches, each timed by CUDA events; the launches of
    the steps counted from 0; the last step's first scan backward (the
    last layer's) kept and held against the plain backward."""
    from repro_torch.data.tokens import BigramStream, make_train_batch
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_step as ts
    on_card = torch.device(dev).type == "cuda"
    free_card(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    opt_cfg = optim.AdamWConfig(total_steps=steps, **(opt or TRAIN_OPT))
    t0 = time.perf_counter()
    state = ts.init_state(0, cfg, opt_cfg, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in tree_leaves(state.params))
    stream = BigramStream(cfg.vocab, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                make_train_batch(cfg, stream, s, batch, seq).items()}
               for s in range(steps)]
    losses, gnorms, step_ms, kept = [], [], [], []
    ops.reset_launch_counts()
    with contextlib.nullcontext(None) if on_card else \
            count_plain_scan_calls() as calls:
        for s, b in enumerate(batches):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(2)] if on_card else None
            with keep_scan_bwd(dev, kept) if s == steps - 1 \
                    else contextlib.nullcontext():
                if ev:
                    ev[0].record()
                state, m = ts.train_step(state, b, cfg=cfg, opt_cfg=opt_cfg)
                if ev:
                    ev[1].record()
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if ev:
                step_ms.append(ev[0].elapsed_time(ev[1]))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    passes = 2 if cfg.remat else 1
    want = {"selective_scan": passes * cfg.n_layers * steps,
            "selective_scan_bwd": cfg.n_layers * steps}
    got = {k: launches[k] for k in want}
    if (got if on_card else calls) != want:
        raise AssertionError(f"[13] (a) scan launches {got}, plain calls "
                             f"{calls}, expected {want} (a layer's forward, "
                             "its remat recompute if any, and its backward, "
                             "each step)")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"[13] (a) losses {losses}, grad norms {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[13] (a) the loss did not fall: {losses}")
    errs, _ = check_scan_bwd_call(dev, kept[0])
    del state, batches
    free_card(dev)
    timed = step_ms[1:] if step_ms else []
    mean_ms = statistics.mean(timed) if timed else None
    return dict(cfg=cfg, n_params=n_params, init_s=init_s, losses=losses,
                grad_norms=gnorms, step_ms=step_ms,
                mean_ms=mean_ms, peak=peak, batch=batch, seq=seq,
                tokens_per_s=(batch * seq / mean_ms * 1e3) if mean_ms
                else None, launches=got,
                calls=None if calls is None else dict(calls),
                bound=train_step_bound(cfg, batch, seq, n_params),
                kept_shape=tuple(kept[0][0].shape), bwd_err=errs)


def bwd_cases(rng, dev, shapes=SCAN_SHAPES, di: int = 8192, ds: int = 16,
              u_dtype=torch.bfloat16):
    """Row 9b's cases: (name, (args, dy, None), bytes, exponentials, other
    fp32 operations) at the scan's shapes: the forward's inputs as
    ``scan_cases`` makes them (no ``h0``) and a normal ``dy``.  Bytes count the
    inputs (u, dt, B, C, A_log, D, dy) read once and the gradients
    written once (du in u's dtype; ddt, dB, dC, dA_log and dD fp32); the
    exponentials are one per (b, t, i, s) and one per A entry; the other
    operations about 12 per (b, t, i, s)."""
    out = []
    for (name, args, _, n_exp, _), (b, s) in zip(
            scan_cases(rng, dev, shapes, di, ds, u_dtype), shapes):
        dy = torch.from_numpy(rng.standard_normal((b, s, di)).astype(
            np.float32)).to(dev)
        ins = sum(a.numel() * a.element_size() for a in args[:6]) \
            + dy.numel() * 4
        outs = args[0].element_size() * b * s * di \
            + 4 * (b * s * di + 2 * b * s * ds + di * ds + di)
        out.append((name.replace("selective_scan", "selective_scan_bwd"),
                    ((*args, None), dy, None), ins + outs, n_exp,
                    12 * b * s * di * ds))
    return out


def check_scan_bwd(dev, card: str, clock_hz: float, cases) -> dict:
    """Row 9b: the backward kernel against the plain backward at each
    case (``check_scan_bwd_call``), timed as phase 2 times the kernels:
    CUPTI device time over 20 calls, CUDA events around one call.  The
    plain backward (autograd through the plain scan, a Python loop over
    the steps: ~10**5 small kernels at 1 x 4,096, paced by the host) is
    timed once, by CUDA events around its call."""
    from repro_torch.kernels import selective_scan as scan_kernel
    results = {}
    sfu_per_s = SFU_PER_CLOCK_PER_SM * H100_SMS * clock_hz
    for name, (args, dy, dh), nbytes, n_exp, n_ops in cases:
        call = (*args, dy, dh)
        errs, plain_ms = check_scan_bwd_call(dev, call)
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "exponentials": n_exp / sfu_per_s * 1e3,
                 "fp32 operations": n_ops / SCALAR_OPS_PER_S * 1e3}
        worst = max(times, key=times.get)

        def kern(c=call):
            return scan_kernel.selective_scan_bwd(*c)

        res = dict(max_abs_err=max(errs.values()), errs=errs,
                   ms=device_ms(kern, 20), plain_ms=plain_ms,
                   bound_ms=times[worst],
                   bound_by="bytes" if worst == "bytes" else "operations",
                   library_ms=None, call_ms=call_ms(kern, 20),
                   plain_call_ms=plain_ms)
        log(f"  {name:26s} u {tuple(args[0].shape)}: max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (limit {SCAN_TOL} of each largest), two runs equal bit for "
            f"bit; device time kernel {res['ms']:.4f} ms (the sweep, the "
            f"carry past one segment, the walk and the ordered sums), plain "
            f"{res['plain_ms']:.4f} ms "
            f"(one call, CUDA events); "
            f"bound {res['bound_ms']:.4f} ms by {worst} (bytes "
            f"{times['bytes']:.4f}, exponentials {times['exponentials']:.4f} "
            f"at {clock_hz / 1e6:.0f} MHz, fp32 operations "
            f"{times['fp32 operations']:.4f}); one call {res['call_ms']:.4f} "
            f"ms; library: none ({NO_LIBRARY}) [{card}]")
        results[name] = res
    return results


# The backward's edge cases, shared with the tests: (B, S, d_inner, ds, u
# dtype, h0, dh_last).  With `selective_scan.bwd_plan`'s cut (8-step
# chunks, 64-channel walk blocks): S = 1 (one step, one segment); 16 and 17
# steps (segments of one chunk, the last of one step); 33 and 37 (five
# one-chunk segments, the last ragged); 65 and 130 (segments of three
# chunks, the last of 17 and 10 steps); 300 (four of ten chunks, the last
# 20 steps short); 2 x 1,000 (two of 63 chunks); d_inner 64 (one block),
# 70, 100 and 4,100 (off the block) and 8,192; ds 1, 3, 5, 7 and 16 (states
# past ds padded); bf16 and fp32 u; h0 and dh_last on and off.
SCAN_BWD_EDGES = [
    (2, 37, 70, 5, torch.float32, True, True),
    (1, 17, 100, 16, torch.bfloat16, True, False),
    (3, 1, 8192, 1, torch.bfloat16, False, True),
    (1, 33, 4100, 3, torch.float32, False, False),
    (2, 16, 64, 16, torch.float32, True, True),
    (1, 17, 8192, 16, torch.bfloat16, True, True),
    (1, 65, 8192, 16, torch.float32, True, True),
    (1, 300, 8192, 16, torch.bfloat16, True, True),
    (1, 130, 4100, 16, torch.float32, False, True),
    (2, 1000, 8192, 7, torch.bfloat16, False, True)]


def scan_bwd_edge_call(case, dev) -> tuple:
    """The backward's inputs ``(*args, dy, dh_last)`` of a
    ``SCAN_BWD_EDGES`` case, seeded by the case: softplus ``dt``, ``A_log
    = log(1..ds)`` plus noise, normal ``u``, ``B``, ``C``, ``D``, ``dy``
    and (where the case says) ``h0`` and ``dh_last``."""
    bsz, seq, di, ds, u_dtype, with_h0, with_dh = case
    rng = np.random.default_rng(bsz * 7 + seq * 13 + di + ds)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    u = normal(bsz, seq, di).to(u_dtype)
    dt = torch.nn.functional.softplus(normal(bsz, seq, di) - 2.0)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=dev).repeat(di, 1)) \
        + 0.1 * normal(di, ds)
    h0 = normal(bsz, di, ds) if with_h0 else None
    dy = normal(bsz, seq, di)
    dh = normal(bsz, di, ds) if with_dh else None
    return (u, dt, normal(bsz, seq, ds), normal(bsz, seq, ds), a_log,
            normal(di), h0, dy, dh)


def check_scan_bwd_edges(dev) -> int:
    """Row 9b at ``SCAN_BWD_EDGES``: each case through
    ``check_scan_bwd_call`` (two runs bit-equal, each gradient within
    ``SCAN_TOL`` of the plain backward's largest, a bf16 ``du`` within one
    ulp more) in exactly two launches of the kernel and no other.  Returns
    the cases checked."""
    for case in SCAN_BWD_EDGES:
        before = ops.launch_counts()
        check_scan_bwd_call(dev, scan_bwd_edge_call(case, dev))
        after = ops.launch_counts()
        made = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        if made != {"selective_scan_bwd": 2}:
            raise AssertionError(f"selective_scan_bwd at {case[:4]}: "
                                 f"launches {made}, expected 2 (two runs)")
    return len(SCAN_BWD_EDGES)


@contextlib.contextmanager
def watch_checkpoint_stores(keep_dir: str):
    """For every ``CheckpointStore`` opened inside, record its engine's
    kept jobs (``keep_jobs`` with ``first``) and first flushes (``keep_flushes``),
    its ``DBStats`` when it closes, and each save's and restore's seconds,
    bytes and records.  Yields ``{"jobs", "flushes", "stats", "save_s",
    "saved", "records", "restore_s", "restored"}``."""
    from repro_torch.checkpoint import store as ckpt
    seen = dict(jobs=[], flushes=[], stats=[], save_s=[], saved=[],
                records=[], restore_s=[], restored=[])
    real = {k: getattr(ckpt.CheckpointStore, k)
            for k in ("__init__", "close", "save", "restore")}

    def init(self, *a, **kw):
        real["__init__"](self, *a, **kw)
        d = os.path.join(keep_dir, str(len(seen["stats"])) + "-" +
                         str(time.perf_counter_ns()))
        os.makedirs(d)
        self._kept = (keep_jobs(self.db.engine, d, first=KEPT_CKPT_JOBS),
                      keep_flushes(self.db.engine, KEPT_CKPT_FLUSHES))

    def close(self):
        seen["stats"].append(self.db.stats)
        seen["jobs"].extend(self._kept[0])
        seen["flushes"].extend(self._kept[1])
        real["close"](self)

    def save(self, step, tree):
        t0 = time.perf_counter()
        out = real["save"](self, step, tree)
        seen["save_s"].append(time.perf_counter() - t0)
        seen["saved"].append(sum(t["bytes"] for t in out["tensors"]))
        seen["records"].append(self.db.stats.puts)
        return out

    def restore(self, step, like=None):
        t0 = time.perf_counter()
        out = real["restore"](self, step, like)
        sync(self.device)
        seen["restore_s"].append(time.perf_counter() - t0)
        seen["restored"].append(sum(a.numel() * a.element_size()
                                    for a in tree_leaves(out)))
        return out

    with mock.patch.multiple(ckpt.CheckpointStore, __init__=init,
                             close=close, save=save, restore=restore):
        yield seen


def trimmed(state):
    """A training state without its vocab-sized leaves (the embedding
    table, the head and their moments): the tree the cpu twin store
    takes, whose plain-version flushes and compactions on the CPU would
    otherwise take minutes."""
    def keep(tree):
        return {k: v for k, v in tree.items() if k not in ("embed", "head")}
    return type(state)(keep(state.params), type(state.opt)(
        keep(state.opt.m), keep(state.opt.v), state.opt.step))


def train_ckpt(work: str, dev, cfg, *, loop_kw: dict | None = None) -> dict:
    """(b): the same ``Trainer`` run uninterrupted and under ``Supervisor``
    with a failure at ``CKPT_FAIL``, both checkpointing through the port's
    LSM store on ``dev``; the resumed run's losses equal the
    uninterrupted run's bit for bit after the resume, the last step's
    restore equals the saved state bit for bit, ``steps()`` keeps the
    newest ``keep_ckpts``, the store's compactions on the card dropped
    records that ``gc``'s tombstones shadowed, the kept jobs and flushes
    (``watch_checkpoint_stores``) rebuilt byte-identical on the plain
    versions, and a ``cpu`` store given the same trees writes the same
    SST files."""
    from repro_torch.checkpoint import store as ckpt
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.distributed.fault_tolerance import Supervisor
    from repro_torch.training.train_loop import Trainer, TrainLoopConfig
    loop = TrainLoopConfig(**(loop_kw or CKPT_LOOP))
    keep = os.path.join(work, "kept")
    ops.reset_launch_counts()
    with watch_checkpoint_stores(keep) as seen:
        plain_dir = os.path.join(work, "uninterrupted")
        first = Trainer(cfg, loop, plain_dir, device=dev)
        plain = first.run()
        made = []
        fail_dir = os.path.join(work, "failed")

        def make_trainer(attempt):
            made.append(Trainer(cfg, loop, fail_dir, device=dev,
                                fail_at_step=CKPT_FAIL if attempt == 0
                                else None))
            return made[-1]

        failed = Supervisor(make_trainer).run()
        store = CheckpointStore(fail_dir, device=dev)
        steps = store.steps()
        last = store.restore(steps[-1], like=made[-1].state_struct)
        store.close()
    launches = ops.launch_counts()
    resumed = [s for s, _ in failed.losses]
    if failed.restarts != 1 or \
            resumed[0] != CKPT_FAIL // loop.ckpt_every * loop.ckpt_every:
        raise AssertionError(f"[13] (b) restarts {failed.restarts}, resumed "
                             f"at {resumed[0]}")
    before = dict(plain.losses)
    for s, loss in failed.losses:
        if loss != before[s]:
            raise AssertionError(f"[13] (b) step {s}: resumed loss {loss!r} "
                                 f"!= uninterrupted {before[s]!r}")
    if not same_state(last, made[-1].state) or \
            not same_state(first.state, made[-1].state):
        raise AssertionError("[13] (b) the restored last step differs from "
                             "the saved state")
    saved = {*range(loop.ckpt_every, loop.steps + 1, loop.ckpt_every),
             loop.steps}
    if steps != sorted(saved)[-loop.keep_ckpts:]:
        raise AssertionError(f"[13] (b) steps() {steps} after saves at "
                             f"{sorted(saved)}")
    deletes = sum(st.deletes for st in seen["stats"])
    dropped = sum(st.compact_entries_dropped for st in seen["stats"])
    if not (deletes and dropped):
        raise AssertionError(f"[13] (b) gc deleted {deletes} records, the "
                             f"compactions dropped {dropped}")
    t1 = time.perf_counter()
    db_cfg = ckpt.checkpoint_db_config()
    geom = db_cfg.geom
    jobs = check_jobs(seen["jobs"], geom, dev)
    flushed = check_flushes(seen["flushes"], geom, dev)
    check_s = time.perf_counter() - t1
    # the same trees through a store on the card and one on the CPU: the
    # same SST files
    t1 = time.perf_counter()
    twin = trimmed(last)
    digests = []
    for name, device in (("card", dev), ("cpu", "cpu")):
        d = os.path.join(work, f"twin-{name}")
        st = CheckpointStore(d, device=device)
        for k in range(1, TWIN_STEPS + 1):
            st.save(k, tree_map(lambda a, k=k: a + k if a.is_floating_point()
                                else a, twin))
            st.gc(st.steps()[-2:])
        digests.append(sst_digests(d))
        st.close()
    if digests[0] != digests[1]:
        raise AssertionError("[13] (b) a cpu store given the same trees "
                             "wrote other SST files")
    twin_s = time.perf_counter() - t1
    return dict(
        cfg=cfg, loop=loop, geom=geom, memtable=db_cfg.memtable_bytes,
        n_params=sum(a.numel() for a in tree_leaves(last.params)),
        plain=plain.losses, resumed=failed.losses, restarts=failed.restarts,
        steps=steps, saves=seen["save_s"], saved=seen["saved"],
        records=seen["records"], restores=seen["restore_s"],
        restored=seen["restored"], stores=len(seen["stats"]),
        flushes=sum(st.flushes for st in seen["stats"]),
        compactions=sum(st.compactions for st in seen["stats"]),
        puts=sum(st.puts for st in seen["stats"]), deletes=deletes,
        dropped=dropped, jobs=jobs, flushes_checked=flushed,
        launches={k: n for k, n in launches.items() if n},
        check_s=check_s, twin_s=twin_s, twin_files=len(digests[0]),
        twin_bytes=sum(a.numel() * a.element_size()
                       for a in tree_leaves(twin)))


def launcher_run(work: str, dev, args=LAUNCH_ARGS) -> dict:
    """(c): ``python -m repro_torch.launch.train`` as a user runs it (on
    the card unless ``dev`` is the CPU): it must print ``restarts=1`` and
    a finite final loss."""
    ckpt = os.path.join(work, "launcher")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args,
           "--ckpt", ckpt]
    if torch.device(dev).type == "cpu":
        cmd += ["--device", "cpu"]
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=LAUNCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"[13] (c) the launcher exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    last = out.stdout.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in last.split()[1:])
    loss = float(fields["final-loss"])
    if not (last.startswith("finished:") and fields["restarts"] == "1"
            and np.isfinite(loss)):
        raise AssertionError(f"[13] (c) the launcher printed {last!r}")
    return dict(cmd=" ".join(["python", "-m", "repro_torch.launch.train",
                              *args]), line=last, seconds=seconds,
                restarts=int(fields["restarts"]), loss=loss,
                supervisor=[line for line in out.stdout.splitlines()
                            if line.startswith("[supervisor]")])


def train_phase(work: str, dev, *, configs: dict | None = None,
                full_sizes: dict | None = None,
                ckpt_loop: dict | None = None, launcher_args=LAUNCH_ARGS,
                report=None) -> dict:
    """Phase 13: (a) ``train_full``, (b) ``train_ckpt``, (c)
    ``launcher_run``; ``report(part, result)`` as each part ends.
    ``launches`` sums the kernel launches of (a) and (b), each counted
    from 0 around its path.  (``configs``, the sizes, the loop and the
    launcher's arguments scale the phase down for a rehearsal.)"""
    configs = configs or train_configs()
    report = report or (lambda part, r: None)
    out = {}
    t0 = time.perf_counter()
    out["a"] = train_full(configs["full"], dev, **(full_sizes or {}))
    out["a"]["seconds"] = time.perf_counter() - t0
    report("a", out["a"])
    t0 = time.perf_counter()
    out["b"] = train_ckpt(work, dev, configs["ckpt"], loop_kw=ckpt_loop)
    out["b"]["seconds"] = time.perf_counter() - t0
    report("b", out["b"])
    out["c"] = launcher_run(work, dev, launcher_args)
    report("c", out["c"])
    launches = collections.Counter(out["a"]["launches"])
    launches.update(out["b"]["launches"])
    out["launches"] = dict(launches)
    return out


def train_part_lines(part: str, r: dict, card: str) -> list[str]:
    """The phase-13 report of (a), (b) or (c)."""
    if part == "a":
        cfg, bound = r["cfg"], r["bound"]
        timed = (f"{r['mean_ms']:.2f} ms a step (CUDA events, mean of steps "
                 f"2-{len(r['step_ms'])}; each "
                 + ", ".join(f"{t:.2f}" for t in r["step_ms"]) + "), "
                 f"{r['tokens_per_s']:.1f} tokens/s"
                 if r["mean_ms"] else "no device time on the CPU")
        peak = f"{r['peak'] / 1e9:.2f} GB" if r["peak"] else "not measured"
        parts = "; ".join(
            f"{k} {ms:.3f} ms (" + (f"{n / 1e9:.3g} GB" if k == "optimizer"
                                    else f"{n / 1e12:.3g} TFLOP") + ")"
            for k, (n, ms) in bound["parts"].items())
        return [
            f"[13] (a) {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, d_inner {cfg.d_inner}, vocab {cfg.vocab} padded "
            f"to {lm.padded_vocab(cfg)}, {r['n_params']:,} parameters; "
            f"{cfg.dtype} compute, fp32 master weights and moments, remat "
            f"{cfg.remat}; {r['batch']} x {r['seq']} tokens a step, "
            f"{len(r['losses'])} steps; built in {r['init_s']:.1f} s",
            f"[13] (a) step: {timed}; peak allocated {peak} [{card}]",
            f"[13] (a) the step's bound {bound['ms']:.3f} ms: {parts}; the "
            + (f"step is {r['mean_ms'] / bound['ms']:.2f} x its bound"
               if r["mean_ms"] else "step is not timed on the CPU"),
            f"[13] (a) loss " + ", ".join(f"{x:.4f}" for x in r["losses"])
            + "; grad_norm " + ", ".join(f"{x:.4g}" for x in
                                        r["grad_norms"]),
            f"[13] (a) launches {r['launches']} ({cfg.n_layers} layers x "
            f"{len(r['losses'])} steps, the forward "
            f"{'twice (remat) ' if cfg.remat else ''}and the backward once "
            f"a layer); the last step's last-layer backward (u "
            f"{r['kept_shape']}) again on its kept inputs: two runs equal "
            "bit for bit, max abs err against the plain backward "
            + ", ".join(f"{k} {v:.3g}" for k, v in r["bwd_err"].items())
            + f" (limit {SCAN_TOL} of each largest)",
            f"[13] (a) {r['seconds']:.1f} s"]
    if part == "b":
        cfg, loop = r["cfg"], r["loop"]
        mb = [b / 1e6 for b in r["saved"]]
        rates = ", ".join(f"{s:.2f} s ({b / s:.1f} MB/s)"
                          for s, b in zip(r["saves"], mb))
        rrates = ", ".join(f"{s:.2f} s ({b / 1e6 / s:.1f} MB/s)"
                           for s, b in zip(r["restores"], r["restored"]))
        return [
            f"[13] (b) {cfg.name} cut to {cfg.n_layers} layers and d_model "
            f"{cfg.d_model} (vocab {cfg.vocab} kept), {r['n_params']:,} "
            f"parameters: Trainer, {loop.steps} steps of {loop.batch} x "
            f"{loop.seq}, a checkpoint every {loop.ckpt_every}, "
            f"{loop.keep_ckpts} kept, through CheckpointStore on the card "
            f"({r['geom'].value_bytes:,} B values, "
            f"{r['geom'].block_bytes // 1024} KiB blocks, "
            f"{r['memtable'] // 1024} KiB memtables)",
            f"[13] (b) uninterrupted losses "
            + ", ".join(f"{s}: {x!r}" for s, x in r["plain"]),
            f"[13] (b) under Supervisor with a failure at step {CKPT_FAIL}: "
            f"{r['restarts']} restart, resumed at step {r['resumed'][0][0]}; "
            f"every loss after the resume equal to the uninterrupted run's "
            f"bit for bit; the restored step {r['steps'][-1]} equals the "
            f"saved state bit for bit; steps() {r['steps']}",
            f"[13] (b) saves ({len(r['saves'])}, "
            f"{mb[0]:.1f} MB each, records {r['records']}): {rates}; "
            f"restores: {rrates} [{card}]",
            f"[13] (b) {r['stores']} store opens: {r['puts']} puts, "
            f"{r['deletes']} gc deletes, {r['flushes']} flushes, "
            f"{r['compactions']} compactions, which dropped {r['dropped']} "
            f"records shadowed by gc's tombstones; {len(r['jobs'])} jobs "
            f"(each store's first {KEPT_CKPT_JOBS} and every one that "
            f"dropped records) and {len(r['flushes_checked'])} flushes "
            f"byte-identical to their reruns on the plain versions "
            f"({r['check_s']:.1f} s)",
            f"[13] (b) the last state without its vocab-sized leaves "
            f"({r['twin_bytes'] / 1e6:.1f} MB) saved {TWIN_STEPS} times with "
            f"gc into a store on the card and one on the CPU: the same "
            f"{r['twin_files']} SST files ({r['twin_s']:.1f} s)",
            f"[13] (b) launches {r['launches']}",
            f"[13] (b) {r['seconds']:.1f} s"]
    return [f"[13] (c) {r['cmd']}: {' / '.join(r['supervisor'])}; "
            f"{r['line']} ({r['seconds']:.1f} s)"]


# ---------------------------------------------------------------------------
# phase 14: the distributed layer on the card
# ---------------------------------------------------------------------------

# (a): a world of this process alone over NCCL, a (1, 1) mesh from
# make_host_mesh: shard_train_step on phase 13 (a)'s model and batches,
# DIST_STEPS steps, held against train_step from the same seed; phase 5's
# model whole through shard_prefill / shard_decode_step, held against phase
# 5's ServeEngine.generate; one phase-3-shaped job (DIST_RUNS sorted runs of
# DIST_RUN_ROWS rows over one key space at PAPER.geometry(256)) through
# place_sharded / sharded_compact, held against compaction.compact on cuda
# and on cpu
DIST_STEPS = 3
DIST_RUNS, DIST_RUN_ROWS = 4, 16_384
# (b): four ranks sharing the card over gloo (NCCL refuses two ranks on one
# device; the kernel library is built before they start): 4 range shards of
# DIST_RUNS x DIST_RUN_ROWS rows through sharded_compact, each rank's held
# against its shard compacted alone; the scan's DTensor wrapper at phase 5's
# 4 x 512 on a (2, 2) mesh, forward and backward, held against the whole
# scan (the kernel both ways); granite-moe-3b-a800m's expert-parallel FFN
# (d_model 1536, 40 experts, top 8) on (2, 2) against the dense path, at a
# capacity factor of experts / top-k, where neither path drops a token;
# the int8 compressed mean over a line of 4.  The (2, 2) train step is not
# run there: DTensor's all-gather (a Shard -> Replicate redistribution, the
# functional all_gather_into_tensor) ends a gloo rank with SIGSEGV on CUDA
# tensors in torch 2.11 (the plain all_gather_into_tensor works), and FSDP
# gathers every weight; the CPU tests hold that step
DIST_RANKS = 4
DIST_TIMEOUT = 300
DIST_MOE = "granite-moe-3b-a800m"
DIST_MOE_TOKENS = (4, 512)
MOE_FWD_TOL, MOE_GRAD_TOL = 2e-4, 2e-3   # JAX's EP test's tolerances


def dist_train(cfg, dev, mesh, *, batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, steps: int = DIST_STEPS,
               opt: dict | None = None) -> dict:
    """(a): ``steps`` steps of ``train_step`` and then of
    ``shard_train_step`` on ``mesh``, from ``init_state(0)`` on the same
    ``BigramStream`` batches; the sharded steps timed by CUDA events and
    their launches counted from 0; the losses and the final params held
    against each other bit for bit (a one-rank mesh runs the same
    kernels on the same whole tensors)."""
    from repro_torch.data.tokens import BigramStream, make_train_batch
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_step as ts
    on_card = torch.device(dev).type == "cuda"
    free_card(dev)
    opt_cfg = optim.AdamWConfig(total_steps=steps, **(opt or TRAIN_OPT))
    stream = BigramStream(cfg.vocab, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                make_train_batch(cfg, stream, s, batch, seq).items()}
               for s in range(steps)]
    state = ts.init_state(0, cfg, opt_cfg, device=dev)
    plain, plain_ms = [], []
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2)] if on_card else None
        if ev:
            ev[0].record()
        state, m = ts.train_step(state, b, cfg=cfg, opt_cfg=opt_cfg)
        if ev:
            ev[1].record()
            ev[1].synchronize()
            plain_ms.append(ev[0].elapsed_time(ev[1]))
        plain.append(float(m["loss"]))
    want = state.params
    del state
    free_card(dev)
    fn, _, _ = ts.shard_train_step(cfg, mesh, batch, seq, opt_cfg)
    t0 = time.perf_counter()
    state = ts.place_state(ts.init_state(0, cfg, opt_cfg, device=dev), cfg,
                           mesh)
    sync(dev)
    place_s = time.perf_counter() - t0
    losses, step_ms = [], []
    ops.reset_launch_counts()
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2)] if on_card else None
        if ev:
            ev[0].record()
        state, m = fn(state, b)
        if ev:
            ev[1].record()
            ev[1].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
    launches = ops.launch_counts()
    passes = 2 if cfg.remat else 1
    expect = {"selective_scan": passes * cfg.n_layers * steps,
              "selective_scan_bwd": cfg.n_layers * steps}
    got = {k: launches[k] for k in expect}
    if on_card and got != expect:
        raise AssertionError(f"[14] (a) scan launches {got}, expected "
                             f"{expect}")
    pairs = list(zip(tree_leaves(state.params), tree_leaves(want)))
    bitwise = losses == plain and all(
        torch.equal(bits(p.to_local()), bits(q)) for p, q in pairs)
    if not (np.isfinite(losses).all() and bitwise):
        gap = max(float((p.to_local().float() - q.float()).abs().max())
                  for p, q in pairs)
        raise AssertionError(f"[14] (a) sharded step not bit-equal to "
                             f"train_step: losses {losses} against {plain}, "
                             f"params off by {gap:.3g}")
    n_params = sum(q.numel() for _, q in pairs)
    del state, want, pairs, batches
    free_card(dev)
    timed = step_ms[1:]
    return dict(cfg=cfg, n_params=n_params, losses=losses, plain=plain,
                bitwise=bitwise,
                place_s=place_s, step_ms=step_ms,
                mean_ms=statistics.mean(timed) if timed else None,
                plain_ms=statistics.mean(plain_ms[1:]) if timed else None,
                launches=got, batch=batch, seq=seq)


def dist_serve(cfg, dev, mesh, want_tokens, *, batch: int = SERVE_BATCH,
               prompt_len: int = SERVE_PROMPT, max_new: int = SERVE_NEW,
               seed: int = 0) -> dict:
    """(a): ``cfg`` from ``seed`` (phase 5's build: ``model.init`` and the
    engine's ``cast_params``) through ``shard_prefill`` and
    ``max_new - 1`` steps of ``shard_decode_step`` on phase 5's prompts;
    the greedy tokens held against ``want_tokens`` (phase 5's
    ``generate``); the launches counted from 0 around the steps."""
    from repro_torch.distributed import partition
    from repro_torch.serving import serve_step
    free_card(dev)
    t0 = time.perf_counter()
    params = lm.cast_params(lm.init(seed, cfg, device=dev), cfg)
    sync(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)
    max_len = prompt_len + max_new
    prefill, _, _ = serve_step.shard_prefill(cfg, mesh, batch, prompt_len,
                                             max_len=max_len)
    decode, *_ = serve_step.shard_decode_step(cfg, mesh, batch, max_len)
    params = partition.place(params, prefill.param_shardings)
    ops.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    nxt, cache, pos = prefill(params, {"tokens": prompts})
    sync(dev)
    prefill_s = time.perf_counter() - t0
    toks = [nxt.full_tensor()]
    for _ in range(max_new - 1):
        nxt, _, cache = decode(params, cache, nxt, pos)
        pos = pos + 1
        toks.append(nxt.full_tensor())
    sync(dev)
    gen_s = time.perf_counter() - t0
    launches = ops.launch_counts()["selective_scan"]
    got = torch.cat(toks, dim=1).cpu().numpy()
    del params, cache
    free_card(dev)
    if torch.device(dev).type == "cuda" and launches != cfg.n_layers:
        raise AssertionError(f"[14] (a) shard_prefill launched "
                             f"selective_scan {launches} times, not once a "
                             f"layer ({cfg.n_layers})")
    agree = float((got == want_tokens).all(axis=1).mean())
    if agree != 1.0:
        raise AssertionError(f"[14] (a) sharded greedy tokens differ from "
                             f"ServeEngine.generate's: {got[0].tolist()} "
                             f"against {want_tokens[0].tolist()}")
    return dict(cfg=cfg, init_s=init_s, prefill_ms=prefill_s * 1e3,
                gen_s=gen_s, launches=launches, tokens=got, batch=batch,
                prompt_len=prompt_len, max_new=max_new)


def range_runs(seed: int, prefix: bytes, runs: int, rows: int,
               geom: SSTGeometry, dev) -> list:
    """``runs`` sorted runs of ``rows`` entries over one key space (keys
    ``key_of(i)`` with their first bytes replaced by ``prefix``, i below
    ``2 * rows``): later runs shadow earlier versions, a tenth are
    tombstones; each packed by ``build_image`` (a memtable flush) on
    ``dev``."""
    from repro_torch.core import offload
    rng = np.random.default_rng(seed)
    space = [prefix + key_of(i)[len(prefix):] for i in range(2 * rows)]
    images = []
    for r in range(runs):
        ids = rng.choice(len(space), rows, replace=False)
        keys = sorted(space[i] for i in ids)
        kw = np.stack([formats.pack_key_bytes(k, geom.key_bytes)
                       for k in keys])
        is_value = (rng.random(rows) >= 0.1).astype(np.uint32)
        meta = (((np.arange(rows, dtype=np.uint32) + 1 + r * rows) << 1)
                | is_value).astype(np.uint32)
        vals = rng.integers(0, 2**32, (rows, geom.value_words),
                            dtype=np.uint32)
        k, m, v = formats.words_to_tensors([kw, meta, vals], dev)
        images.append(offload.build_image(k, m, v, geom=geom))
    return images


def dist_compact(dev, mesh, *, geom: SSTGeometry = PAPER_GEOM,
                 runs: int = DIST_RUNS, rows: int = DIST_RUN_ROWS) -> dict:
    """(a): one job of ``runs`` runs through ``place_sharded`` and
    ``sharded_compact(sort_mode="device")`` on ``mesh`` (one shard), its
    launches counted from 0; the output held byte for byte against
    ``compaction.compact`` of the same image on ``dev`` and on the CPU."""
    from repro_torch.core import compaction, offload
    img = formats.concat_images(range_runs(14, b"", runs, rows, geom, dev))
    placed = offload.place_sharded(img, mesh, ("data",))
    ops.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    out, stats = offload.sharded_compact(placed, mesh, ("data",), geom=geom,
                                         sort_mode="device")
    sync(dev)
    sharded_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    got = formats.image_to_numpy(formats.SSTImage(
        *(a.to_local() for a in out)))
    alone, st = compaction.compact(img, geom=geom, sort_mode="device")
    same_image(got, formats.image_to_numpy(alone),
               "sharded_compact against compaction.compact on the card")
    cpu, st_cpu = compaction.compact(
        formats.SSTImage(*(a.cpu() for a in img)), geom=geom,
        sort_mode="device")
    same_image(got, formats.image_to_numpy(cpu),
               "sharded_compact on the card against compaction.compact "
               "on the cpu")
    if [tuple(stats[0])] != [tuple(st)] or tuple(st) != tuple(st_cpu):
        raise AssertionError(f"[14] (a) stats {stats} / {st} / {st_cpu}")
    idle = [k for k in DIST_COMPACT_PATH if not launches[k]]
    if torch.device(dev).type == "cuda" and idle:
        raise AssertionError(f"[14] (a) sharded_compact launched no {idle}")
    return dict(rows=runs * rows, stats=stats[0], sharded_s=sharded_s,
                launches={k: launches[k] for k in DIST_COMPACT_PATH})


# the kernels of a sort_mode="device" compaction: phase 1's CRC, phase 2's
# sort, phase 3's prefix, CRC and filters
DIST_COMPACT_PATH = ("crc32_sections", "bitonic_sort", "prefix_encode",
                     "bloom_build")


def _shard_slices(mesh, by_batch: bool, by_chan: bool, batch: int,
                  chan: int):
    """This rank's rows and channels of a region sharded by
    ``annotate.local_placements`` on a ("data", "model") mesh."""
    from repro_torch.distributed import partition
    axes = partition.mesh_axes(mesh)
    coord = dict(zip(axes, mesh.get_coordinate()))
    n_data, n_model = axes["data"], axes["model"]
    rb = batch // n_data if by_batch else batch
    rc = chan // n_model if by_chan else chan
    r0 = coord["data"] * rb if by_batch else 0
    c0 = coord["model"] * rc if by_chan else 0
    return slice(r0, r0 + rb), slice(c0, c0 + rc)


def rank_scan(dev, mesh, *, batch: int = SERVE_BATCH,
              seq: int = SERVE_PROMPT, di: int = 8192, ds: int = 16) -> dict:
    """(b): the scan of DTensors (``ops._selective_scan_dtensor``) on the
    (2, 2) ``mesh``, forward and backward of ``sum(y * dy) + sum(h *
    dh)``, each input placed as the wrapper places it (rows over "data",
    ``d_inner`` over "model"); held against the whole scan on this rank
    (the kernel on the card), slice by slice: ``y``, ``h`` and the
    gradients within ``SCAN_TOL`` of each largest, ``dB`` / ``dC`` /
    ``dA_log`` / ``dD`` after their reduction (a partial sum each).
    Returns the max abs errors, whether each equals bit for bit, and the
    scan's launches in the sharded call."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import annotate
    g = torch.Generator(device=dev)
    g.manual_seed(2031)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    u = normal(batch, seq, di).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(normal(batch, seq, di) - 2.0)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=dev).repeat(di, 1)) \
        + 0.1 * normal(di, ds)
    args = [u, dt, normal(batch, seq, ds), normal(batch, seq, ds), a_log,
            normal(di)]
    dy, dh = normal(batch, seq, di), normal(batch, di, ds)
    whole = [a.clone().requires_grad_() for a in args]
    y, h = ops.selective_scan(*whole)
    want = (y, h) + torch.autograd.grad(
        (y.float() * dy).sum() + (h * dh).sum(), whole)
    on = annotate.plan(mesh, batch, di)

    def pl(*dims, **kw):
        return annotate.local_placements(mesh, *on, *dims, **kw)

    seq_pl, bc_pl, chan_pl, state_pl = pl(0, 2), pl(0, None), pl(None, 0), \
        pl(0, 1)
    placed = [distribute_tensor(a, mesh, p).requires_grad_() for a, p in
              zip(args, (seq_pl, seq_pl, bc_pl, bc_pl, chan_pl, chan_pl))]
    dy_d = distribute_tensor(dy, mesh, seq_pl)
    dh_d = distribute_tensor(dh, mesh, state_pl)
    ops.reset_launch_counts()
    y_d, h_d = ops.selective_scan(*placed)
    loss = ((y_d.float() * dy_d).sum() + (h_d * dh_d).sum()).redistribute(
        mesh, pl(None, None))
    grads = torch.autograd.grad(loss, placed)
    launches = {k: ops.launch_counts()[k]
                for k in ("selective_scan", "selective_scan_bwd")}
    rows, chans = _shard_slices(mesh, *on, batch, di)
    # (the sharded value, the whole one's slice), after each partial
    # gradient's reduction: dB / dC over "model", dA_log / dD over "data"
    got = [(y_d.to_local(), want[0][rows, :, chans]),
           (h_d.to_local(), want[1][rows, chans]),
           (grads[0].to_local(), want[2][rows, :, chans]),
           (grads[1].to_local(), want[3][rows, :, chans]),
           (grads[2].redistribute(mesh, bc_pl).to_local(), want[4][rows]),
           (grads[3].redistribute(mesh, bc_pl).to_local(), want[5][rows]),
           (grads[4].redistribute(mesh, chan_pl).to_local(),
            want[6][chans]),
           (grads[5].redistribute(mesh, chan_pl).to_local(),
            want[7][chans])]
    errs, equal = {}, {}
    for name, (a, w) in zip(("y", "h") + SCAN_GRADS[:6], got):
        a, w = a.detach(), w.detach()
        err = float((a.float() - w.float()).abs().max())
        errs[name], equal[name] = err, bool(torch.equal(bits(a), bits(w)))
        lim = SCAN_TOL * float(w.float().abs().max())
        if a.dtype == torch.bfloat16:
            lim += BF16_ULP * float(w.float().abs().max())
        if not err <= lim:
            raise AssertionError(f"[14] (b) sharded scan {name}: max abs "
                                 f"err {err:.3g}, limit {lim:.3g}")
    return dict(errs=errs, equal=equal, launches=launches,
                local=tuple(y_d.to_local().shape))


def rank_moe(dev, mesh, *, tokens=DIST_MOE_TOKENS,
             cfg_kw: dict | None = None) -> dict:
    """(b): granite-moe-3b-a800m's MoE FFN at full width (fp32; a capacity
    factor of experts / top-k, so neither path drops a token) through
    ``moe_ffn`` under the (2, 2) mesh's annotations (the expert-parallel
    path: two ``all_to_all_single`` over "model"), forward and the
    gradient of ``sum(y ** 2)``, each input placed as the EP path places
    it; held against ``_moe_ffn_dense`` of the whole inputs on this rank,
    slice by slice, within JAX's EP test's tolerances."""
    from torch.distributed.tensor import Partial, Replicate, \
        distribute_tensor

    from repro_torch.distributed import annotate
    cfg = get_config(DIST_MOE).with_(**(cfg_kw or {}))
    cfg = cfg.with_(dtype="float32",
                    capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    g = torch.Generator(device=dev)
    g.manual_seed(2032)
    params = moe.moe_init(g, cfg)
    x = torch.randn((*tokens, cfg.d_model), generator=g, device=dev)
    whole = {k: v.clone().requires_grad_() for k, v in params.items()}
    xw = x.clone().requires_grad_()
    yw, _ = moe._moe_ffn_dense(whole, xw, cfg)
    gw = torch.autograd.grad((yw ** 2).sum(), [xw, *whole.values()])
    by_batch, _ = annotate.plan(mesh, tokens[0])
    rows, _ = _shard_slices(mesh, by_batch, False, tokens[0], 1)
    tp = mesh.mesh.shape[list(mesh.mesh_dim_names).index("model")]
    e_loc = cfg.moe_experts // tp
    experts = slice(mesh.get_local_rank("model") * e_loc,
                    (mesh.get_local_rank("model") + 1) * e_loc)
    x_pl = annotate.local_placements(mesh, by_batch, False, 0)
    w_pl = annotate.local_placements(mesh, False, True, None, 0)
    rep = (Replicate(),) * mesh.ndim
    placed = {k: distribute_tensor(v, mesh, rep if k == "router" else w_pl)
              .requires_grad_() for k, v in params.items()}
    xd = distribute_tensor(x, mesh, x_pl).requires_grad_()
    with annotate.mesh_annotations(mesh), annotate.replicate_plain_tensors():
        y, aux = moe.moe_ffn(placed, xd, cfg)
        loss = (y ** 2).sum().redistribute(mesh, rep)
        grads = torch.autograd.grad(loss, [xd, *placed.values()])
    # reduce each partial gradient, never gathering a shard
    red = []
    for gr, like in zip(grads, [xd, *placed.values()]):
        tgt = tuple(Replicate() if isinstance(p, Partial) else p
                    for p in gr.placements)
        red.append(gr.redistribute(mesh, tgt).to_local())
    got = [(y.to_local(), yw[rows], MOE_FWD_TOL),
           (red[0], gw[0][rows], MOE_GRAD_TOL)]
    for (k, _), r, w in zip(placed.items(), red[1:], gw[1:]):
        got.append((r, w if k == "router" else w[experts], MOE_GRAD_TOL))
    errs = {}
    for name, (a, w, tol) in zip(["y", "dx"] + [f"d{k}" for k in placed],
                                 got):
        diff = (a - w).detach().abs()
        errs[name] = float(diff.max())
        if not bool((diff <= tol + tol * w.abs()).all()):
            raise AssertionError(f"[14] (b) EP MoE {name}: max abs err "
                                 f"{errs[name]:.3g} beyond {tol} + {tol} "
                                 "x |dense|")
    return dict(errs=errs, experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                d_model=cfg.d_model, tokens=tokens)


def rank_compressed(dev, world: int, rank: int) -> dict:
    """(b): the int8 compressed mean over a line of ``world`` ranks,
    within 5 % of the true mean (JAX's test's bound)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import grad_compress
    line = init_device_mesh(torch.device(dev).type, (world,),
                            mesh_dim_names=("data",))
    rng = np.random.default_rng(2033)
    local = rng.standard_normal((world, 1 << 20)).astype(np.float32)
    x = torch.from_numpy(local[rank]).to(dev)
    mean, _ = grad_compress.compressed_grad_mean(
        {"g": x}, grad_compress.init_error_state({"g": x}), line, "data")
    true = local.mean(0)
    rel = float(np.abs(mean["g"].cpu().numpy() - true).max()
                / np.abs(true).max())
    if not rel < 0.05:
        raise AssertionError(f"[14] (b) compressed mean off by {rel:.3g}")
    return dict(rel=rel, n=local.shape[1],
                wire=(grad_compress.wire_bytes_fp32({"g": x}),
                      grad_compress.wire_bytes_compressed({"g": x})))


def dist_rank(rank: int, world: int, sizes: dict) -> dict:
    """(b), on each rank of the gloo world sharing the card: the range
    shards through ``sharded_compact``, then the scan, the EP MoE FFN and
    the compressed mean (``sizes`` scales them down for a rehearsal)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import compaction, offload
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(sizes.get("device", "cuda"))
    geom = sizes.get("geom", PAPER_GEOM)
    runs, rows = sizes.get("runs", DIST_RUNS), sizes.get("rows",
                                                          DIST_RUN_ROWS)
    out = {}
    line = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
    shards = [formats.concat_images(range_runs(
        140 + s, b"%02d" % s, runs, rows, geom, dev)) for s in range(world)]
    placed = offload.place_sharded(formats.concat_images(shards), line,
                                   ("data",))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got, stats = offload.sharded_compact(placed, line, ("data",), geom=geom,
                                         sort_mode="device")
    sync(dev)
    out["compact_s"] = time.perf_counter() - t0
    launches = ops.launch_counts()
    alone, st = compaction.compact(shards[rank], geom=geom,
                                   sort_mode="device")
    same_image(formats.image_to_numpy(formats.SSTImage(
        *(a.to_local() for a in got))), formats.image_to_numpy(alone),
        f"rank {rank}'s shard against the shard compacted alone")
    if tuple(stats[rank]) != tuple(st):
        raise AssertionError(f"[14] (b) rank {rank} stats {stats[rank]} "
                             f"against {st}")
    out["stats"] = [tuple(s) for s in stats]
    mesh = make_host_mesh(device=dev.type)
    out["scan"] = rank_scan(dev, mesh, **sizes.get("scan", {}))
    launches = {k: launches[k] + out["scan"]["launches"].get(k, 0)
                for k in launches}
    out["moe"] = rank_moe(dev, mesh, **sizes.get("moe", {}))
    out["compressed"] = rank_compressed(dev, world, rank)
    out["launches"] = launches
    return out


def dist_phase(dev, want_tokens, *, configs: dict | None = None,
               sizes: dict | None = None, report=None,
               nice: int = 0) -> dict:
    """Phase 14: (a) in a world of this process alone, ``dist_train``,
    ``dist_serve`` and ``dist_compact`` on a (1, 1) mesh; (b)
    ``dist_rank`` on each of ``DIST_RANKS`` ranks sharing the card over
    gloo.  ``launches`` sums the kernel launches of (a)'s three paths and
    of (b)'s ranks, each counted from 0 around its path.  (``configs`` and
    ``sizes`` scale the phase down for a rehearsal, where ``nice`` lowers
    the ranks' priority.)"""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.testing.world import one_rank_world, run_world
    configs = configs or {"train": train_configs()["full"],
                          "serve": get_config(FALCON)}
    sizes = sizes or {}
    report = report or (lambda part, r: None)
    out = {}
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    with one_rank_world("nccl" if on_card else "gloo"):
        mesh = make_host_mesh(device=torch.device(dev).type)
        out["train"] = dist_train(configs["train"], dev, mesh,
                                  **sizes.get("train", {}))
        report("train", out["train"])
        out["serve"] = dist_serve(configs["serve"], dev, mesh, want_tokens,
                                  **sizes.get("serve", {}))
        report("serve", out["serve"])
        out["compact"] = dist_compact(dev, mesh, **sizes.get("compact", {}))
        report("compact", out["compact"])
    out["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_world(dist_rank, DIST_RANKS, dict(sizes.get("ranks", {}),
                                                  device=str(dev)),
                      timeout=DIST_TIMEOUT, nice=nice)
    out["ranks"] = ranks
    out["b_s"] = time.perf_counter() - t0
    report("ranks", out)
    launches = collections.Counter(out["train"]["launches"])
    launches["selective_scan"] += out["serve"]["launches"]
    launches.update(out["compact"]["launches"])
    for r in ranks:
        launches.update(r["launches"])
    out["launches"] = dict(launches)
    return out


def dist_part_lines(part: str, r: dict, card: str) -> list[str]:
    """The phase-14 report of (a)'s train, serve and compact parts, and of
    (b)'s ranks."""
    if part == "train":
        cfg = r["cfg"]
        timed = (f"{r['mean_ms']:.2f} ms a step (CUDA events, mean of steps "
                 f"2-{len(r['step_ms'])}; each "
                 + ", ".join(f"{t:.2f}" for t in r["step_ms"]) + "), "
                 f"train_step's {r['plain_ms']:.2f} ms on the same batches"
                 if r["mean_ms"] else "no device time on the CPU")
        same = "bit for bit equal"   # dist_train raises otherwise
        return [
            f"[14] (a) shard_train_step on a (1, 1) mesh (one-rank NCCL "
            f"world): {cfg.name}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {r['n_params']:,} parameters, {cfg.dtype} "
            f"compute, {r['batch']} x {r['seq']} tokens, {len(r['losses'])} "
            f"steps; placed in {r['place_s']:.2f} s",
            f"[14] (a) step: {timed} [{card}]",
            f"[14] (a) losses " + ", ".join(f"{x!r}" for x in r["losses"])
            + f" against train_step's "
            + ", ".join(f"{x!r}" for x in r["plain"]) + f": {same}; "
            f"launches {r['launches']}"]
    if part == "serve":
        cfg = r["cfg"]
        return [f"[14] (a) shard_prefill / shard_decode_step on (1, 1): "
                f"{cfg.name} whole ({cfg.n_layers} layers), built in "
                f"{r['init_s']:.1f} s; {r['batch']} x {r['prompt_len']} "
                f"prompt tokens, {r['max_new']} new each: greedy tokens "
                f"equal ServeEngine.generate's (phase 5); prefill "
                f"{r['prefill_ms']:.1f} ms, prefill and decode "
                f"{r['gen_s']:.2f} s (host clock after a synchronize) "
                f"[{card}]; selective_scan launches {r['launches']}"]
    if part == "compact":
        st = r["stats"]
        return [f"[14] (a) place_sharded / sharded_compact on (1, 1): "
                f"{r['rows']:,} rows at PAPER.geometry(256), "
                f"sort_mode='device' -> {st[1]:,} live ({st[2]:,} dropped): "
                f"byte-identical to compaction.compact on cuda and on cpu; "
                f"{r['sharded_s'] * 1e3:.1f} ms (host clock) [{card}]; "
                f"launches {r['launches']}"]
    ranks = r["ranks"]
    first = ranks[0]
    scan_err = {k: max(x["scan"]["errs"][k] for x in ranks)
                for k in first["scan"]["errs"]}
    scan_eq = [k for k in first["scan"]["equal"]
               if all(x["scan"]["equal"][k] for x in ranks)]
    moe_err = {k: max(x["moe"]["errs"][k] for x in ranks)
               for k in first["moe"]["errs"]}
    m = first["moe"]
    lines = [
        f"[14] (b) {len(ranks)} ranks sharing the card over gloo: "
        f"sharded_compact of {len(ranks)} range shards "
        f"(stats {first['stats']}): each rank's shard byte-identical to it "
        f"compacted alone; " + ", ".join(
            f"rank {i} {x['compact_s'] * 1e3:.1f} ms"
            for i, x in enumerate(ranks)) + f" (host clock) [{card}]",
        f"[14] (b) the scan's DTensor wrapper on (2, 2), local shard "
        f"{first['scan']['local']}: max abs err against the whole scan "
        + ", ".join(f"{k} {v:.3g}" for k, v in scan_err.items())
        + f" (bit for bit: {', '.join(scan_eq) or 'none'}); launches a "
        f"rank {first['scan']['launches']}",
        f"[14] (b) EP MoE ({DIST_MOE}: d_model {m['d_model']}, "
        f"{m['experts']} experts, top {m['top_k']}, {m['tokens']} tokens, "
        f"fp32) on (2, 2) against the dense path: max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in moe_err.items()),
        f"[14] (b) compressed mean of {first['compressed']['n']:,} fp32 "
        f"over 4 ranks: max rel err "
        f"{max(x['compressed']['rel'] for x in ranks):.4f} (limit 0.05); "
        f"wire bytes fp32 / int8 {first['compressed']['wire']}",
        f"[14] (b) launches by rank "
        + "; ".join(", ".join(f"{k} {v}" for k, v in x["launches"].items()
                              if v) for x in ranks),
        f"[14] (a) {r['a_s']:.1f} s, (b) {r['b_s']:.1f} s"]
    return lines


# ---------------------------------------------------------------------------
# phase 15: the dry run (launch/dryrun.py) against real steps on the card
# ---------------------------------------------------------------------------

DRY_BLOCKS = 2048                    # (c): blocks a shard
DRY_CELL = (FALCON, "decode_32k", False)   # (d): one production cell
DRY_PEAK_RATIO = (0.5, 2.0)          # (a), (b): traced over measured peak
# the kernels of the path: (a)'s train steps, (b)'s prefill, (c)'s job
DRY_PATH = ("selective_scan", "selective_scan_bwd", "crc32_sections",
            "bitonic_sort", "prefix_encode", "bloom_build")


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def measured_step(fn, dev) -> dict:
    """``fn()`` once with its products counted by
    ``torch.utils.flop_counter.FlopCounterMode``, then once timed: CUDA
    events around it and the card's peak allocation above what was
    allocated before it (on the CPU the host clock, and no peak)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    sync(dev)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        ev[1].record()
        ev[1].synchronize()
    ms = ev[0].elapsed_time(ev[1]) if on_card else \
        (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - before if on_card else None
    del out
    return dict(flops=fc.get_total_flops(), ms=ms, peak=peak)


def dry_against(rec: dict, real: dict, arg_bytes: int, what: str) -> dict:
    """Raise unless the dry run's dot FLOPs equal the real step's count and
    its argument bytes the real arguments' bytes, exactly, and unless its
    peak above the arguments lies within ``DRY_PEAK_RATIO`` of the card's
    (where the card measured one).  Returns the comparison."""
    flops = rec["cost"]["flops_per_device"]
    if flops != real["flops"]:
        raise AssertionError(f"[15] {what}: the dry run counts {flops:.6g} "
                             f"dot FLOPs, FlopCounterMode {real['flops']:.6g}")
    m = rec["memory"]
    if m["argument_bytes"] != arg_bytes:
        raise AssertionError(f"[15] {what}: the dry run's argument bytes "
                             f"{m['argument_bytes']}, the real ones "
                             f"{arg_bytes}")
    ratio = None
    if real["peak"] is not None:
        ratio = (m["peak_estimate_bytes"] - m["argument_bytes"]) / \
            real["peak"]
        lo, hi = DRY_PEAK_RATIO
        if not lo <= ratio <= hi:
            raise AssertionError(f"[15] {what}: the traced peak above the "
                                 f"arguments is {ratio:.3f} x the card's")
    return dict(rec=rec, real=real, arg_bytes=arg_bytes, ratio=ratio)


def dry_train(cfg, dev, *, batch: int = TRAIN_BATCH,
              seq: int = TRAIN_SEQ) -> dict:
    """(a): phase 13 (a)'s train step traced by the dry run on a one-rank
    fake world's (1, 1) mesh, then run for real through ``train_step``
    from ``init_state(0)`` on a ``BigramStream`` batch."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.tokens import BigramStream, make_train_batch
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_step as ts
    rec = dryrun.lm_cell(cfg, ShapeSpec("phase-13a", "train", seq, batch),
                         (1, 1), ("data", "model"), dev)
    free_card(dev)
    opt_cfg = optim.AdamWConfig()        # the dry run's: fp32 moments
    state = ts.init_state(0, cfg, opt_cfg, device=dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(
        cfg, BigramStream(cfg.vocab, seed=0), 0, batch, seq).items()}
    arg_bytes = tree_nbytes(state) + tree_nbytes(b)
    real = measured_step(lambda: ts.train_step(state, b, cfg=cfg,
                                               opt_cfg=opt_cfg), dev)
    del state, b
    free_card(dev)
    return dry_against(rec, real, arg_bytes, "(a) the train step")


def dry_prefill(cfg, dev, *, batch: int = SERVE_BATCH,
                prompt_len: int = SERVE_PROMPT, seed: int = 0) -> dict:
    """(b): phase 5's prefill traced by the dry run on a one-rank fake
    world's (1, 1) mesh, then run for real through ``serve_prefill`` with
    the serving params of ``serve_step.abstract_params`` (every fp32 leaf
    of two or more dims in bf16) from ``model.init(seed)``."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.serving import serve_step
    from repro_torch.training.train_step import working_copy
    rec = dryrun.lm_cell(cfg, ShapeSpec("phase-5", "prefill", prompt_len,
                                        batch),
                         (1, 1), ("data", "model"), dev)
    free_card(dev)
    params = working_copy(lm.init(seed, cfg, device=dev), cfg)
    free_card(dev)
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)}
    arg_bytes = tree_nbytes(params) + tree_nbytes(b)
    real = measured_step(lambda: serve_step.serve_prefill(
        params, b, cfg=cfg, max_len=prompt_len), dev)
    del params, b
    free_card(dev)
    return dry_against(rec, real, arg_bytes, "(b) the prefill")


def dry_compaction(dev, *, blocks: int = DRY_BLOCKS) -> dict:
    """(c): the compaction cell at ``blocks`` blocks a shard (one shard run
    on ``dev``), its stats held against the plain versions' on the same
    image (``ops._on_card`` patched to False: the plain versions on the
    same device)."""
    from repro_torch.core import compaction
    rec = dryrun.run_compaction_cell(False, blocks, device=dev)
    img = dryrun.compaction_image(blocks, PAPER_GEOM, 0, dev)
    with mock.patch.object(ops, "_on_card", lambda t: False):
        _, plain = compaction.compact(img, geom=PAPER_GEOM,
                                      sort_mode="device")
    if rec["stats"] != plain._asdict():
        raise AssertionError(f"[15] (c) the cell's stats {rec['stats']}, "
                             f"the plain versions' {plain._asdict()}")
    return dict(rec=rec, plain=plain._asdict())


def dry_phase(dev, *, configs: dict | None = None, sizes: dict | None = None,
              cell=None, report=None) -> dict:
    """Phase 15: (a) ``dry_train``, (b) ``dry_prefill``, (c)
    ``dry_compaction``, (d) ``DRY_CELL``, one production cell of the dry
    run on its 256-rank fake world.  ``launches`` counts the kernels from
    0 around (a)-(c) ((d) launches none).  (``configs``, ``sizes`` and
    ``cell``, a function giving (d)'s record, scale the phase down for a
    rehearsal.)"""
    configs = configs or {"train": train_configs()["full"],
                          "serve": get_config(FALCON)}
    sizes = sizes or {}
    report = report or (lambda part, r: None)
    out = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out["train"] = dry_train(configs["train"], dev, **sizes.get("train", {}))
    report("train", out["train"])
    out["prefill"] = dry_prefill(configs["serve"], dev,
                                 **sizes.get("prefill", {}))
    report("prefill", out["prefill"])
    out["compact"] = dry_compaction(dev, **sizes.get("compact", {}))
    report("compact", out["compact"])
    out["launches"] = ops.launch_counts()
    t1 = time.perf_counter()
    out["cell"] = cell() if cell else dict(
        dryrun.run_lm_cell(*DRY_CELL, device=dev),
        cell=dryrun.cell_name(*DRY_CELL))
    out["cell_s"] = time.perf_counter() - t1
    report("cell", out)
    out["seconds"] = time.perf_counter() - t0
    return out


def roofline_terms(rec: dict) -> str:
    r = rec["roofline"]
    return (f"compute_s {r['compute_s'] * 1e3:.4f} ms, memory_s "
            f"{r['memory_s'] * 1e3:.4f} ms, collective_s "
            f"{r['collective_s'] * 1e3:.4f} ms (dominant "
            f"{r['dominant']})")


def dry_part_lines(part: str, r: dict, card: str) -> list[str]:
    """The phase-15 report of each part."""
    if part in ("train", "prefill"):
        rec, real = r["rec"], r["real"]
        m = rec["memory"]
        tag = "(a) the train step" if part == "train" else "(b) the prefill"
        on_card = real["peak"] is not None
        ratio = f"{r['ratio']:.4f}" if on_card else "not measured (no card)"
        return [
            f"[15] {tag}: traced in {rec['compile_seconds']:.1f} s on a "
            f"one-rank fake world's (1, 1) mesh; dot FLOPs "
            f"{rec['cost']['flops_per_device']:.6g} = FlopCounterMode's "
            f"count of the real step; argument bytes {m['argument_bytes']} "
            f"= the real state's and batch's",
            f"[15] {tag}: peak above the arguments traced "
            f"{m['peak_estimate_bytes'] - m['argument_bytes']} B, on the "
            f"card {real['peak']} B (max_memory_allocated less the bytes "
            f"allocated before): ratio {ratio} (limit {DRY_PEAK_RATIO})",
            f"[15] {tag}: {real['ms']:.2f} ms "
            f"({'CUDA events' if on_card else 'host clock'}) beside the "
            f"roofline's {roofline_terms(rec)}; traffic "
            f"{rec['cost']['bytes_per_device']:.6g} B [{card}]"]
    if part == "compact":
        rec = r["rec"]
        job_s = rec["job_seconds"]
        nbytes = rec["cost"]["bytes_per_device"]
        return [
            f"[15] (c) the compaction cell ({rec['shape']}, one shard of "
            f"{rec['mesh']['devices']}): stats {rec['stats']} = the plain "
            f"versions'; {nbytes:.6g} B of traffic counted; the job run "
            f"again uncounted {job_s * 1e3:.3f} ms (device clock) = "
            f"{nbytes / job_s / 1e9:.2f} GB/s, beside memory_s "
            f"{rec['roofline']['memory_s'] * 1e3:.4f} ms; collectives "
            f"{rec['collectives']['total_bytes']} B; peak "
            f"{rec['memory']['peak_estimate_bytes']} B [{card}]"]
    cell = r["cell"]
    if "error" in cell:
        raise AssertionError(f"[15] (d) {cell['cell']}: {cell['error']}")
    return [f"[15] (d) {cell['cell']}: traced in {r['cell_s']:.1f} s; "
            f"fits {cell['memory']['fits']} (peak "
            f"{cell['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB of "
            f"{h100.HBM_PER_CHIP / 2**30:.2f}); dominant "
            f"{cell['roofline']['dominant']}; {roofline_terms(cell)}"]


def watch_engines():
    """Record every ``TorchCompactionEngine`` built from now on: returns
    the list they are appended to and the patch (``stop()`` ends it)."""
    built: list = []
    real = TorchCompactionEngine.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        built.append(self)

    patch = mock.patch.object(TorchCompactionEngine, "__init__", init)
    patch.start()
    return built, patch


def no_launch_retries(built: list, phase: int) -> str:
    """Fail if an engine of ``built`` retried a launch (no engine
    failpoint is armed before phase 10), then empty ``built``.  Returns the
    phase's report line."""
    retried = [e.launch_retries for e in built if e.launch_retries]
    n = len(built)
    built.clear()
    if retried:
        raise AssertionError(f"[{phase}] launch retries {retried} with no "
                             "engine failpoint armed")
    return f"[{phase}] {n} compaction engines, no launch retry"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    kernels_only = argv == ["--kernels"]
    if argv and not kernels_only:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind}")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    _build.library()
    log(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s)")
    for line in _build.build_log().splitlines():
        if line.startswith("==") or "registers" in line or "stack" in line:
            log(f"    {line.strip()}")

    log("[2] kernels against their plain versions (65,536-row job shapes, "
        "256- and 1,024-candidate read waves)")
    t0 = time.perf_counter()
    checks, sort_rows = check_kernels(dev, card)
    if kernels_only:
        log("[2] row 9b: the selective-scan backward at its two cases")
        check_scan_bwd(dev, card, sm_clock_hz(),
                       bwd_cases(np.random.default_rng(2030), dev))
        return 0
    log(f"[2] the timed cases {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_edges(dev, sort_rows)
    log(f"[2] the edge tables {time.perf_counter() - t0:.1f} s")

    log("[3] store at the paper geometry")
    built, watching = watch_engines()
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    try:
        ops.reset_launch_counts()
        st = run_store(os.path.join(work, "db"), device=dev, geom=PAPER_GEOM,
                       sched=PAPER_SCHED, records=330_000,
                       operations=20_000, deletes=2_000, value_size=256,
                       batch=1_000, sample=20_000, scan_keys=5_000,
                       mg_batches=32, keep_dir=os.path.join(work, "job"))
        log(f"[3] load {st['load_s']:.1f} s, ycsb+deletes+compact "
            f"{st['ops_s']:.1f} s; {st['flushes']} flushes, "
            f"{st['compactions']} compactions ({st['l0_jobs']} L0->L1, each "
            f">= {st['l0_min_inputs']} inputs; {st['l1_jobs']} L1->L2), "
            f"{st['trivial_moves']} trivial moves; levels {st['levels']}")
        log(f"[3] compacted {st['bytes_in']} B in -> {st['bytes_out']} B "
            f"out ({st['dropped']} entries dropped); device "
            f"{st['device_s']:.4f} s (phase 2 {st['sort_s']:.4f} s), host "
            f"{st['host_s']:.2f} s")
        for op, (p50, p99, p999) in st["latency_us"].items():
            log(f"[3] {op} latency p50 {p50:.1f} us, p99 {p99:.1f} us, "
                f"p99.9 {p999:.1f} us (host clock)")
        log(f"[3] {st['checked']} reads and a {st['scan_rows']}-row scan "
            f"agree before and after reopen")
        for when, m in st["multi_get"].items():
            log(multi_get_line(when, m))
        for when, tr in st["mg_trace"].items():
            log(f"[3] one multi_get batch traced ({when} block cache): "
                f"{tr['waves']} waves, launches {tr['launched']}, "
                f"{tr['copies']} tensor copies (one over and one back a "
                f"stage), no other kernel; device events (CUPTI) "
                f"{tr['kinds']} [{card}]")
        log(f"[3] launches {st['launches']}")
        log(merge_jobs_line(st["jobs_seen"], card))
        if st["l0_jobs"] < 4 or st["l0_min_inputs"] < 4:
            raise AssertionError("expected >= 4 L0->L1 compactions of >= 4 "
                                 "inputs each")
        if st["l1_jobs"] < 1:
            raise AssertionError("expected >= 1 L1->L2 compaction")
        idle = [k for k in STORE_PATH if st["launches"][k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched on the store's "
                                 f"paths: {idle}")
        log(no_launch_retries(built, 3))

        log(f"[3] {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        log("[4] one real L0->L1 job on cuda (merge and device sort) and on "
            "cpu")
        live, job_launches = compare_job(st["kept"], PAPER_GEOM, dev)
        log(f"[4] {len(st['kept']['paths'])} input SSTs -> {live} live "
            "entries: output images byte-identical (merge cuda = cpu; "
            "device sort = merge = the numpy baseline, padding trimmed); "
            f"device-sort launches {job_launches}")
        if job_launches["bitonic_sort"] == 0 or job_launches["merge_runs"]:
            raise AssertionError("the sort_mode=\"device\" job made "
                                 f"launches {job_launches}")
        launches_by_mode = {}
        for mode in ("merge", "device"):
            jb = job_breakdown(st["kept"], PAPER_GEOM, dev, sort_mode=mode)
            log(breakdown_line(jb, card, mode))
            launches_by_mode[mode] = (jb["pytorch_launches"],
                                      jb["split"].get(PYTORCH, 0.0))
            if jb["split"].get("crc32_sections", 0.0) <= 0:
                raise AssertionError("the traced job ran no crc32_sections")
            check_pinned(jb)
            sort_kernel, other = (("merge_runs", "bitonic_sort")
                                  if mode == "merge" else
                                  ("bitonic_sort", "merge_runs"))
            if jb["split"].get(sort_kernel, 0.0) <= 0 or other in jb["split"]:
                raise AssertionError(f"the traced {mode} job's kernels: "
                                     f"{jb['split']}")
        jb = job_breakdown(st["kept"], PAPER_GEOM, dev, two_lines=True)
        two_lines = round(checks["prefix_encode/before"]["events"]) - 1
        n_wire, ms_wire = launches_by_mode["merge"]
        log(f"[4] the same job (sort_mode='merge') with the pack's prefix "
            f"step as its two PyTorch lines again (prefix_two_lines): "
            f"{jb['pytorch_launches']} PyTorch kernel launches, "
            f"{jb['pytorch_launches'] - n_wire} more than the wire route's "
            f"{n_wire} (expected {two_lines + 2}: the two lines' "
            f"{two_lines} kernels in phase 2, and the arange and compare of "
            f"the rebuilt mask; CUPTI may drop a few events), "
            f"{jb['split'].get(PYTORCH, 0.0):.4f} ms in PyTorch kernels "
            f"(the wire route's {ms_wire:.4f}); {jb['total_ms']:.4f} ms of "
            f"device time [{card}]")
        log(no_launch_retries(built, 4))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[4] {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    cfg = get_config(FALCON)
    log(f"[5] serve {FALCON} at full width: d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, ssm_state {cfg.ssm_state}, dt_rank {cfg.dt_rank}, "
        f"{cfg.n_layers} layers, vocab {cfg.vocab} padded to "
        f"{lm.padded_vocab(cfg)}; {cfg.dtype} compute, fp32 scan")
    clock_hz = sm_clock_hz()
    scans = check_scan(dev, card, clock_hz, scan_cases(
        np.random.default_rng(2026), dev, di=cfg.d_inner, ds=cfg.ssm_state))
    checks.update(scans)
    sv = serve_phase(cfg, dev, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                     max_new=SERVE_NEW)
    log(f"[5] {sv['n_params']:,} parameters (config count "
        f"{cfg.param_count():,}; the embedding and head cover the padded "
        f"vocab), built in {sv['init_s']:.1f} s; the engine holds "
        f"{sv['card_bytes'] / 1e9:.2f} GB on the card (the mixers' matrices "
        f"and the embedding in {cfg.dtype}, the rest fp32), "
        f"{sv['allocated'] / 1e9:.2f} GB allocated after the build, peak "
        f"{sv['peak'] / 1e9:.2f} GB (the fp32 init and the cast copy)")
    prefills = 1
    n_scan = sv["launches"]["selective_scan"]
    log(f"[5] generate: {SERVE_BATCH} requests x {SERVE_PROMPT} prompt "
        f"tokens, {SERVE_NEW} new tokens each in {sv['gen_s'] * 1e3:.1f} ms "
        f"= {sv['tokens_per_s']:.1f} tokens/s (captured decode); prefill "
        f"{sv['prefill_ms']:.1f} ms (host clock after a synchronize, median "
        f"of 3) [{card}]; selective_scan launches {n_scan} for {prefills} "
        f"prefill of {cfg.n_layers} layers")
    for how, ms in (("eager (model.decode_step)", sv["decode_ms"]),
                    ("captured (ServeEngine._decode, one CUDA graph)",
                     sv["captured_ms"])):
        log(f"[5] decode {how}: {ms:.2f} ms a step of {SERVE_BATCH} "
            f"requests = {SERVE_BATCH / ms * 1e3:.1f} tokens/s (host clock "
            f"after a synchronize, median of {SERVE_NEW - 1}) [{card}]")
    log(f"[5] captured against eager decode: greedy tokens equal; last "
        f"logits and cache "
        + ("bit for bit equal" if sv["captured_bitwise"] else
           f"differ, last logits by {sv['captured_logits_gap']:.3g} of the "
           f"largest |logit| (limit {LOGIT_TOL})"))
    first = sv["tokens"][0].tolist()
    log(f"[5] req0 tokens {first}")
    if n_scan != cfg.n_layers * prefills:
        raise AssertionError(f"selective_scan launched {n_scan} times, not "
                             f"{cfg.n_layers} x {prefills} prefill")
    if not ((sv["tokens"] >= 0) & (sv["tokens"] < lm.padded_vocab(cfg))
            ).all():
        raise AssertionError("generated tokens outside the padded vocab")
    total, scan_ms = sv["prefill_device"]
    log(f"[5] one prefill: {total:.2f} ms of device time, of it "
        f"{scan_ms:.2f} ms in selective_scan ({scan_ms / total:.1%}) "
        f"[{card}]")
    for what, (ratio, agree) in (
            (f"prefill of {SERVE_PROMPT - 1} + decode of token "
             f"{SERVE_PROMPT} vs prefill of {SERVE_PROMPT}", sv["decode_gap"]),
            ("prefill with the kernel vs with the plain scan",
             sv["plain_gap"])):
        log(f"[5] {what}: last logits max abs diff {ratio:.3g} of the "
            f"largest |logit| (limit {LOGIT_TOL}); greedy tokens agree in "
            f"{agree:.0%} of requests")
        if not ratio <= LOGIT_TOL:
            raise AssertionError(f"{what}: last logits differ by {ratio:.3g}"
                                 f" of their largest magnitude")
    log(f"[5] {time.perf_counter() - t_phase:.1f} s")

    log(f"[6] the paper's evaluation: YCSB-A at PAPER.geometry(v), "
        f"v = {', '.join(map(str, PAPER.value_sizes))} B, LUDA (cuda) "
        "against the CPU baseline (numpy, threads=1, device cpu)")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    host = host_line()
    t0 = time.perf_counter()
    try:
        rows = paper_phase(work, dev, memtables=PAPER_MEMTABLES,
                           report=lambda r: log(
                               paper_row_line(r, card, host)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for luda, base in zip(rows[::2], rows[1::2]):
        log(paper_ratio_line(luda, base, card, host))
    log(f"[6] every read and a full scan of each store agree with the "
        f"acknowledged writes; both stores wrote the same SST files; the "
        f"baseline launched no kernel; {time.perf_counter() - t0:.1f} s")
    log(no_launch_retries(built, 6))

    log(f"[7] the served session through the store on the card: "
        f"{FALCON}'s (cache, pos) of phase 5's batch into an LsmDB at the "
        f"serving launcher's geometry (16 B keys, {SESSION_GEOM.value_bytes} "
        f"B values, {SESSION_GEOM.block_bytes} B blocks, "
        f"{SESSION_GEOM.sst_bytes} B SSTs, a 256 KiB memtable)")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    try:
        ss = session_phase(sv["engine"], sv["prompts"], work)
        xd = cross_device_pages(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    served = (sv["engine"], sv["prompts"])   # phases 9 (f), 11 (d) serve
    served_tokens = sv["tokens"]             # phase 14 (a) serves again
    del sv
    log(session_lines(ss, xd, card))
    log(no_launch_retries(built, 7))
    log(f"[7] {time.perf_counter() - t0:.1f} s")

    log(f"[8] the sharded store on the card: a ShardedDB of {SHARDS} shards "
        f"at PAPER.geometry({SHARD_VALUE}) and PAPER.scheduler(), one engine "
        f"and one compaction queue for all of them")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    try:
        sh = sharded_phase(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(sharded_lines(sh, card))
    idle = [k for k in STORE_PATH if not sh["launches"][k]]
    if idle:
        raise AssertionError(f"kernels not launched on the sharded store's "
                             f"paths: {idle}")
    log(no_launch_retries(built, 8))
    log(f"[8] {time.perf_counter() - t0:.1f} s")

    log(f"[9] the async write path on the card: LsmDB and ShardedDB with "
        f"async_compaction=True at PAPER.geometry({ASYNC_VALUE}) and "
        f"PAPER.scheduler(), against sync stores on the same streams")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    try:
        p9 = async_phase(work, dev, *served, report=lambda part, r: log(
            "\n".join(async_part_lines(part, r, card))))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    idle = [k for k in STORE_PATH if not p9["launches"][k]]
    if idle:
        raise AssertionError(f"kernels not launched on the async store's "
                             f"paths: {idle}")
    log(f"[9] launches (a)-(f): " + ", ".join(
        f"{k} {p9['launches'][k]}" for k in KERNELS))
    log(no_launch_retries(built, 9))
    watching.stop()   # phase 10 checks its engines part by part
    log(f"[9] {time.perf_counter() - t0:.1f} s")

    log(f"[10] the store's fault paths on the card: the crash-consistency "
        f"matrix and the injected faults on the LUDA store at the default "
        f"SSTGeometry (16 B keys, 256 B values, 4 KB blocks), 640 B "
        f"memtables, {FAULT_N} operations a matrix cell")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    try:
        p10 = fault_phase(work, dev, report=lambda part, r: log(
            "\n".join(fault_part_lines(part, r, card))))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    idle = [k for k in STORE_PATH if not p10["a"]["launched"][k]]
    if idle:
        raise AssertionError(f"kernels not launched in the crash matrix: "
                             f"{idle}")
    log(f"[10] launches (a)-(f): " + ", ".join(
        f"{k} {p10['launches'][k]}" for k in KERNELS))
    log(f"[10] {time.perf_counter() - t0:.1f} s")

    log(f"[11] metrics and tracing on the card: a registry and a tracer "
        f"through a sync, an async and a sharded store at "
        f"PAPER.geometry({OBS_VALUE}) and the served engine's page store; "
        f"the launch spans' phases timed by CUDA events")
    built, watching = watch_engines()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    try:
        p11 = obs_phase(work, dev, *served, report=lambda part, r: log(
            "\n".join(obs_part_lines(part, r, card))))
    finally:
        watching.stop()
        shutil.rmtree(work, ignore_errors=True)
    del served
    idle = [k for k in STORE_PATH if not p11["launches"][k]]
    if idle:
        raise AssertionError(f"kernels not launched in phase 11: {idle}")
    log(f"[11] launches (a)-(d): " + ", ".join(
        f"{k} {p11['launches'][k]}" for k in KERNELS))
    log(no_launch_retries(built, 11))
    log(f"[11] {time.perf_counter() - t0:.1f} s")
    free_card(dev)

    log("[12] the attention, MoE and encoder-decoder archs on the card: "
        f"{GEMMA} and {GRANITE_MOE} served at full width and depth, the "
        "ring wrap, card against CPU at fp32, every other arch once, a "
        f"{GEMMA} session through the store; random weights from a seed, "
        "bf16 compute")
    built, watching = watch_engines()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    try:
        p12 = archs_phase(work, dev, report=lambda part, r: log(
            "\n".join(archs_part_lines(part, r, card))))
    finally:
        watching.stop()
        shutil.rmtree(work, ignore_errors=True)
    log(f"[12] launches (d), (e): " + ", ".join(
        f"{k} {p12['launches'].get(k, 0)}" for k in KERNELS))
    log(no_launch_retries(built, 12))
    log(f"[12] {time.perf_counter() - t0:.1f} s")
    free_card(dev)

    log(f"[13] training on the card: {FALCON} at full width cut to "
        f"{TRAIN_LAYERS} layers, then cut to {CKPT_LAYERS} layers and "
        f"d_model {CKPT_D_MODEL} through the LUDA checkpoint store with a "
        "failure and a restart, then the launcher; the selective-scan "
        "backward kernel against the plain backward")
    t0 = time.perf_counter()
    checks.update(check_scan_bwd(dev, card, clock_hz, bwd_cases(
        np.random.default_rng(2030), dev, di=cfg.d_inner,
        ds=cfg.ssm_state)))
    t1 = time.perf_counter()
    n = check_scan_bwd_edges(dev)
    log(f"  selective_scan_bwd at its edges: {n} cases within {SCAN_TOL} of "
        "each largest (a bf16 du one ulp more), two runs equal bit for bit, "
        "one launch a call (S = 1 to 1,000: one-step and ragged last "
        "segments, segments of 1 to 63 chunks; d_inner 64 to 8,192, off the "
        "64-channel block; ds 1 to 16; bf16 and fp32 u; h0 and dh_last on "
        f"and off) ({time.perf_counter() - t1:.1f} s)")
    built, watching = watch_engines()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    try:
        p13 = train_phase(work, dev, report=lambda part, r: log(
            "\n".join(train_part_lines(part, r, card))))
    finally:
        watching.stop()
        shutil.rmtree(work, ignore_errors=True)
    idle = [k for k in WRITE_PATH + ("selective_scan", "selective_scan_bwd")
            if not p13["launches"].get(k)]
    if idle:
        raise AssertionError(f"kernels not launched in phase 13: {idle}")
    log(f"[13] launches (a), (b): " + ", ".join(
        f"{k} {p13['launches'].get(k, 0)}" for k in KERNELS))
    log(no_launch_retries(built, 13))
    log(f"[13] {time.perf_counter() - t0:.1f} s")
    free_card(dev)

    log(f"[14] the distributed layer on the card: (a) a one-rank NCCL "
        f"world, (1, 1) mesh: shard_train_step on phase 13 (a)'s model, "
        f"{FALCON} served by shard_prefill / shard_decode_step, one job "
        f"through sharded_compact; (b) {DIST_RANKS} ranks sharing the card "
        "over gloo: range-sharded compaction, the scan's DTensor wrapper, "
        "EP MoE and the compressed mean on (2, 2) and a line of 4")
    t0 = time.perf_counter()
    p14 = dist_phase(dev, served_tokens, report=lambda part, r: log(
        "\n".join(dist_part_lines(part, r, card))))
    idle = [k for k in DIST_COMPACT_PATH + ("selective_scan",
                                            "selective_scan_bwd")
            if not p14["launches"].get(k)]
    if idle:
        raise AssertionError(f"kernels not launched in phase 14: {idle}")
    log(f"[14] (a) the sharded step {p14['train']['mean_ms']:.2f} ms "
        f"against phase 13 (a)'s train_step {p13['a']['mean_ms']:.2f} ms "
        f"(this run, CUDA events) [{card}]")
    log(f"[14] launches (a), (b): " + ", ".join(
        f"{k} {p14['launches'].get(k, 0)}" for k in KERNELS))
    log(f"[14] {time.perf_counter() - t0:.1f} s")
    free_card(dev)

    log(f"[15] the dry run (launch/dryrun.py) against real steps on the "
        f"card: (a) phase 13 (a)'s train step and (b) phase 5's prefill, "
        f"each traced on a one-rank fake world's (1, 1) mesh and run; (c) "
        f"the compaction cell at {DRY_BLOCKS} blocks a shard; (d) "
        f"{dryrun.cell_name(*DRY_CELL)} on its 256-rank fake world")
    p15 = dry_phase(dev, report=lambda part, r: log(
        "\n".join(dry_part_lines(part, r, card))))
    idle = [k for k in DRY_PATH if not p15["launches"].get(k)]
    if idle:
        raise AssertionError(f"kernels not launched in phase 15: {idle}")
    log(f"[15] launches (a)-(c): " + ", ".join(
        f"{k} {p15['launches'].get(k, 0)}" for k in KERNELS))
    log(f"[15] {p15['seconds']:.1f} s")

    # the main paths: phase 3's store (with phase 4's device sort and
    # phase 5's prefill), phase 9's async stores, phase 10's faults,
    # phase 11's instrumented stores, phase 12's archs, phase 13's
    # training, phase 14's distributed layer and phase 15's dry run
    path_launches = dict(st["launches"],
                         bitonic_sort=job_launches["bitonic_sort"],
                         selective_scan=n_scan)
    kernels = []
    for name, (entry, case, source, replaces) in KERNELS.items():
        r = checks[case]
        by_path = {"store": path_launches.get(entry, 0),
                   "async": p9["launches"].get(entry, 0),
                   "faults": p10["launches"].get(entry, 0),
                   "obs": p11["launches"].get(entry, 0),
                   "archs": p12["launches"].get(entry, 0),
                   "train": p13["launches"].get(entry, 0),
                   "distributed": p14["launches"].get(entry, 0),
                   "dryrun": p15["launches"].get(entry, 0)}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            call_ms=r["call_ms"], plain_call_ms=r["plain_call_ms"]))
    for case in ("merge_runs/262144", f"merge_runs/{BATCH_JOBS}x65536",
                 f"prefix_encode/wire{BATCH_JOBS}", "bitonic_sort/262144",
                 "bloom_multi_probe/1024", "lookup_blocks/1024",
                 "selective_scan/1x4096", "selective_scan_bwd/1x4096"):
        big = checks[case]
        log(f"{case}: device time kernel {big['ms']:.4f} ms, plain "
            f"{big['plain_ms']:.4f} ms, bound {big['bound_ms']:.4f} ms; one "
            f"call {big['call_ms']:.4f} ms")
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
