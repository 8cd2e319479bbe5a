"""Batched compaction on the CPU (ROADMAP A7): the port's
``CompactionExecutor.compact_many`` against the JAX package's
``compact_many`` and against the port's own per-job ``compact``, bit for
bit; the batched plain versions of the merge and the pack's prefix step
against the single-job ones; ``batch_signature``; and the engine's
grouping, counters and per-job CRC verdicts.

The same seeded host images (built by the port's engine on the CPU, which
the store tests hold byte-identical to JAX's) go through both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import offload as joffload
from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import batch_signature as jax_signature
from repro_torch.core import formats, offload
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import batch_signature
from repro_torch.kernels import ops, ref
from repro_torch.lsm import sstable
from repro_torch.lsm.engine import TorchCompactionEngine

# tests/test_sharded.py's geometry: 16 entries a block
GEOM = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
G = SSTGeometry(**GEOM)
PAD_BLOCKS = 8     # two runs of 2 blocks, padded: a trailing padding run


def host_sst(rng, prefix: bytes, n: int):
    """A host image of ``n`` sorted entries: values and tombstones of
    random sequence numbers, keys drawn from a range other jobs share."""
    keys = sorted(prefix + b"k%04d" % int(x)
                  for x in rng.choice(60, n, replace=False))
    karr = np.stack([formats.pack_key_bytes(k, G.key_bytes) for k in keys])
    meta = np.array([formats.make_meta(int(s), int(v)) for s, v in zip(
        rng.integers(1, 10_000, n), rng.random(n) < 0.8)], np.uint32)
    vals = np.stack([formats.pack_value_bytes(b"v%d" % int(x), G.value_bytes)
                     for x in rng.integers(0, 10**6, n)])
    return TorchCompactionEngine(G, device="cpu").build_image(karr, meta,
                                                              vals)


def job_images(seed: int, jobs: int):
    """``jobs`` jobs of two input SSTs (17-32 entries: 2 blocks each)."""
    rng = np.random.default_rng(seed)
    return [[host_sst(rng, b"a", int(rng.integers(17, 33))),
             host_sst(rng, b"a", int(rng.integers(17, 33)))]
            for _ in range(jobs)]


def port_images(job):
    return [formats.image_from_numpy(im, "cpu") for im in job]


def jax_images(job):
    return [jformats.SSTImage(*(jnp.asarray(a) for a in im)) for im in job]


def assert_image_equal(port_img, want):
    got = formats.image_to_numpy(port_img)
    for name, a, b in zip(formats.SSTImage._fields, got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def stats_tuple(s):
    return tuple(int(x) for x in s)


@pytest.mark.parametrize("sort_mode", ["merge", "device"])
@pytest.mark.parametrize("jobs", [1, 2, 5])
def test_compact_many_equals_jax_and_each_job_alone(sort_mode, jobs):
    host = job_images(jobs, jobs)
    bottom = jobs == 2
    ex = offload.CompactionExecutor(G, device="cpu", sort_mode=sort_mode)
    got = ex.compact_many([port_images(j) for j in host],
                          bottom_level=bottom, pad_blocks=PAD_BLOCKS)
    want = joffload.CompactionExecutor(
        JGeometry(**GEOM), sort_mode=sort_mode).compact_many(
        [jax_images(j) for j in host], bottom_level=bottom,
        pad_blocks=PAD_BLOCKS)
    assert len(got) == len(want) == jobs
    for job, (img, st), (jimg, jst) in zip(host, got, want):
        assert_image_equal(img, jimg)
        assert stats_tuple(st) == stats_tuple(jst)
        alone, ast = ex.compact(port_images(job), bottom_level=bottom,
                                pad_blocks=PAD_BLOCKS)
        assert all(torch.equal(a, b) for a, b in zip(img, alone))
        assert st == ast
    # the padding made a trailing run, and the jobs kept entries
    assert all(st.n_live > 0 and st.crc_ok for _, st in got)


def _raises(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", ["runs", "blocks", "empty"])
def test_compact_many_refuses_mismatched_jobs_as_jax(case):
    rng = np.random.default_rng(9)
    if case == "runs":   # 2 + 2 blocks against 1 + 3: same total
        host = [[host_sst(rng, b"a", 20), host_sst(rng, b"a", 20)],
                [host_sst(rng, b"a", 10), host_sst(rng, b"a", 40)]]
        kw = dict(sort_mode="merge")
    elif case == "blocks":
        host = [[host_sst(rng, b"a", 20)], [host_sst(rng, b"a", 40)]]
        kw = dict(sort_mode="device")
    else:
        host = []
        kw = dict(sort_mode="merge")
    got = _raises(lambda: offload.CompactionExecutor(
        G, device="cpu", **kw).compact_many([port_images(j) for j in host]))
    want = _raises(lambda: joffload.CompactionExecutor(
        JGeometry(**GEOM), **kw).compact_many([jax_images(j) for j in host]))
    assert got == want
    assert got[0] is (AssertionError if case == "empty" else ValueError)


@pytest.mark.parametrize("blocks,bottom,mode", [
    ([1, 1], False, "merge"), ([3, 2, 9], True, "merge"), ([5], False,
                                                           "merge"),
    ([3, 2, 9], True, "device"), ([1, 4], False, "xla"), ([], False,
                                                          "merge")])
def test_batch_signature_is_jax(blocks, bottom, mode):
    assert batch_signature(blocks, bottom, sort_mode=mode) == \
        jax_signature(blocks, bottom, sort_mode=mode)


def write_jobs(tmp_path, host):
    """Each job's inputs as SST files: ``[(paths, bottom_level)]``."""
    jobs, no = [], 0
    for job in host:
        paths = []
        for im in job:
            no += 1
            p = str(tmp_path / f"{no:06d}.sst")
            sstable.write_sst(p, im, no)
            paths.append(p)
        jobs.append((paths, False))
    return jobs


def test_engine_compact_many_groups_by_signature(tmp_path):
    """Two jobs of one signature ride one stacked launch, a bigger job
    takes the single-job path; each result equals ``compact_paths`` of
    its job alone, in input order."""
    rng = np.random.default_rng(3)
    host = job_images(3, 2) + [[host_sst(rng, b"a", 60),
                                host_sst(rng, b"a", 55)]]
    jobs = write_jobs(tmp_path, host)
    eng = TorchCompactionEngine(G, device="cpu")
    alone = [eng.compact_paths(p, bottom_level=b) for p, b in jobs]
    assert eng.batch_launches == 0
    got = eng.compact_many(jobs)
    assert (eng.batch_launches, eng.batch_jobs, eng.max_batch_jobs) == \
        (1, 2, 2)
    assert [es.batched for _, es in got] == [True, True, False]
    for (img, es), (want, wes) in zip(got, alone):
        for name, a, b in zip(formats.SSTImage._fields, img, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert (es.n_input, es.n_live, es.n_dropped, es.crc_ok,
                es.bytes_in, es.bytes_out) == \
            (wes.n_input, wes.n_live, wes.n_dropped, wes.crc_ok,
             wes.bytes_in, wes.bytes_out)
        assert es.device_seconds == 0.0   # no device time on the CPU
    eng.close()


def test_engine_compact_many_isolates_crc_verdicts(tmp_path):
    """A corrupt input fails its own job only; the batch mates verify."""
    host = job_images(5, 3)
    jobs = write_jobs(tmp_path, host)
    bad = jobs[1][0][0]
    img = sstable.read_sst(bad)
    vals = np.asarray(img.vals).copy()
    vals[0, 0, 0] ^= 1        # the file CRC is rewritten, the block's not
    sstable.write_sst(bad, img._replace(vals=vals),
                      int(os.path.basename(bad).split(".")[0]))
    eng = TorchCompactionEngine(G, device="cpu")
    results = eng.compact_many(jobs)
    assert [es.crc_ok for _, es in results] == [True, False, True]
    assert eng.max_batch_jobs == 3   # they rode one launch
    eng.close()


@pytest.mark.parametrize("jobs,run_lens", [
    (1, (64, 32, 32)), (3, (48, 0, 80)), (4, (128,)), (2, (0, 96, 0, 32)),
    (5, (16, 16, 16, 16, 64))])
def test_batched_plain_merge_is_each_job_alone(jobs, run_lens):
    rng = np.random.default_rng(sum(run_lens) + jobs)
    n = sum(run_lens)
    rows = []
    for _ in range(jobs):
        parts = []
        for ln in run_lens:
            r = rng.integers(0, 5, (ln, 3)).astype(np.uint32)
            r = r[np.lexsort((r[:, 2], r[:, 1], r[:, 0]))]
            parts.append(r)
        rows.append(np.concatenate(parts) if parts else
                    np.zeros((0, 3), np.uint32))
    t = torch.from_numpy(np.stack(rows).view(np.int32))
    want = torch.stack([ref.merge_runs(r, run_lens) for r in t])
    assert torch.equal(ref.merge_runs_batched(t, run_lens), want)
    assert torch.equal(ops.merge_runs(t, run_lens), want)
    assert torch.equal(ops.bitonic_sort(t), torch.stack(
        [ref.sort_tuples(r) for r in t]))
    assert t.shape == (jobs, n, 3)


@pytest.mark.parametrize("jobs,n,lanes,restart", [
    (1, 64, 4, 16), (3, 48, 2, 16), (5, 96, 5, 12), (2, 32, 1, 16)])
def test_batched_plain_prefix_step_is_each_job_alone(jobs, n, lanes,
                                                     restart):
    rng = np.random.default_rng(n * lanes + jobs)
    keys = []
    for _ in range(jobs):
        k = rng.integers(0, 3, (n, lanes)).astype(np.uint32) * 0x01010101
        keys.append(k[np.lexsort(tuple(k[:, i]
                                       for i in reversed(range(lanes))))])
    t = torch.from_numpy(np.stack(keys).view(np.int32))
    # per-job survivors: none, all, and in between
    counts = torch.tensor([0, n, n // 2, 1, restart][:jobs],
                          dtype=torch.int64)
    shared, wire = ref.prefix_encode_wire_batched(
        t, counts, restart_interval=restart)
    got = ops.prefix_encode_wire(t, counts, restart_interval=restart)
    for j in range(jobs):
        s1, w1 = ref.prefix_encode_wire(t[j], counts[j],
                                        restart_interval=restart)
        assert torch.equal(shared[j], s1) and torch.equal(wire[j], w1)
        assert torch.equal(got[0][j], s1) and torch.equal(got[1][j], w1)
