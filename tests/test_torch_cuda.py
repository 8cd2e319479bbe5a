"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where no CUDA device
is present; on a machine with an H100 (which has no JAX, so this file
imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import offload
from repro_torch.core.formats import SSTGeometry
from repro_torch.kernels import bitonic_sort as sort_plan
from repro_torch.kernels import merge_path, ops, ref

pytestmark = pytest.mark.cuda

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)   # the kernels' edge cases


@pytest.fixture
def dev():
    """The card, or a skip where there is none (decided per test, never at
    import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def words(rng, shape, dev) -> torch.Tensor:
    a = rng.integers(0, 2**32, shape, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


def sorted_rows(rng, n, lanes, dev, distinct=8) -> torch.Tensor:
    r = rng.integers(0, distinct, (n, lanes)).astype(np.uint32)
    r[:, -1] = rng.integers(0, 2**32, n, dtype=np.uint32)
    r = r[np.lexsort(tuple(r[:, i] for i in reversed(range(lanes))))]
    return torch.from_numpy(r.view(np.int32)).to(dev)


def one_launch(name, fn):
    """``fn()``, asserting it made one launch of ``name`` and no other."""
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {name: 1}
    return out


@pytest.mark.parametrize("widths,rows,flip", [
    ((1, 64, 16, 1088, 16), 4096, False), ((3,), 5, False),
    ((7, 300), 33, False),
    # 1 to 5 sections, widths that are not whole runs (39 words a lane at
    # the paper width, 32 lanes a chunk), one word, one row, several chunks
    ((1,), 7, False), ((1185,), 1, False), ((40, 1), 9, False),
    ((5, 33, 2), 64, False), ((1, 64, 16, 1088), 100, False),
    ((1, 64, 16, 2176, 16), 300, False), ((1249,), 17, False),
    ((1, 64, 16, 1088, 16), 257, True), ((1,), 3, True)])
def test_crc32_sections(dev, widths, rows, flip):
    """The segmented kernel against the plain version, bit for bit; with
    ``flip``, one flipped bit changes that row's CRC and no other."""
    rng = np.random.default_rng(rows + sum(widths))
    secs = [words(rng, (rows, w), dev) for w in widths]
    before = ops.launch_counts()["crc32_sections"]
    got = ops.crc32_sections(secs)
    assert torch.equal(got, ref.crc32_words_sections(secs))
    assert ops.launch_counts()["crc32_sections"] == before + 1
    if flip:
        r, sec = rows // 2, len(widths) - 1
        secs[sec][r, widths[sec] // 2] ^= 1 << 13
        flipped = ops.crc32_sections(secs)
        assert torch.equal(flipped, ref.crc32_words_sections(secs))
        assert (flipped != got).nonzero().flatten().tolist() == [r]


@pytest.mark.parametrize("n,lanes,restart", [(65_536, 4, 16), (96, 2, 8)])
def test_prefix_encode(dev, n, lanes, restart):
    keys = sorted_rows(np.random.default_rng(n), n, lanes, dev, distinct=3)
    assert torch.equal(ops.prefix_encode(keys, restart_interval=restart),
                       ref.prefix_encode(keys, restart_interval=restart))


@pytest.mark.parametrize("n,lanes,restart", chip_smoke.PREFIX_EDGES,
                         ids=str)
def test_prefix_encode_edges(dev, n, lanes, restart):
    """Both routes at the edge table: lanes 1 to 10 (16-byte loads at 4 and
    8, the run-time route at 10), restart intervals that divide 32 and that
    do not, one interval alone; the wire route at 0, 1, a restart point,
    mid-interval and all rows surviving.  One launch a call."""
    keys = torch.from_numpy(chip_smoke.prefix_edge_keys(
        n, lanes, restart).view(np.int32)).to(dev)
    got = one_launch("prefix_encode", lambda: ops.prefix_encode(
        keys, restart_interval=restart))
    assert torch.equal(got, ref.prefix_encode(keys, restart_interval=restart))
    for c in chip_smoke.prefix_edge_counts(n, restart):
        count = torch.tensor(c, dtype=torch.int64, device=dev)
        shared, wire = one_launch(
            "prefix_encode", lambda: ops.prefix_encode_wire(
                keys, count, restart_interval=restart))
        want_shared, want_wire = ref.prefix_encode_wire(
            keys, count, restart_interval=restart)
        assert torch.equal(shared, want_shared)
        assert torch.equal(wire, want_wire)


def test_prefix_encode_wire_takes_an_unaligned_view(dev):
    """Keys that start off a 16-byte boundary take the 4-byte loads."""
    words = torch.from_numpy(chip_smoke.prefix_edge_keys(
        4096, 4, 16).view(np.int32)).to(dev).flatten()
    buf = torch.zeros(words.numel() + 1, dtype=torch.int32, device=dev)
    buf[1:] = words
    keys = buf[1:].view(4096, 4)
    assert keys.data_ptr() % 16 and keys.is_contiguous()
    count = torch.tensor(4000, dtype=torch.int64, device=dev)
    for a, b in zip(ops.prefix_encode_wire(keys, count),
                    ref.prefix_encode_wire(keys, count, restart_interval=16)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("groups,per,n_words", [
    (4096, 16, 5), (1, 16384, 5120), (3, 700, 219)])
def test_bloom_build(dev, groups, per, n_words):
    rng = np.random.default_rng(groups + per)
    keys = words(rng, (groups, per, 4), dev)
    valid = torch.from_numpy(rng.random((groups, per)) < 0.9).to(dev)
    assert torch.equal(
        ops.bloom_build(keys, valid, n_words=n_words, n_probes=6),
        ref.bloom_build(keys, n_words=n_words, n_probes=6, valid=valid))


@pytest.mark.parametrize("lens,launches", [
    ((16_384,) * 4 + (4096,), 3), ((3000, 0, 2500, 4000), 2), ((500,), 0),
    ((16_384,) * 16, 4)])
def test_merge_runs(dev, lens, launches):
    """One launch a level of the merge tree: ceil(log2 k') for k' non-empty
    runs, none for one run."""
    rng = np.random.default_rng(len(lens))
    rows = torch.cat([sorted_rows(rng, n, 6, dev) for n in lens])
    before = ops.launch_counts()["merge_runs"]
    assert torch.equal(ops.merge_runs(rows, lens), ref.merge_runs(rows, lens))
    assert ops.launch_counts()["merge_runs"] == before + launches


T = merge_path.TILE_ROWS


def merge_case(rng, lens, lanes, dev, *, distinct=8, disjoint=False,
               pad=()):
    """Sorted runs back to back with no index lane, so equal rows repeat
    within and across runs: over overlapping key ranges, over disjoint
    ones (run ``i`` has first lane ``i``), or all-ones padding rows for
    the runs in ``pad``."""
    parts = []
    for i, n in enumerate(lens):
        r = rng.integers(0, distinct, (n, lanes)).astype(np.uint32)
        if disjoint:
            r[:, 0] = i
        if i in pad:
            r[:] = 0xFFFFFFFF
        parts.append(r[np.lexsort(tuple(r[:, j] for j in
                                        reversed(range(lanes))))])
    return torch.from_numpy(np.concatenate(parts).view(np.int32)).to(dev)


@pytest.mark.parametrize("lens,lanes,kw,launches", [
    ((16_384,) * 16, 6, dict(disjoint=True), 4),
    ((900, 0, 1, 5000, 37, T, 12_000, 0, 2, 3000, 640), 6, {}, 4),
    ((T - 1, 4 * T), 6, {}, 1), ((T, 4 * T), 6, {}, 1),
    ((T + 1, 4 * T), 6, {}, 1), ((4 * T, T + 1), 6, {}, 1),
    ((3000, 2000, 2500), 5, dict(distinct=2), 2),
    ((20_000, 7000), 6, dict(pad=(0, 1)), 1),
    ((5000, 4000, 1), 6, dict(pad=(1,)), 2),
    ((700, 800), 1, {}, 1), ((700, 800, 5), 8, {}, 2),
    # a level of 75 pairs takes two launches (64 pairs a launch)
    ((40,) * 150, 6, dict(distinct=3), 9),
], ids=["disjoint16", "ragged11", "tile-1", "tile", "tile+1", "tile+1-right",
        "5lanes-dups", "all-padding", "padding-run", "1lane", "8lanes",
        "split-level"])
def test_merge_runs_cases(dev, lens, lanes, kw, launches):
    """The kernel against the plain merge bit for bit: disjoint runs, ragged
    runs with empty and one-row ones, tile edges, duplicates with no index
    lane (ties to the earlier run), all-padding runs, 1 and 8 lanes; and
    its launches a call."""
    rng = np.random.default_rng(sum(lens) + lanes)
    rows = merge_case(rng, lens, lanes, dev, **kw)
    before = ops.launch_counts()["merge_runs"]
    got = ops.merge_runs(rows, lens)
    assert ops.launch_counts()["merge_runs"] == before + launches
    assert torch.equal(got, ref.merge_runs(rows, lens))
    assert torch.equal(got, ref.sort_tuples(rows))


def test_merge_runs_takes_an_unaligned_view(dev):
    """Rows starting 4 bytes past an 8-byte boundary (a view) merge as any
    others do: the wrapper copies them to an aligned buffer first, since
    the kernel moves rows as 8-byte words."""
    lens = (3000, 2000)
    rows = merge_case(np.random.default_rng(3), lens, 6, dev)
    big = torch.empty(rows.numel() + 1, dtype=torch.int32, device=dev)
    view = big[1:].view(rows.shape)
    view.copy_(rows)
    assert view.data_ptr() % 8 == 4
    assert torch.equal(ops.merge_runs(view, lens), ref.merge_runs(rows, lens))


@pytest.mark.parametrize("lanes", [9, 12])
def test_merge_runs_refuses_lanes_it_is_not_built_for(dev, lanes):
    rows = torch.zeros((8, lanes), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="lanes"):
        ops.merge_runs(rows, (4, 4))


def test_build_image_on_card_equals_cpu(dev):
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096)
    rng = np.random.default_rng(0)
    n = 1000
    keys = sorted_rows(rng, n, 4, "cpu", distinct=1 << 20)
    meta = torch.from_numpy(((np.arange(n, dtype=np.uint32) << 1) | 1)
                            .view(np.int32))
    vals = words(rng, (n, geom.value_words), "cpu")
    want = offload.build_image(keys, meta, vals, geom=geom)
    got = offload.build_image(keys.to(dev), meta.to(dev), vals.to(dev),
                              geom=geom)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def flushed_images(dev, n_images, geom, seed=0):
    """``n_images`` host images of sorted entries, flushed on the card
    (overlapping keys across images, so a job drops versions)."""
    from repro_torch.lsm.engine import TorchCompactionEngine
    rng = np.random.default_rng(seed)
    eng = TorchCompactionEngine(geom, device=dev)
    images = []
    for i in range(n_images):
        n = int(rng.integers(500, 3000))
        ids = np.sort(rng.choice(5000, n, replace=False))
        keys = np.stack([np.frombuffer(b"key%013d" % k, ">u4")
                         for k in ids]).astype(np.uint32)
        meta = ((np.arange(n, dtype=np.uint32) + 10_000 * i + 1) << 1) | 1
        vals = rng.integers(0, 2**32, (n, geom.value_words), dtype=np.uint32)
        images.append(eng.build_image(keys, meta, vals))
    eng.close()
    return images


def test_pinned_staging_round_trips_over_reuses(dev):
    """One pinned bucket reused 40 times in a row, each time with other
    words and the copy back on the current stream: every image comes back
    bit for bit, as owned arrays that the next call does not overwrite."""
    from repro_torch.core import formats
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096)
    staging = formats.PinnedStaging(dev)
    rng = np.random.default_rng(1)
    base = flushed_images("cpu", 1, geom)[0]
    kept = []
    for i in range(40):
        host = formats.SSTImage(*(
            rng.integers(0, 2**32, a.shape, dtype=np.uint32).view(a.dtype)
            for a in base))
        img = formats.image_from_numpy(host, dev, staging)
        assert all(t.device.type == "cuda" and t.dtype == torch.int32
                   for t in img)
        img = formats.SSTImage(*(t + 0 for t in img))   # work on the stream
        back = formats.image_to_numpy(img, staging)
        kept.append((host, back))
    assert len(staging._bufs) <= 2   # the image's bucket (and none more)
    for host, back in kept:
        for a, b in zip(host, back):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    staging.close()
    assert not staging._bufs
    again = formats.image_from_numpy(kept[0][0], dev, staging)
    assert formats.image_to_numpy(again, staging)[0].tobytes() == \
        kept[0][0][0].tobytes()


@pytest.mark.parametrize("sort_mode", ["merge", "device"])
def test_compact_paths_with_the_reader_equals_compact(dev, tmp_path,
                                                      sort_mode):
    """The engine's double-buffered ``compact_paths`` (the reader thread,
    pinned staging) gives ``compact``'s image and stats on the same
    files, and the CPU engine's image; ``close`` stops the reader."""
    from repro_torch.lsm import sstable
    from repro_torch.lsm.engine import TorchCompactionEngine
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                       sst_bytes=64 * 1024)
    paths = []
    for i, im in enumerate(flushed_images(dev, 5, geom, seed=2)):
        paths.append(str(tmp_path / f"{i:06d}.sst"))
        sstable.write_sst(paths[-1], sstable.trim_image(im), i)
    eng = TorchCompactionEngine(geom, device=dev, sort_mode=sort_mode)
    cpu = TorchCompactionEngine(geom, device="cpu", sort_mode=sort_mode)
    for _ in range(3):
        got, gs = eng.compact_paths(paths)
        want, ws = eng.compact([sstable.read_sst(p) for p in paths])
        ref_img, rs = cpu.compact_paths(paths)
        for a, b, c in zip(got, want, ref_img):
            assert a.tobytes() == b.tobytes() == c.tobytes()
        assert (gs.n_input, gs.n_live, gs.crc_ok) == \
            (ws.n_input, ws.n_live, True) == (rs.n_input, rs.n_live, True)
        assert gs.n_live < gs.n_input and gs.device_seconds > 0
    eng.close()
    cpu.close()
    assert eng._reader is None


def test_compact_overlapped_on_card_equals_compact(dev):
    from repro_torch.core import formats
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096)
    images = [formats.image_from_numpy(im, dev)
              for im in flushed_images(dev, 3, geom, seed=3)]
    ex = offload.CompactionExecutor(geom, device=dev, sort_mode="device")
    stages = list(ex.compact_overlapped(images, bottom_level=True))
    assert [t for t, _ in stages] == ["data", "bloom", "stats"]
    out, stats = ex.compact(images, bottom_level=True)
    for a, b in zip(stages[0][1] + (stages[1][1],),
                    (out.keys, out.meta, out.vals, out.shared, out.nvalid,
                     out.crc, out.bloom)):
        assert torch.equal(a, b)
    assert stages[2][1] == stats and stats.crc_ok


def sorted_blocks(rng, c, k, lanes, dev):
    """Sorted blocks with duplicate keys and the all-ones sentinel at and
    after ``nvalid`` (some 0), and queries present, past ``nvalid`` and
    absent."""
    keys = rng.integers(0, 6, (c, k, lanes)).astype(np.uint32)
    for i in range(c):
        keys[i] = keys[i][np.lexsort(tuple(keys[i][:, j]
                                           for j in reversed(range(lanes))))]
    nvalid = rng.integers(0, k + 1, c).astype(np.int32)
    nvalid[: c // 16] = 0
    queries = keys[np.arange(c), rng.integers(0, k, c)].copy()
    absent = rng.random(c) < 0.2
    queries[absent] = rng.integers(0, 6, (absent.sum(), lanes))
    for i in range(c):
        keys[i, nvalid[i]:] = 0xFFFFFFFF
    meta = rng.integers(0, 2**32, (c, k), dtype=np.uint32)
    vals = rng.integers(0, 2**32, (c, k, 68), dtype=np.uint32)
    return [torch.from_numpy(a.view(np.int32)).to(dev)
            for a in (keys, meta, vals, nvalid, queries)]


@pytest.mark.parametrize("c,k,lanes", [(1024, 16, 4), (37, 70, 2),
                                       (5, 1, 4)])
def test_lookup_blocks(dev, c, k, lanes):
    args = sorted_blocks(np.random.default_rng(c), c, k, lanes, dev)
    before = ops.launch_counts()["lookup_blocks"]
    got, want = ops.lookup_blocks(*args), ref.lookup_blocks(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].any() and not got[0].all()
    assert ops.launch_counts()["lookup_blocks"] == before + 1


@pytest.mark.parametrize("c,n_words,lanes,probes", [
    (1024, 5, 4, 6), (300, 5120, 4, 6), (7, 13, 2, 3)])
def test_bloom_multi_probe(dev, c, n_words, lanes, probes):
    rng = np.random.default_rng(c)
    keys = words(rng, (c, 16, lanes), dev)
    filters = ref.bloom_build(keys, n_words=n_words, n_probes=probes)
    q = torch.where(torch.from_numpy(rng.random(c) < 0.5).to(dev)[:, None],
                    keys[:, 0], words(rng, (c, lanes), dev))
    before = ops.launch_counts()["bloom_multi_probe"]
    got = ops.bloom_multi_probe(filters, q, n_probes=probes)
    assert torch.equal(got, ref.bloom_multi_probe(filters, q,
                                                  n_probes=probes))
    assert ops.launch_counts()["bloom_multi_probe"] == before + 1


@pytest.mark.parametrize("g,q,n_words", [(1024, 256, 5), (3, 1000, 5120),
                                         (2, 1, 7)])
def test_bloom_query(dev, g, q, n_words):
    rng = np.random.default_rng(g + q)
    keys = words(rng, (g, q, 4), dev)
    filters = ref.bloom_build(keys[:, : max(1, q // 2)], n_words=n_words,
                              n_probes=6)
    assert torch.equal(ops.bloom_query(filters, keys, n_probes=6),
                       ref.bloom_query(filters, keys, n_probes=6))


@pytest.mark.parametrize("case", chip_smoke.QUERY_EDGES, ids=str)
def test_bloom_query_edges(dev, case):
    """One query a group, queries that fill no block, rows of 5 to 13,000
    words, 70,000 groups (past grid.y's limit): bit-identical, one
    launch."""
    g, q, n_words, probes = case
    filters, keys = chip_smoke.query_edge_inputs(g, q, n_words, probes, dev)
    got = one_launch("bloom_query", lambda: ops.bloom_query(
        filters, keys, n_probes=probes))
    assert torch.equal(got, ref.bloom_query(filters, keys, n_probes=probes))
    assert got[:, :(q + 1) // 2].all()   # no false negative


@pytest.mark.parametrize("k,lanes,vw", chip_smoke.EDGE_SHAPES)
def test_lookup_blocks_edges(dev, k, lanes, vw):
    """Both forms at K = 1, a ballot chunk edge (33) and two chunks and a
    bit (70); L = 8 takes 16-byte loads, L = 10 the run-time-lanes path."""
    args = [torch.from_numpy(a.view(np.int32)).to(dev)
            for a in chip_smoke.edge_blocks(
                np.random.default_rng(k * lanes + vw), 60, k, lanes, vw)]
    want = ref.lookup_blocks(*args)
    for fn, expect in ((ops.lookup_blocks, want),
                       (ops.lookup_blocks_packed,
                        ref.lookup_blocks_packed(*args))):
        before = ops.launch_counts()
        got = fn(*args)
        after = ops.launch_counts()
        assert {n: after[n] - before[n] for n in after
                if after[n] != before[n]} == {"lookup_blocks": 1}
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        expect if isinstance(expect, tuple) else (expect,)):
            assert torch.equal(a, b)
    if k > 1:
        assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("n_words,probes", chip_smoke.PROBE_EDGES)
def test_probe_edges(dev, n_words, probes):
    """Short filter rows (whole in registers) and long ones (the probed
    words in batches of 8), 1, 6 and 10 probes; one launch a call."""
    rng = np.random.default_rng(n_words + probes)
    keys = words(rng, (40, 16, 4), dev)
    filters = ref.bloom_build(keys, n_words=n_words, n_probes=probes)
    q = torch.where(torch.from_numpy(rng.random(40) < 0.5).to(dev)[:, None],
                    keys[:, 0], words(rng, (40, 4), dev))
    gq = torch.cat([keys, words(rng, (40, 16, 4), dev)], dim=1)
    for name, fn, plain in (
            ("bloom_multi_probe", lambda: ops.bloom_multi_probe(
                filters, q, n_probes=probes),
             lambda: ref.bloom_multi_probe(filters, q, n_probes=probes)),
            ("bloom_query", lambda: ops.bloom_query(
                filters, gq, n_probes=probes),
             lambda: ref.bloom_query(filters, gq, n_probes=probes))):
        before = ops.launch_counts()[name]
        got = fn()
        assert ops.launch_counts()[name] == before + 1
        assert torch.equal(got, plain())


@pytest.mark.parametrize("n,index_lane", [(65_536, True), (262_144, True),
                                          (300_001, True), (3, False),
                                          (1000, False)])
def test_bitonic_sort(dev, n, index_lane):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 4, (n, 6)).astype(np.uint32)
    if index_lane:
        rows[:, -1] = rng.permutation(n)
    rows = torch.from_numpy(rows.view(np.int32)).to(dev)
    before = ops.launch_counts()["bitonic_sort"]
    got = ops.bitonic_sort(rows)
    assert torch.equal(got, ref.sort_tuples(rows))
    # the tile sort and one launch a merge level of the tiles
    assert ops.launch_counts()["bitonic_sort"] == \
        before + sort_plan.launches(n, 6)


@pytest.mark.parametrize("n,lanes,index_lane", chip_smoke.SORT_EDGES)
def test_sort_edges(dev, n, lanes, index_lane):
    """Tile edges, 1 to 300,001 rows, 1 to 8 lanes in registers and 10 at
    run time, with and without an index lane: bit-identical, the input
    kept, the planned launches and no other kernel."""
    rows = torch.from_numpy(chip_smoke.sort_edge_rows(
        n, lanes, index_lane).view(np.int32)).to(dev)
    kept = rows.clone()
    before = ops.launch_counts()
    got = ops.bitonic_sort(rows)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {
                "bitonic_sort": sort_plan.launches(n, lanes)}
    assert torch.equal(got, ref.sort_tuples(rows))
    assert torch.equal(rows, kept)


@pytest.mark.parametrize("case", chip_smoke.BLOOM_EDGES, ids=str)
def test_bloom_build_edges(dev, case):
    """Both routes (a sub-warp a group up to 32 words, a block beyond),
    1 to 16,384 keys a group, no valid key and all: bit-identical, one
    launch."""
    keys, valid = chip_smoke.bloom_edge_inputs(*case)
    k = torch.from_numpy(keys.view(np.int32)).to(dev)
    v = torch.from_numpy(valid).to(dev)
    n_words, probes = case[3], case[4]
    before = ops.launch_counts()["bloom_build"]
    got = ops.bloom_build(k, v, n_words=n_words, n_probes=probes)
    assert ops.launch_counts()["bloom_build"] == before + 1
    assert torch.equal(got, ref.bloom_build(k, n_words=n_words,
                                            n_probes=probes, valid=v))


# ---------------------------------------------------------------------------
# the selective scan and the Mamba serving path
# ---------------------------------------------------------------------------


def scan_inputs(rng, b, s, di, ds, dev, u_dtype, with_h0=False):
    """Inputs at the scales of falcon-mamba's prefill (softplus dt,
    A_log = log(1..ds) plus noise)."""
    f32 = torch.float32

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    u = normal(b, s, di).to(u_dtype)
    dt = torch.nn.functional.softplus(normal(b, s, di) - 2.0)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=f32, device=dev)
                      .repeat(di, 1)) + 0.1 * normal(di, ds)
    h0 = normal(b, di, ds) if with_h0 else None
    return u, dt, normal(b, s, ds), normal(b, s, ds), a_log, normal(di), h0


@pytest.mark.parametrize("b,s,di,ds,u_dtype,with_h0", [
    (4, 512, 8192, 16, torch.bfloat16, False),
    (2, 37, 100, 5, torch.float32, True),
    # B = 1 at full width (fewer than 8 warps an SM: the instantiation
    # with 255 registers a thread), in both u types
    (1, 4096, 8192, 16, torch.bfloat16, False),
    (1, 4096, 8192, 16, torch.float32, True),
    # ds 1 and 5 (padded states), S = 1 and a 16-step chunk +- 1, di not
    # a multiple of a block's 64 channels nor of 8 (the unaligned copies)
    (3, 1, 8192, 1, torch.bfloat16, True),
    (2, 15, 4100, 5, torch.float32, False),
    (4, 16, 8200, 16, torch.bfloat16, True),
    (4, 17, 8192, 1, torch.float32, False),
    (1, 17, 100, 16, torch.bfloat16, True),
    (2, 33, 70, 16, torch.float32, True)])
def test_selective_scan(dev, b, s, di, ds, u_dtype, with_h0):
    """Kernel against the plain version: max abs error <= 1e-4 of the
    largest |y| (and of the largest |h_last|); both scan in fp32 and differ
    in the exponential's last bits (ex2.approx against exp) and the order
    of the h . C sum."""
    args = scan_inputs(np.random.default_rng(s), b, s, di, ds, dev, u_dtype,
                       with_h0)
    before = ops.launch_counts()["selective_scan"]
    y, h = ops.selective_scan(*args)
    assert ops.launch_counts()["selective_scan"] == before + 1
    want_y, want_h = ref.selective_scan(*args)
    torch.cuda.synchronize()
    assert y.dtype == h.dtype == torch.float32
    assert float((y - want_y).abs().max()) <= \
        1e-4 * float(want_y.abs().max())
    assert float((h - want_h).abs().max()) <= \
        1e-4 * float(want_h.abs().max())


SCAN_GRADS = ("du", "ddt", "db", "dc", "da_log", "dd_skip", "dh0")


@pytest.mark.parametrize("b,s,di,ds,u_dtype,with_h0,with_dh", [
    (4, 512, 8192, 16, torch.bfloat16, False, False),
    # the segment, chunk and channel-block edges of `bwd_plan`'s cut (S =
    # 1, one-step and ragged last segments, segments of 1 to 63 chunks, di
    # off the walk's 64-channel block, ds < 16), then B = 1 at 4,096 steps
    # (four segments of 128 chunks, carried start states and adjoints)
    *chip_smoke.SCAN_BWD_EDGES,
    (1, 4096, 8192, 16, torch.bfloat16, True, True)])
def test_selective_scan_bwd(dev, b, s, di, ds, u_dtype, with_h0, with_dh):
    """The backward kernel against the plain backward (autograd through
    the plain scan): each gradient within 1e-4 of its largest magnitude
    (both sum in fp32; ex2.approx against exp, and other summation
    orders), ``du`` in ``u``'s dtype and the rest fp32; a bf16 ``du`` also
    within one bf16 ulp of the plain value (2**-7 of it), as each side
    rounds its own fp32 sum once; one launch, and a rerun equal bit for
    bit (no float atomics)."""
    rng = np.random.default_rng(s + ds)
    args = scan_inputs(rng, b, s, di, ds, dev, u_dtype, with_h0)
    dy = torch.from_numpy(rng.standard_normal((b, s, di)).astype(
        np.float32)).to(dev)
    dh = torch.from_numpy(rng.standard_normal((b, di, ds)).astype(
        np.float32)).to(dev) if with_dh else None
    from repro_torch.kernels import selective_scan as scan
    got = one_launch("selective_scan_bwd",
                     lambda: scan.selective_scan_bwd(*args, dy, dh))
    again = scan.selective_scan_bwd(*args, dy, dh)
    want = ref.selective_scan_bwd(*args, dy, dh)
    torch.cuda.synchronize()
    assert (got[6] is None) == (not with_h0)
    for name, g, a, w in zip(SCAN_GRADS, got, again, want):
        if w is None:
            continue
        dtype = u_dtype if name == "du" else torch.float32
        assert g.dtype == w.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        g, w = g.float(), w.float()
        lim = 1e-4 * float(w.abs().max())
        if dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * w.abs()
        assert bool(((g - w).abs() <= lim).all()), name


def test_selective_scan_gradient_through_autograd_on_the_card(dev):
    """``ops.selective_scan`` with inputs that need gradients: one forward
    launch, and one ``selective_scan_bwd`` launch in the backward, whose
    gradients (``du`` in ``u``'s bf16, as the kernel writes it) are the
    kernel's."""
    rng = np.random.default_rng(5)
    args = [a.requires_grad_() for a in
            scan_inputs(rng, 2, 40, 256, 16, dev, torch.bfloat16, True)]
    before = ops.launch_counts()
    y, h = ops.selective_scan(*args)
    dy = torch.randn_like(y)
    torch.autograd.backward([y], [dy])
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]}\
        == {"selective_scan": 1, "selective_scan_bwd": 1}
    from repro_torch.kernels import selective_scan as scan
    want = scan.selective_scan_bwd(*[a.detach() for a in args], dy)
    assert args[0].grad.dtype == want[0].dtype == torch.bfloat16
    assert torch.equal(args[0].grad, want[0])
    for a, w in zip(args[1:], want[1:]):
        assert torch.equal(a.grad, w)


def test_train_step_on_the_card_as_on_the_cpu(dev):
    """falcon-mamba-7b's smoke config at fp32 with remat: two
    ``train_step``s on the card and on the CPU from the same state, losses
    and params within 1e-4; each step launches the scan twice a layer (the
    forward and remat's recompute) and its backward once."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import tree_leaves, tree_map
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_step as ts
    cfg = get_smoke_config("falcon-mamba-7b").with_(
        dtype="float32", remat=True)
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=2)
    cpu = ts.init_state(0, cfg, opt, device="cpu")
    card = tree_map(lambda a: a.to(dev), cpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    for _ in range(2):
        before = ops.launch_counts()
        card, mc = ts.train_step(card, {"tokens": toks.to(dev),
                                        "labels": toks.to(dev)},
                                 cfg=cfg, opt_cfg=opt)
        after = ops.launch_counts()
        assert after["selective_scan"] - before["selective_scan"] == \
            2 * cfg.n_layers
        assert after["selective_scan_bwd"] - before["selective_scan_bwd"] \
            == cfg.n_layers
        cpu, m = ts.train_step(cpu, {"tokens": toks, "labels": toks},
                               cfg=cfg, opt_cfg=opt)
        assert float(mc["loss"]) == pytest.approx(float(m["loss"]), rel=1e-4)
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4


def test_sharded_step_on_a_one_rank_mesh_equals_train_step(dev):
    """falcon-mamba-7b's smoke config at bf16 with remat, in a one-rank
    NCCL world: two ``shard_train_step`` steps on the (1, 1) mesh equal
    two ``train_step``s bit for bit, and launch the scan and its backward
    as the one-device step does (on the card the backward runs on the
    autograd engine's thread, and remat's recompute must still see the
    mesh's annotations there)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import tree_leaves
    from repro_torch.testing.world import one_rank_world
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_step as ts
    cfg = get_smoke_config("falcon-mamba-7b").with_(remat=True)
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=2)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    plain = ts.init_state(0, cfg, opt, device=dev)
    with one_rank_world("nccl"):
        fn, _, _ = ts.shard_train_step(cfg, make_host_mesh(), 2, 24, opt)
        sharded = ts.init_state(0, cfg, opt, device=dev)
        for _ in range(2):
            plain, m = ts.train_step(plain, batch, cfg=cfg, opt_cfg=opt)
            before = ops.launch_counts()
            sharded, ms = fn(sharded, batch)
            after = ops.launch_counts()
            assert float(ms["loss"]) == float(m["loss"])
            assert after["selective_scan"] - before["selective_scan"] == \
                2 * cfg.n_layers
            assert after["selective_scan_bwd"] - \
                before["selective_scan_bwd"] == cfg.n_layers
        for a, b in zip(tree_leaves(sharded.params),
                        tree_leaves(plain.params)):
            assert torch.equal(a.to_local(), b)


def test_falcon_prefill_then_decode_equals_prefill(dev):
    """falcon-mamba-7b at full width and 4 layers: prefilling 63 tokens and
    decoding the 64th gives the 64-token prefill's last logits within
    5e-2 of their largest magnitude (bf16 activations; the scan state
    carried from the kernel's h_last and the conv state into the plain
    decode step).  The prefill launches the kernel once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import ServeEngine
    cfg = get_config("falcon-mamba-7b").with_(n_layers=4)
    eng = ServeEngine(cfg, model.init(0, cfg, device=dev), device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)).to(dev)
    before = ops.launch_counts()["selective_scan"]
    full, _, _ = model.prefill(eng.params, {"tokens": toks}, cfg, 128)
    assert ops.launch_counts()["selective_scan"] == before + 4
    _, cache, pos = model.prefill(eng.params, {"tokens": toks[:, :-1]}, cfg,
                                  128)
    dec, _ = model.decode_step(eng.params, cache, toks[:, -1:], pos, cfg)
    assert torch.isfinite(full).all()
    assert float((dec[:, 0] - full).abs().max()) <= \
        5e-2 * float(full.abs().max())


@pytest.fixture
def falcon4(dev):
    """falcon-mamba-7b at full width and 4 layers, served on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import ServeEngine
    cfg = get_config("falcon-mamba-7b").with_(n_layers=4)
    eng = ServeEngine(cfg, model.init(0, cfg, device=dev), max_len=64,
                      device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)).to(dev)
    return eng, toks


def test_captured_decode_equals_eager_decode(falcon4):
    """The engine's captured step against ``model.decode_step`` from one
    prefill: the same greedy tokens, and the same last logits and cache
    bit for bit (the graph replays the eager step's kernels) or, should
    cuBLAS take other kernels under capture, within ``LOGIT_TOL``."""
    from repro_torch.models import model
    eng, toks = falcon4
    logit, cache0, pos0 = model.prefill(eng.params, {"tokens": toks},
                                        eng.cfg, eng.max_len)
    runs = []
    for step in (lambda c, t, p: model.decode_step(eng.params, c, t, p,
                                                   eng.cfg),
                 lambda c, t, p: eng._decode(eng.params, c, t, p)):
        c, p = cache0, pos0
        tok = logit.argmax(-1)[:, None].to(torch.int32)
        outs = []
        for _ in range(5):
            logits, c = step(c, tok, p)
            tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            outs.append(tok)
            p = p + 1
        runs.append((torch.cat(outs, 1), logits, c))
    (te, le, ce), (tc, lc, cc) = runs
    assert torch.equal(te, tc)
    if not chip_smoke.same_state((lc, cc), (le, ce)):
        gap = chip_smoke.last_logits_gap(lc[:, 0], le[:, 0])[0]
        assert gap <= chip_smoke.LOGIT_TOL
    assert len(eng._graphs) == 1   # one capture for the batch


def test_generate_returns_state_no_replay_overwrites(falcon4):
    """``generate``'s resumable state is the caller's own: a second
    ``generate`` (more replays of the same graph) leaves it as it was,
    and it still resumes to the uninterrupted run's tokens."""
    eng, toks = falcon4
    full = eng.generate(toks, 8)[0]
    part, cache, pos = eng.generate(toks, 4)
    kept = chip_smoke.tree_map(torch.clone, (cache, pos))
    eng.generate(toks[:, :7], 6)
    assert chip_smoke.same_state((cache, pos), kept)
    tok = torch.from_numpy(part[:, -1:]).to(toks.device)
    outs = []
    for _ in range(4):
        logits, cache = eng._decode(eng.params, cache, tok, pos)
        tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
        outs.append(tok[:, 0].cpu().numpy())
        pos = pos + 1
    np.testing.assert_array_equal(np.stack(outs, 1), full[:, 4:])


def test_capture_failure_raises_and_never_runs_eagerly(falcon4, monkeypatch):
    """A decode step that cannot be captured raises out of ``_decode`` and
    ``generate``; the engine keeps no graph and runs no eager step in its
    place."""
    from repro_torch.models import model
    eng, toks = falcon4
    real = model.decode_step
    eager_calls = []

    def step(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        eager_calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(model, "decode_step", step)
    with pytest.raises(RuntimeError, match="not capturable"):
        eng.generate(toks, 3)
    assert eng._graphs == {}
    assert len(eager_calls) == 2   # the two warm-up steps before a capture
    cache = model.init_cache(eng.cfg, 2, 8, device=toks.device)
    pos = torch.zeros((2, 1), dtype=torch.int32, device=toks.device)
    with pytest.raises(RuntimeError, match="not capturable"):
        eng._decode(eng.params, cache, toks[:, :1], pos)
    assert eng._graphs == {} and len(eager_calls) == 4
    with pytest.raises(ValueError, match="engine's own params"):
        eng._decode(dict(eng.params), cache, toks[:, :1], pos)


def test_session_pages_on_the_card_as_on_the_cpu(dev, tmp_path):
    """A seeded 4 MiB state paged at the serving launcher's geometry (4
    KiB values, 32 KiB blocks) through a store on the card and one on the
    CPU: a flush and an L0->L1 job each, the same SST files, each state
    loaded back bit for bit, and the store kernels launched on the card
    only."""
    xd = chip_smoke.cross_device_pages(str(tmp_path), dev)
    assert xd["dev"]["stats"].compactions >= 1
    assert xd["dev"]["files"] == xd["cpu"]["files"] != {}
    assert all(xd["dev"]["launches"][k] for k in chip_smoke.WRITE_PATH
               + chip_smoke.READ_PATH)
    assert not any(xd["cpu"]["launches"].values())


# ---------------------------------------------------------------------------
# a batch of jobs: the job as the grid's y dimension (ROADMAP A7)
# ---------------------------------------------------------------------------


def batch_of(rng, jobs, make):
    return torch.stack([make(rng) for _ in range(jobs)])


def prefix_keys(rng, n, lanes, dev) -> torch.Tensor:
    """Sorted keys ``[n, lanes]`` of ``PREFIX_WORDS`` drawn from ``rng``
    (as ``chip_smoke.prefix_edge_keys``, but a batch's jobs differ)."""
    words = chip_smoke.PREFIX_WORDS
    rows = words[rng.integers(0, len(words), (max(n // 4, 1), lanes))]
    k = rows[rng.integers(0, len(rows), n)]
    k = k[np.lexsort(tuple(k[:, i] for i in reversed(range(lanes))))]
    return torch.from_numpy(k.view(np.int32)).to(dev)


def sort_rows(rng, n, lanes, job, dev) -> torch.Tensor:
    """Rows ``[n, lanes]`` of ``SORT_WORDS`` with a unique index lane that
    also names the job (as ``chip_smoke.sort_edge_rows``)."""
    words = chip_smoke.SORT_WORDS
    r = words[rng.integers(0, len(words), (n, lanes))]
    r[:, -1] = (rng.permutation(n) + job * n).astype(np.uint32)
    return torch.from_numpy(r.view(np.int32)).to(dev)


def host_sst(rng, geom, n):
    """A host image of ``n`` sorted entries (values and tombstones of
    random sequence numbers), built on the CPU."""
    from repro_torch.core import formats
    from repro_torch.lsm.engine import TorchCompactionEngine
    keys = np.unique(rng.integers(0, 2**32, (n, geom.key_lanes),
                                  dtype=np.uint32) | 1, axis=0)
    n = keys.shape[0]
    meta = np.array([formats.make_meta(int(s), int(v)) for s, v in zip(
        rng.integers(1, 10**6, n), rng.random(n) < 0.8)], np.uint32)
    vals = rng.integers(0, 2**32, (n, geom.value_words), dtype=np.uint32)
    return TorchCompactionEngine(geom, device="cpu").build_image(keys, meta,
                                                                 vals)


@pytest.mark.parametrize("jobs,lens,lanes", [
    (1, (3000, 0, 2500, 4000), 6), (1, (500,), 6), (2, (0, 1000, 0, 24), 3),
    (4, (16_384,) * 4, 6), (8, (513, 2000, 7, 4096, 1), 5),
    (8, (T - 1, 4 * T, T + 1), 1), (3, (40,) * 150, 6), (5, (1, 1, 1), 8),
    (2, (0, 0, 700), 7), (6, (T,) * 8, 2)],
    ids=["J1", "J1-one-run", "J2-empty-runs", "J4-L0-job", "J8-ragged",
         "J8-tile-edges", "J3-split-level", "J5-one-row-runs",
         "J2-one-nonempty", "J6-8runs"])
def test_merge_runs_batched(dev, jobs, lens, lanes):
    """J jobs of the same runs merged in the one job's launches, each job
    bit-identical to the plain merge of that job alone (duplicates, no
    index lane: ties to the earlier run)."""
    rng = np.random.default_rng(jobs * 1000 + sum(lens))
    rows = batch_of(rng, jobs, lambda r: merge_case(r, lens, lanes, dev,
                                                    distinct=4))
    before = ops.launch_counts()["merge_runs"]
    got = ops.merge_runs(rows, lens)
    assert ops.launch_counts()["merge_runs"] == \
        before + len(merge_path.launch_tables(lens)[0])
    assert torch.equal(got, ref.merge_runs_batched(rows, lens))


@pytest.mark.parametrize("jobs,n,lanes,restart", [
    (1, 4096, 4, 16), (4, 65_536, 4, 16), (8, 4096, 1, 16),
    (3, 1536, 5, 12), (2, 2048, 8, 16), (5, 960, 10, 16), (8, 48, 3, 24)])
def test_prefix_encode_wire_batched(dev, jobs, n, lanes, restart):
    """The pack's prefix step for J jobs in one launch, each job against
    the plain version alone, with per-job survivor counts of 0, all rows,
    one row, a restart point and mid-interval."""
    rng = np.random.default_rng(n + lanes + jobs)
    keys = batch_of(rng, jobs, lambda r: prefix_keys(r, n, lanes, dev))
    counts = [0, n, 1, restart, restart + 5, n // 2, n - 1, 7][:jobs]
    count = torch.tensor(counts, dtype=torch.int64, device=dev)
    shared, wire = one_launch("prefix_encode", lambda: ops.prefix_encode_wire(
        keys, count, restart_interval=restart))
    want_shared, want_wire = ref.prefix_encode_wire_batched(
        keys, count, restart_interval=restart)
    assert torch.equal(shared, want_shared) and torch.equal(wire, want_wire)


@pytest.mark.parametrize("jobs,n,lanes", [
    (1, 3000, 6), (4, 65_536, 6), (8, 100, 6), (3, 5000, 3), (2, 2048, 8),
    (5, 4097, 1), (3, 1500, 10)])
def test_bitonic_sort_batched(dev, jobs, n, lanes):
    """J jobs sorted on their own in ``launches(n, lanes)`` launches: no
    tile straddles two jobs, also where the tile does not divide n."""
    rng = np.random.default_rng(n + jobs)
    rows = torch.stack([sort_rows(rng, n, lanes, j, dev)
                        for j in range(jobs)])
    before = ops.launch_counts()["bitonic_sort"]
    got = ops.bitonic_sort(rows)
    assert ops.launch_counts()["bitonic_sort"] == \
        before + sort_plan.launches(n, lanes)
    assert torch.equal(got, torch.stack([ref.sort_tuples(r) for r in rows]))


@pytest.mark.parametrize("sort_mode", ["merge", "device"])
def test_compact_many_on_card_equals_each_job_alone(dev, sort_mode):
    """``CompactionExecutor.compact_many`` on the card: each job's image
    and stats equal ``compact`` of that job alone, on the card and on the
    CPU."""
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096)
    rng = np.random.default_rng(5)
    host = [[host_sst(rng, geom, int(rng.integers(600, 900)))
             for _ in range(3)] for _ in range(3)]
    from repro_torch.core import formats
    results = {}
    for d in (dev, "cpu"):
        ex = offload.CompactionExecutor(geom, device=d, sort_mode=sort_mode)
        # each input run padded to 64 blocks, as the engine pads it
        jobs = [[offload.pad_image_blocks(formats.image_from_numpy(im, d),
                                          64, geom) for im in job]
                for job in host]
        results[str(d)] = (ex.compact_many(jobs, pad_blocks=256),
                           [ex.compact(j, pad_blocks=256) for j in jobs])
    many, alone = results[str(dev)]
    cpu_many, _ = results["cpu"]
    for (img, st), (a, sa), (c, sc) in zip(many, alone, cpu_many):
        assert st == sa == sc and st.crc_ok
        for x, y, z in zip(img, a, c):
            assert torch.equal(x, y) and torch.equal(x.cpu(), z)


def test_flush_while_the_queue_compacts_on_the_card(dev, tmp_path):
    """A ShardedDB on the card: shards flush on the caller's thread while
    the queue's worker compacts through the shared engine (its pinned
    staging, its reader, its timers); every acknowledged write reads back
    by get, multi_get and scan, and the engine's calls never overlapped."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.lsm.db import DBConfig
    from repro_torch.lsm.sharded import ShardedDB
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                       sst_bytes=64 * 1024)
    db = ShardedDB(str(tmp_path / "sh"), DBConfig(
        geom=geom, scheduler=SchedulerConfig(l0_trigger=4,
                                             base_bytes=512 * 1024)),
        shards=4, device=dev)
    inside, depth, threads = [0], [], set()
    lock = threading.Lock()
    ex = db.engine.executor

    def watch(fn):
        def call(*a, **kw):
            with lock:
                inside[0] += 1
                depth.append(inside[0])
                threads.add(threading.current_thread().name)
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    inside[0] -= 1
        return call

    ex.compact = watch(ex.compact)
    ex.compact_many = watch(ex.compact_many)
    offload_build = offload.build_image
    offload.build_image = watch(offload_build)
    try:
        rng = np.random.default_rng(9)
        model = {}
        for i in range(6000):
            k = bytes([int(rng.integers(1, 255))]) + b"k%06d" % i
            v = rng.bytes(200)
            db.put(k, v)
            model[k] = v
        db.wait_idle()
    finally:
        offload.build_image = offload_build
    assert "shard-compact-0" in threads and len(threads) >= 2
    assert max(depth) == 1
    assert db.stats.compactions > 0
    keys = sorted(model)
    assert [db.get(k) for k in keys] == [model[k] for k in keys]
    assert db.multi_get(keys) == [model[k] for k in keys]
    assert db.scan(b"\x00", b"\xff\xff") == sorted(model.items())
    db.close()


# ---------------------------------------------------------------------------
# the async write path on the card (ROADMAP A8)
# ---------------------------------------------------------------------------


def test_async_store_on_the_card_as_the_sync_store(dev, tmp_path):
    """``chip_smoke.py`` phase 9 (a) and (d), small: an async store on the
    card (three flush workers, one compaction worker) writes the sync
    store's SST files before and after the compaction drain, with every
    write-path kernel launched from its workers and the merge one launch
    a level; a build made to raise halts it with a ``BackgroundError``,
    and ``resume()`` brings back the sync store's L0 files."""
    from repro_torch.core.scheduler import SchedulerConfig
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                       sst_bytes=64 * 1024)
    sched = SchedulerConfig(l0_trigger=4, base_bytes=512 * 1024)
    a = chip_smoke.async_files_phase(str(tmp_path), dev, geom=geom,
                                     sched=sched, value_size=256)
    assert a["sync"]["flushes"] == a["async"]["flushes"] >= 8
    assert all(a["async"]["workers"].get(k) for k in chip_smoke.WRITE_PATH)
    assert any(n for _, n, _ in a["jobs_seen"])
    d = chip_smoke.async_halt_phase(str(tmp_path), dev, geom=geom,
                                    sched=sched, value_size=256)
    assert d["resumed"] is True
    assert d["queued"] == chip_smoke.HALT_MEMTABLES - 1
    assert d["files"] > d["l0_halted"] >= 1


def test_capture_beside_a_background_flush(falcon4, tmp_path):
    """``chip_smoke.py`` phase 9 (f), small: a 1 MiB state saved into an
    async store whose flush builds inside the capture of a new decode
    batch size (the capture held open until the build has run): the
    tokens equal an eager run's and the state loads back bit for bit."""
    eng, toks = falcon4
    f = chip_smoke.capture_beside_flush(eng, toks, str(tmp_path),
                                        nbytes=1 << 20, batch=1, max_new=4)
    assert f["inside"] is True and 1 in eng._graphs
    assert f["queued"] == 1 and f["flushes"] >= 1


def test_async_store_takes_no_stream_from_the_pool(dev, tmp_path,
                                                  monkeypatch):
    """An async store on the card -- flush workers, the compaction worker,
    ``multi_get`` -- takes no stream from PyTorch's pool, which hands the
    same CUDA streams out round-robin: one of them may be the stream a
    graph capture runs on in another thread (``chip_smoke.py`` phase 9
    (f) met that at full size, when the engine's copies back went through
    a pool stream of their own)."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.lsm.db import DBConfig, LsmDB
    real = torch.cuda.Stream
    taken = []

    class Guarded(real):
        def __new__(cls, *args, **kwargs):
            if "stream_id" not in kwargs:   # not a wrap of a known stream
                taken.append(threading.current_thread().name)
            return super().__new__(cls, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Stream", Guarded)
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                       sst_bytes=64 * 1024)
    db = LsmDB(str(tmp_path / "db"), DBConfig(
        geom=geom, scheduler=SchedulerConfig(l0_trigger=4,
                                             base_bytes=512 * 1024),
        async_compaction=True, flush_workers=2), device=dev)
    model = {}
    for i in range(2000):
        k, v = b"k%06d" % i, bytes([i % 251]) * 200
        db.put(k, v)
        model[k] = v
    db.wait_idle(timeout=120)
    keys = sorted(model)
    assert db.multi_get(keys) == [model[k] for k in keys]
    assert db.stats.flushes >= 6 and db.stats.compactions >= 1
    db.close()
    assert taken == []


# ---------------------------------------------------------------------------
# metrics and tracing on the card (ROADMAP A10)
# ---------------------------------------------------------------------------


def small_store_config(**kw):
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.lsm.db import DBConfig
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                       sst_bytes=64 * 1024)
    return DBConfig(geom=geom, scheduler=SchedulerConfig(
        l0_trigger=4, base_bytes=512 * 1024), **kw)


def test_launch_phases_are_cuda_event_children(dev, tmp_path):
    """``chip_smoke.py`` phase 11 (a), small: a traced sync store on the
    card; each launch span holds its three child phases, clock
    ``cuda_event``, inside it, and their sum over the jobs equals
    ``compact_device_seconds`` within 1 % (both read the same events)."""
    from repro_torch.lsm.db import LsmDB
    from repro_torch.obs import Tracer
    tr = Tracer()
    db = LsmDB(str(tmp_path / "db"), small_store_config(tracer=tr),
               device=dev)
    for i in range(3000):
        db.put(b"k%06d" % (i % 1500), bytes([i % 251]) * 200)
    db.flush()
    db.maybe_compact()
    st = db.stats
    db.close()
    events = tr.to_chrome()["traceEvents"]
    chip_smoke.check_nesting(events)
    la = chip_smoke.check_launches(events, "cuda_event", "the store")
    assert la["launches"] == st.compactions >= 1 and la["shared"] == 0
    assert abs(la["children_s"] - st.compact_device_seconds) <= \
        0.01 * st.compact_device_seconds


def test_untraced_job_records_no_extra_events(dev, tmp_path, monkeypatch):
    """A job through an engine with a tracer makes the CUDA events, the
    kernel launches and the image of the same job untraced: the child
    phases read the pipeline's own events (4 a job)."""
    from repro_torch.lsm.db import LsmDB
    from repro_torch.lsm.engine import TorchCompactionEngine
    from repro_torch.obs import Tracer
    cfg = small_store_config(auto_compact=False)
    db = LsmDB(str(tmp_path / "db"), cfg, device=dev)
    for i in range(1200):
        db.put(b"k%06d" % (i % 700), bytes([i % 251]) * 200)
    db.flush()
    paths = [fm.path for fm in db.versions.current.levels[0]]
    db.close()
    assert len(paths) >= 4
    made = []
    real = torch.cuda.Event

    def counted(*args, **kw):
        made.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    seen = []
    for tracer in (None, Tracer()):
        eng = TorchCompactionEngine(cfg.geom, device=dev, tracer=tracer)
        try:
            eng.compact_paths(paths)   # staging buffers made
            del made[:]
            before = ops.launch_counts()
            out, es = eng.compact_paths(paths)
            after = ops.launch_counts()
        finally:
            eng.close()
        seen.append((len(made), {k: after[k] - before[k] for k in after},
                     [np.asarray(a).tobytes() for a in out]))
    assert seen[0] == seen[1] and seen[0][0] == 4


def test_launch_children_say_when_another_thread_launched(dev, tmp_path):
    """A traced job alone: its child phases carry no ``"stream"``; the
    same job while another thread launches kernels on the card: they say
    ``"stream": "shared"`` (the engine reads ``ops.launch_marks`` around
    the pipeline)."""
    from repro_torch.lsm.db import LsmDB
    from repro_torch.lsm.engine import PHASE_SPANS, TorchCompactionEngine
    from repro_torch.obs import Tracer
    cfg = small_store_config(auto_compact=False)
    db = LsmDB(str(tmp_path / "db"), cfg, device=dev)
    for i in range(1200):
        db.put(b"k%06d" % (i % 700), bytes([i % 251]) * 200)
    db.flush()
    paths = [fm.path for fm in db.versions.current.levels[0]]
    db.close()
    tr = Tracer()
    eng = TorchCompactionEngine(cfg.geom, device=dev, tracer=tr)
    words = torch.zeros((64, 16), dtype=torch.int32, device=dev)
    stop, started = threading.Event(), threading.Event()

    def other():
        while not stop.is_set():
            ops.crc32_blocks(words)
            started.set()

    def child_args():
        kids = [e for e in tr.to_chrome()["traceEvents"]
                if e["ph"] == "X" and e["name"] in PHASE_SPANS][-3:]
        assert [k["name"] for k in kids] == list(PHASE_SPANS)
        return [k["args"] for k in kids]

    t = threading.Thread(target=other, daemon=True)
    try:
        eng.compact_paths(paths)
        assert all("stream" not in a for a in child_args())
        t.start()
        assert started.wait(60)
        eng.compact_paths(paths)
        assert all(a.get("stream") == "shared" for a in child_args())
    finally:
        stop.set()
        t.join(60)
        eng.close()


def test_no_span_recorded_in_a_graph_replay(falcon4):
    """``chip_smoke.py`` phase 11 (d), small: a traced engine captures its
    decode step inside ``generate`` with nothing recorded inside the
    capture, and a replay records nothing: a second ``generate`` adds one
    ``serve.generate`` span and no capture."""
    from repro_torch.obs import Tracer
    from repro_torch.serving.engine import ServeEngine
    eng, toks = falcon4
    tr = Tracer()
    seng = ServeEngine(eng.cfg, eng.params, max_len=64, device=toks.device,
                       tracer=tr)
    with chip_smoke.capture_windows() as wins:
        part, cache, pos = seng.generate(toks, 4)
        n = len(tr)
        tok = torch.from_numpy(part[:, -1:]).to(toks.device)
        for _ in range(3):
            logits, cache = seng._decode(seng.params, cache, tok, pos)
            tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            pos = pos + 1
        assert len(tr) == n
        seng.generate(toks, 4)
    assert len(wins) == 1
    raw = list(tr._events)
    assert [e[1] for e in raw] == ["serve.generate"] * 2
    ident, c0, c1 = wins[0]
    assert not [e for e in raw if e[4] == ident and c0 <= e[2] < c1]


# ---------------------------------------------------------------------------
# the model zoo on the card (ROADMAP A12)
# ---------------------------------------------------------------------------

ZOO = ("falcon-mamba-7b", "gemma3-4b", "granite-20b", "granite-moe-3b-a800m",
       "internvl2-26b", "jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b",
       "qwen3-14b", "whisper-medium", "yi-34b")


def zoo_inputs(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, s)).astype(np.int32))}
    if cfg.frontend == "vision":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 20, cfg.d_model)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_on_the_card_as_on_the_cpu(dev, arch):
    """``chip_smoke.py`` phase 12 (c), small: every arch's smoke config at
    fp32 compute and scan, the same weights on both devices: ``forward``
    and a prefill of 12 tokens followed by 8 decode steps (gemma3's
    windows of 16 wrap) within 1e-4 of the largest |logit| of the CPU's, the MoE
    routings equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model, moe
    cfg = get_smoke_config(arch).with_(dtype="float32",
                                       ssm_scan_dtype="float32")
    params = model.init(0, cfg, device="cpu")
    out = {}
    route = moe._route
    for d in ("cpu", dev):
        p = chip_smoke.tree_map(lambda a, d=d: a.to(d), params)
        batch = {k: v.to(d) for k, v in zoo_inputs(cfg, 12).items()}
        routes = []

        def watch(rp, xt, c, routes=routes):
            r = route(rp, xt, c)
            routes.append(r[1].cpu())
            return r

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(moe, "_route", watch)
            logits = [model.forward(p, batch, cfg)[0]]
            last, cache, pos = model.prefill(p, batch, cfg, 32 + (
                cfg.frontend_len if cfg.frontend == "vision" else 0))
            enc = model._encode(p, batch["frames"], cfg)[0] \
                if cfg.enc_dec else None
            tok = last.argmax(-1)[:, None].to(torch.int32)
            logits.append(last)
            for _ in range(8):
                step, cache = model.decode_step(p, cache, tok, pos, cfg,
                                                enc_out=enc)
                logits.append(step[:, 0])
                # teacher-forced, the same tokens on both devices
                tok = zoo_inputs(cfg, 1, seed=len(logits))["tokens"].to(d)
                pos = pos + 1
        out[str(d)] = ([x.cpu() for x in logits], routes)
    (got, got_routes), (want, want_routes) = out[str(dev)], out["cpu"]
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert len(got_routes) == len(want_routes)
    assert all(torch.equal(a, b) for a, b in zip(got_routes, want_routes))


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b"])
def test_zoo_captured_decode_equals_eager(dev, arch):
    """The engine's captured step over attention caches (gemma3's rings
    wrapping past 16 slots), the MoE dispatch (argsort, searchsorted, the
    capacity buffer, the slot-order combine) and jamba's mix: the greedy
    tokens of 20 steps equal, the last logits and cache bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.serving.engine import ServeEngine
    cfg = get_smoke_config(arch)
    eng = ServeEngine(cfg, model.init(0, cfg, device=dev), max_len=32,
                      device=dev)
    toks = zoo_inputs(cfg, 10)["tokens"].to(dev)
    logit, cache0, pos0 = model.prefill(eng.params, {"tokens": toks}, cfg,
                                        eng.max_len)
    runs = []
    for step in (lambda c, t, p: model.decode_step(eng.params, c, t, p,
                                                   cfg),
                 lambda c, t, p: eng._decode(eng.params, c, t, p)):
        c, p = cache0, pos0
        tok = logit.argmax(-1)[:, None].to(torch.int32)
        outs = []
        for _ in range(20):
            logits, c = step(c, tok, p)
            tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            outs.append(tok)
            p = p + 1
        runs.append((torch.cat(outs, 1), logits, c))
    (te, le, ce), (tc, lc, cc) = runs
    assert torch.equal(te, tc)
    assert chip_smoke.same_state((lc, cc), (le, ce))


def test_fake_cuda_inputs_take_the_shape_only_route(dev):
    """ROADMAP A16: fake CUDA tensors (the dry run's) go through the scan's
    operators and the compaction kernels' without a launch, with the
    kernels' shapes and dtypes; real CUDA tensors launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    args = scan_inputs(np.random.default_rng(3), 2, 16, 64, 16, dev,
                       torch.bfloat16, True)
    real = one_launch("selective_scan", lambda: ops.selective_scan(*args))
    before = ops.launch_counts()
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t).requires_grad_(t.is_floating_point())
                for t in args]
        y, h = ops.selective_scan(*fake)
        grads = torch.autograd.grad(y.sum(), fake)
        keys = mode.from_tensor(torch.zeros((64, 4), dtype=torch.int32,
                                            device=dev))
        count = mode.from_tensor(torch.tensor(64, device=dev))
        outs = [ops.bitonic_sort(keys), ops.crc32_sections([keys]),
                *ops.prefix_encode_wire(keys, count),
                ops.bloom_build(keys.reshape(4, 16, 4), n_words=5,
                                n_probes=6)]
    assert ops.launch_counts() == before
    assert [(t.shape, t.dtype, t.device.type) for t in (y, h)] == [
        (r.shape, r.dtype, "cuda") for r in real]
    assert [g.shape for g in grads] == [t.shape for t in args]
    assert [tuple(t.shape) for t in outs] == [(64, 4), (64,), (64,),
                                              (64, 4), (4, 5)]
