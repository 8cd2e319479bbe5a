"""The port's compaction pipeline against the JAX package's, bit for bit.

Inputs are SST images that ``repro.core.offload.build_image`` builds from
seeded entries (sorted runs with overlapping keys, overwrites and
tombstones).  ``repro_torch.core.compaction.compact`` on the CPU must give
the same image and stats as ``repro.core.compaction.compact(backend="ref")``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compaction as jcompaction
from repro.core import formats as jformats
from repro.core import offload as joffload
from repro_torch.core import compaction, formats, offload
from repro_torch.core.formats import SSTGeometry
from repro_torch.lsm.engine import TorchCompactionEngine

KW = dict(key_bytes=16, value_bytes=32, block_bytes=512, sst_bytes=2048)
GEOM = SSTGeometry(**KW)
JGEOM = jformats.SSTGeometry(**KW)
K = GEOM.block_kvs


def _entries(rng, n, seq0, keyspace=60):
    """n sorted unique-key entries with sequence numbers from seq0; about
    a fifth are tombstones."""
    ids = np.sort(rng.choice(keyspace, n, replace=False))
    keys = np.stack([jformats.pack_key_bytes(b"k%05d" % i, 16) for i in ids])
    is_value = rng.random(n) > 0.2
    meta = ((np.arange(n, dtype=np.uint32) + seq0) << 1) | is_value
    vals = rng.integers(0, 2**32, (n, GEOM.value_words), dtype=np.uint32)
    return keys, meta.astype(np.uint32), vals


@functools.lru_cache(maxsize=None)
def _run_images(n_runs: int, seed: int = 0):
    """``n_runs`` host images (numpy) from the JAX flush path."""
    rng = np.random.default_rng(seed + n_runs)
    images = []
    for r in range(n_runs):
        n = int(rng.integers(K, 3 * K))
        keys, meta, vals = _entries(rng, n, seq0=1 + 1000 * r)
        img = joffload.build_image(jnp.asarray(keys), jnp.asarray(meta),
                                   jnp.asarray(vals), geom=JGEOM,
                                   backend="ref")
        images.append(tuple(np.asarray(a) for a in img))
    return images


def _jax_compact(images, *, bottom, sort_mode="merge", pad_blocks=None):
    jimgs = [jformats.SSTImage(*(jnp.asarray(a) for a in im))
             for im in images]
    img, run_lens = jformats.concat_images(jimgs, with_runs=True)
    if pad_blocks is not None:
        img, run_lens = joffload.pad_image_blocks(img, pad_blocks, JGEOM,
                                                  run_lens=run_lens)
    out, st = jcompaction.compact(
        img, geom=JGEOM, bottom_level=bottom, sort_mode=sort_mode,
        backend="ref", run_lens=run_lens if sort_mode == "merge" else None)
    return (tuple(np.asarray(a) for a in out),
            tuple(int(x) for x in st))


def _port_compact(images, *, bottom, sort_mode="merge", pad_blocks=None):
    ex = offload.CompactionExecutor(GEOM, device="cpu", sort_mode=sort_mode)
    timgs = [formats.image_from_numpy(im, "cpu") for im in images]
    out, st = ex.compact(timgs, bottom_level=bottom, pad_blocks=pad_blocks)
    return tuple(formats.image_to_numpy(out)), tuple(int(x) for x in st)


def _assert_images_equal(got, want):
    for name, a, b in zip(formats.SSTImage._fields, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(np.uint32),
                                      b.astype(np.uint32), err_msg=name)


def _cpu_engine_compact(images, *, bottom):
    """The JAX package's numpy engine (bit-identical to its device
    pipeline, no compile); its image is trimmed of padding blocks."""
    from repro.lsm.cpu_engine import CpuCompactionEngine
    out, es = CpuCompactionEngine(JGEOM).compact(
        [jformats.SSTImage(*im) for im in images], bottom_level=bottom)
    return tuple(out), (es.n_input, es.n_live, es.n_dropped, int(es.crc_ok),
                        es.bytes_out)


# each (runs, pad, bottom) is one jit compile of the JAX pipeline, so half
# of the combinations are held against the JAX package's numpy engine
@pytest.mark.parametrize("n_runs,pad,bottom,against", [
    (1, False, True, "pipeline"), (2, False, False, "pipeline"),
    (3, True, True, "pipeline"), (5, True, False, "pipeline"),
    (1, False, False, "cpu_engine"), (2, False, True, "cpu_engine"),
    (3, True, False, "cpu_engine"), (5, True, True, "cpu_engine")])
def test_compact_matches_jax(n_runs, pad, bottom, against):
    images = _run_images(n_runs)
    blocks = sum(im[0].shape[0] for im in images)
    pad_blocks = offload.next_pow2(blocks + 1) if pad else None
    got, got_st = _port_compact(images, bottom=bottom, pad_blocks=pad_blocks)
    assert got_st[3] == 1   # crc_ok
    if against == "pipeline":
        want, want_st = _jax_compact(images, bottom=bottom,
                                     pad_blocks=pad_blocks)
        _assert_images_equal(got, want)
        assert got_st == want_st
    else:
        from repro_torch.lsm.sstable import trim_image
        want, want_st = _cpu_engine_compact(images, bottom=bottom)
        _assert_images_equal(trim_image(got), trim_image(want))
        assert got_st[:4] + got_st[5:] == want_st


def test_compact_xla_sort_mode_matches_jax():
    images = _run_images(3)
    got, got_st = _port_compact(images, bottom=False, sort_mode="xla")
    want, want_st = _jax_compact(images, bottom=False, sort_mode="xla")
    _assert_images_equal(got, want)
    assert got_st == want_st


def test_cooperative_sort_matches_merge():
    images = _run_images(3)
    got, got_st = _port_compact(images, bottom=True,
                                sort_mode="cooperative")
    want, want_st = _port_compact(images, bottom=True)
    _assert_images_equal(got, want)
    assert got_st == want_st


@pytest.mark.parametrize("field,index", [("vals", (1, 3, 2)),
                                         ("keys", (0, 0, 3)),
                                         ("crc", (2,))])
def test_flipped_bit_fails_crc(field, index):
    images = [list(im) for im in _run_images(2)]
    i = formats.SSTImage._fields.index(field)
    a = images[0][i].copy()
    a[index] ^= np.uint32(1 << 7)
    images[0][i] = a
    _, got_st = _port_compact(images, bottom=False)
    _, want_st = _jax_compact(images, bottom=False)
    assert got_st[3] == 0 and want_st[3] == 0


def test_debug_check_runs_rejects_an_unsorted_run():
    images = [list(im) for im in _run_images(2)]
    keys = images[1][0].copy()
    keys[0, [0, 1]] = keys[0, [1, 0]]     # swap two full keys of a block
    images[1][0] = keys
    ex = offload.CompactionExecutor(GEOM, device="cpu", debug_check_runs=True)
    timgs = [formats.image_from_numpy(im, "cpu") for im in images]
    with pytest.raises(AssertionError, match="run 1"):
        ex.compact(timgs)
    ex.compact(timgs[:1])   # the sorted run alone passes


def test_merge_requires_run_lens():
    img = formats.image_from_numpy(_run_images(1)[0], "cpu")
    with pytest.raises(ValueError, match="run_lens"):
        compaction.compact(img, geom=GEOM, sort_mode="merge")


def _unique_key_image():
    """The input of ROADMAP C1 and C2: ``build_image`` of 40 sorted unique
    keys (uint32 ``[n, 4]`` lanes from ``default_rng(0)``), ``meta = seq <<
    1 | 1`` and 8 value words, as host arrays."""
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 2**32, (40, 4), dtype=np.uint32),
                     axis=0)
    assert keys.shape == (40, 4)
    meta = (np.arange(1, 41, dtype=np.uint32) << 1) | 1
    vals = rng.integers(0, 2**32, (40, GEOM.value_words), dtype=np.uint32)
    img = joffload.build_image(jnp.asarray(keys), jnp.asarray(meta),
                               jnp.asarray(vals), geom=JGEOM, backend="ref")
    return tuple(np.asarray(a) for a in img)


def test_compact_defaults_match_jax():
    """ROADMAP C1: ``compact`` with ``geom`` alone (the default sort mode,
    ``"device"`` in both packages) gives JAX's image, byte for byte."""
    im = _unique_key_image()
    want, want_st = jcompaction.compact(
        jformats.SSTImage(*(jnp.asarray(a) for a in im)), geom=JGEOM,
        backend="ref")
    got, got_st = compaction.compact(formats.image_from_numpy(im, "cpu"),
                                     geom=GEOM)
    for name, a, b in zip(formats.SSTImage._fields,
                          formats.image_to_numpy(got), want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert tuple(int(x) for x in got_st) == tuple(int(x) for x in want_st)
    assert int(got_st.n_live) == 40


def test_merge_sort_phase_takes_no_run_lens_as_one_run():
    """ROADMAP C2: ``sort_phase(rows, sort_mode="merge")`` without
    ``run_lens`` takes the rows as one sorted run, as JAX's does."""
    im = _unique_key_image()
    jrows = jcompaction.build_tuples(jcompaction.unpack(
        jformats.SSTImage(*(jnp.asarray(a) for a in im)), JGEOM,
        backend="ref"))
    trows = compaction.build_tuples(compaction.unpack(
        formats.image_from_numpy(im, "cpu"), GEOM))
    np.testing.assert_array_equal(trows.numpy().view(np.uint32),
                                  np.asarray(jrows))
    want = jcompaction.sort_phase(jrows, sort_mode="merge", backend="ref")
    got = compaction.sort_phase(trows, sort_mode="merge")
    assert got.shape == (48, 6)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("n,n_live", [(1, None), (K, None), (3 * K + 5, None),
                                      (2 * K, K + 3)])
def test_build_image_matches_jax(n, n_live):
    rng = np.random.default_rng(n)
    keys, meta, vals = _entries(rng, n, seq0=7, keyspace=200)
    want = joffload.build_image(
        jnp.asarray(keys), jnp.asarray(meta), jnp.asarray(vals),
        None if n_live is None else jnp.int32(n_live), geom=JGEOM,
        backend="ref")
    t = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
         for a in (keys, meta, vals)]
    got = offload.build_image(*t, n_live, geom=GEOM)
    _assert_images_equal(formats.image_to_numpy(got),
                         [np.asarray(a) for a in want])


def test_sst_granularity_bloom_matches_jax():
    kw = dict(KW, bloom_granularity="sst")
    geom, jgeom = SSTGeometry(**kw), jformats.SSTGeometry(**kw)
    rng = np.random.default_rng(4)
    keys, meta, vals = _entries(rng, 40, seq0=1, keyspace=100)
    want = joffload.build_image(jnp.asarray(keys), jnp.asarray(meta),
                                jnp.asarray(vals), geom=jgeom, backend="ref")
    t = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
         for a in (keys, meta, vals)]
    got = formats.image_to_numpy(offload.build_image(*t, geom=geom))
    assert got.bloom.shape[0] == 1
    _assert_images_equal(got, [np.asarray(a) for a in want])


def test_pad_image_blocks_matches_jax():
    im = _run_images(1)[0]
    got, got_lens = offload.pad_image_blocks(
        formats.image_from_numpy(im, "cpu"), 8, GEOM, run_lens=(5,))
    want, want_lens = joffload.pad_image_blocks(
        jformats.SSTImage(*(jnp.asarray(a) for a in im)), 8, JGEOM,
        run_lens=(5,))
    _assert_images_equal(formats.image_to_numpy(got),
                         [np.asarray(a) for a in want])
    assert got_lens == want_lens


@pytest.mark.parametrize("n_runs", [1, 3])
def test_image_numpy_round_trip(n_runs):
    for im in _run_images(n_runs):
        dev = formats.image_from_numpy(jformats.SSTImage(*im), "cpu")
        assert all(a.dtype == torch.int32 for a in dev)
        back = formats.image_to_numpy(dev)
        for a, b in zip(back, im):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_engine_compact_matches_jax_engine():
    """The engine pads each run to a pow2 block count and the total to a
    pow2 bucket, as the JAX device engine does; its trimmed output is the
    JAX numpy engine's."""
    from repro_torch.lsm.sstable import trim_image
    images = _run_images(3)
    got, es = TorchCompactionEngine(GEOM, device="cpu").compact(
        [jformats.SSTImage(*im) for im in images], bottom_level=True)
    want, want_st = _cpu_engine_compact(images, bottom=True)
    _assert_images_equal(trim_image(got), trim_image(want))
    assert (es.n_input, es.n_live, es.n_dropped, int(es.crc_ok),
            es.bytes_out) == want_st
    assert es.device_seconds == 0.0   # no device time on the CPU


def test_wire_words_and_meta_seq_match_jax():
    """``formats.wire_words`` and ``formats.meta_seq`` (ROADMAP A20) give
    JAX's rows and sequence numbers, the top meta bit included."""
    for im in _run_images(2):
        got = formats.wire_words(formats.image_from_numpy(im, "cpu"))
        want = jformats.wire_words(jformats.SSTImage(*(jnp.asarray(a)
                                                       for a in im)))
        assert got.shape == (im[0].shape[0], GEOM.wire_words_per_block)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    meta = np.array([0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
                     formats.make_meta(2**31 - 1, 1)], np.uint32)
    got = formats.meta_seq(formats.words_to_tensor(meta, "cpu"))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jformats.meta_seq(meta)))
