"""The port's kernels against the JAX package: each plain PyTorch version
(``repro_torch.kernels.ref``, what the wrappers run on CPU tensors) is held
bit for bit against the Pallas kernel in interpret mode, the jnp oracle in
``repro.kernels.ref`` and, for the CRC, ``binascii.crc32``.  The Pallas
merge does not run on this jax (``pl.Unblocked``), so the merge is held
against ``repro.kernels.ref.merge_runs``.

The CUDA kernels themselves run only on the card: see
``test_torch_cuda.py``.
"""

import binascii
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels import bloom as jbloom
from repro.kernels import crc32 as jcrc32
from repro.kernels import ops as jops
from repro.kernels import prefix as jprefix
from repro.kernels import ref as jref
from repro_torch.core import formats
from repro_torch.kernels import bitonic_sort as tbitonic
from repro_torch.kernels import bloom as tbloom
from repro_torch.kernels import lookup as tlookup
from repro_torch.kernels import merge_path, ops, ref
from repro_torch.kernels import crc32 as tcrc32
from repro_torch.kernels import prefix as tprefix
from repro_torch.kernels import selective_scan as tscan
from repro_torch.kernels import tables

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)   # the prefix step's edge cases


def t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 bit-pattern tensor on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).astype(np.uint32)).view(np.int32))


def u(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def rand_words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def sorted_keys(rng, n: int, lanes: int, distinct: int = 64) -> np.ndarray:
    """Sorted keys with long shared prefixes and duplicates."""
    k = rng.integers(0, distinct, (n, lanes)).astype(np.uint32)
    k[:, 0] = 0x75736572
    k[:, -1] = rng.integers(0, 2**32, n, dtype=np.uint32) >> \
        rng.integers(0, 32, n).astype(np.uint32)
    return k[np.lexsort(tuple(k[:, i] for i in reversed(range(lanes))))]


def lexsorted(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(tuple(rows[:, i]
                                 for i in reversed(range(rows.shape[1]))))]


# ---------------------------------------------------------------------------
# CRC-32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_blocks,n_words", [(1, 4), (3, 16), (8, 64),
                                              (5, 128), (17, 33)])
def test_crc32_words_matches_binascii(n_blocks, n_words):
    rng = np.random.default_rng(n_blocks * 1000 + n_words)
    words = rand_words(rng, (n_blocks, n_words))
    want = np.array([binascii.crc32(r.astype("<u4").tobytes()) & 0xFFFFFFFF
                     for r in words], np.uint32)
    np.testing.assert_array_equal(u(ref.crc32_words(t(words))), want)
    np.testing.assert_array_equal(
        np.asarray(jref.crc32_words(jnp.asarray(words))), want)


@pytest.mark.parametrize("widths,pallas", [
    ((1, 4, 3), True), ((16, 16), False), ((2, 30, 12, 20), False),
    ((1, 16, 4, 32, 4), True)])
def test_crc32_sections_match_pallas_and_ref(widths, pallas):
    rng = np.random.default_rng(sum(widths))
    parts = [rand_words(rng, (6, w)) for w in widths]
    got = u(ops.crc32_sections([t(p) for p in parts]))
    concat = np.concatenate(parts, axis=1)
    want = np.array([binascii.crc32(r.astype("<u4").tobytes()) & 0xFFFFFFFF
                     for r in concat], np.uint32)
    np.testing.assert_array_equal(got, want)
    oracle = np.asarray(jax.jit(jref.crc32_words_sections)(
        [jnp.asarray(p) for p in parts]))
    np.testing.assert_array_equal(oracle, want)
    if pallas:   # interpret mode is slow: two of the width sets
        np.testing.assert_array_equal(np.asarray(
            jcrc32.crc32_blocks_sections(
                tuple(jnp.asarray(p) for p in parts), interpret=True)), want)


@pytest.mark.parametrize("n_blocks,n_words,backend", [
    (1, 4, "ref"), (5, 39, "ref"), (3, 1185, "ref"), (4, 16, "pallas")])
def test_ops_crc32_blocks_matches_jax(n_blocks, n_words, backend):
    """``ops.crc32_blocks`` (ROADMAP A20) equals JAX's ``ops.crc32_blocks``
    and ``binascii.crc32`` on seeded words."""
    rng = np.random.default_rng(n_blocks * n_words)
    words = rand_words(rng, (n_blocks, n_words))
    got = u(ops.crc32_blocks(t(words)))
    want = np.asarray(jops.crc32_blocks(jnp.asarray(words), backend=backend))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [binascii.crc32(r.astype("<u4").tobytes())
                            for r in words]


def test_crc32_detects_a_flipped_bit():
    rng = np.random.default_rng(3)
    words = rand_words(rng, (4, 40))
    good = u(ref.crc32_words(t(words)))
    words[2, 17] ^= np.uint32(1 << 9)
    bad = u(ref.crc32_words(t(words)))
    assert (good != bad).tolist() == [False, False, True, False]


def raw_crc(data: bytes) -> int:
    """The CRC register after ``data`` from zero, without the inversions:
    ``binascii.crc32`` less the zero-message constant of its length."""
    return (binascii.crc32(data) ^ binascii.crc32(bytes(len(data)))) \
        & 0xFFFFFFFF


@pytest.mark.parametrize("seed", range(6))
def test_crc32_shift_operator_appends_zero_bytes(seed):
    """``raw(A || B) == shift(raw(A), len B) ^ raw(B)`` over random byte
    lengths (0 and lengths that are not whole words among them), the
    operators from ``tables.crc32_shift_columns``."""
    rng = np.random.default_rng(seed)
    la, lb = (int(x) for x in rng.integers(0, 5000, 2))
    if seed == 0:
        lb = 0
    a = rng.integers(0, 256, la, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, lb, dtype=np.uint8).tobytes()
    cols = tables.crc32_shift_columns([lb])[0]
    got = int(tables.crc32_apply_shift(cols, np.uint32(raw_crc(a)))) ^ \
        raw_crc(b)
    assert got == raw_crc(a + b)
    # the kernel's word-at-a-time walk gives the same register
    if la % 4 == 0:
        words = np.frombuffer(a, "<u4")
        assert int(tables.crc32_raw_words(words)) == raw_crc(a)


@pytest.mark.parametrize("widths", [
    (1, 64, 16, 1088, 16),           # the paper geometry: W = 1185
    (1,), (3,), (7, 300), (5, 33, 2, 40, 1),
    (1, 64, 16, 2176, 16),           # two chunks and a ragged third
    (1248,), (1249,), (96,), (97,)])
def test_crc32_segmented_walk_matches_binascii_and_ref(widths):
    """The numpy walk of the card's segmented algorithm is bit-identical to
    ``binascii.crc32`` and to the plain version on every row, including
    widths that do not divide into whole runs or chunks."""
    rng = np.random.default_rng(sum(widths))
    parts = [rand_words(rng, (5, w)) for w in widths]
    concat = np.concatenate(parts, axis=1)
    want = np.array([binascii.crc32(r.astype("<u4").tobytes()) & 0xFFFFFFFF
                     for r in concat], np.uint32)
    np.testing.assert_array_equal(tables.crc32_segmented(concat), want)
    np.testing.assert_array_equal(
        u(ref.crc32_words_sections([t(p) for p in parts])), want)
    run, chunk, n_chunks, last = tables.crc32_run_plan(concat.shape[1])
    assert run % 2 == 1 and run <= tables.CRC32_MAX_RUN
    assert chunk == tables.CRC32_RUNS * run and (n_chunks - 1) * chunk + last == \
        concat.shape[1] and 1 <= last <= chunk
    _, table = tables.crc32_kernel_tables(concat.shape[1])
    assert table.dtype == np.uint32 and \
        table.shape == (256 + 32 * tables.CRC32_SLOTS,)


# ---------------------------------------------------------------------------
# shared-prefix encode / decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,lanes,restart", [(16, 4, 16), (64, 4, 16),
                                             (96, 2, 8), (256, 4, 16)])
def test_prefix_encode_matches_pallas_and_ref(n, lanes, restart):
    rng = np.random.default_rng(n + lanes)
    keys = sorted_keys(rng, n, lanes)
    got = ops.prefix_encode(t(keys), restart_interval=restart).numpy()
    pallas = np.asarray(jprefix.prefix_encode(
        jnp.asarray(keys), restart_interval=restart, interpret=True))
    oracle = np.asarray(jref.prefix_encode(jnp.asarray(keys),
                                           restart_interval=restart))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
    assert got.dtype == np.int32 and got[::restart].max() == 0


@pytest.mark.parametrize("n,lanes", [(32, 4), (128, 4), (64, 2)])
def test_prefix_decode_matches_ref(n, lanes):
    rng = np.random.default_rng(7 * n + lanes)
    keys = sorted_keys(rng, n, lanes)
    shared = np.asarray(jref.prefix_encode(jnp.asarray(keys),
                                           restart_interval=16))
    raw = np.asarray(jformats.zero_prefix_lanes(jnp.asarray(keys),
                                                jnp.asarray(shared)))
    # garbage in the shared prefix bytes must not leak through
    raw_dirty = raw | (rand_words(rng, raw.shape) &
                       ~np.asarray(jformats.zero_prefix_lanes(
                           jnp.full(raw.shape, 0xFFFFFFFF, jnp.uint32),
                           jnp.asarray(shared))))
    got = u(ops.prefix_decode(torch.from_numpy(shared.copy()), t(raw_dirty),
                              restart_interval=16))
    want = np.asarray(jax.jit(functools.partial(
        jref.prefix_decode, restart_interval=16))(
            jnp.asarray(shared), jnp.asarray(raw_dirty)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, keys)


@pytest.mark.parametrize("n,lanes,restart", chip_smoke.PREFIX_EDGES,
                         ids=str)
def test_prefix_encode_edges_match_pallas(n, lanes, restart):
    """The shared-only route at phase 2's edge table (lanes 1 to 10,
    restart 16, 12 and 24, one interval alone) equals the Pallas kernel."""
    keys = chip_smoke.prefix_edge_keys(n, lanes, restart)
    got = ops.prefix_encode(t(keys), restart_interval=restart).numpy()
    want = np.asarray(jprefix.prefix_encode(
        jnp.asarray(keys), restart_interval=restart, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got.max() == 4 * lanes   # repeated rows share every byte


@pytest.mark.parametrize("n,lanes,restart,count", [
    (*case, c) for case in chip_smoke.PREFIX_EDGES
    for c in chip_smoke.prefix_edge_counts(case[0], case[2])], ids=str)
def test_prefix_encode_wire_matches_jax(n, lanes, restart, count):
    """``ops.prefix_encode_wire`` (on the CPU its plain version, what the
    pack runs) equals the JAX pack's two steps, bit for bit: the Pallas
    kernel's lengths masked to the survivors, then
    ``formats.zero_prefix_lanes``; at 0, 1, a restart point, mid-interval
    and all rows surviving."""
    keys = chip_smoke.prefix_edge_keys(n, lanes, restart)
    shared, wire = ops.prefix_encode_wire(
        t(keys), torch.tensor(count), restart_interval=restart)
    j_shared = jnp.where(jnp.arange(n) < count, jprefix.prefix_encode(
        jnp.asarray(keys), restart_interval=restart, interpret=True), 0)
    j_wire = jformats.zero_prefix_lanes(jnp.asarray(keys), j_shared)
    np.testing.assert_array_equal(shared.numpy(), np.asarray(j_shared))
    np.testing.assert_array_equal(u(wire), np.asarray(j_wire))
    assert shared.dtype == torch.int32 and not shared[count:].any()
    np.testing.assert_array_equal(u(wire)[count:], keys[count:])


def test_zero_prefix_lanes_and_bytes_match_jax():
    rng = np.random.default_rng(0)
    keys = rand_words(rng, (64, 4))
    shared = rng.integers(0, 17, 64).astype(np.int32)
    got = u(formats.zero_prefix_lanes(t(keys), torch.from_numpy(shared)))
    want = np.asarray(jformats.zero_prefix_lanes(jnp.asarray(keys),
                                                 jnp.asarray(shared)))
    np.testing.assert_array_equal(got, want)
    kb = ref.u32_to_bytes(t(keys))
    np.testing.assert_array_equal(
        kb.numpy(), np.asarray(jref.u32_to_bytes(jnp.asarray(keys))))
    np.testing.assert_array_equal(u(ref.bytes_to_u32(kb)), keys)


# ---------------------------------------------------------------------------
# bloom build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups,per,lanes,n_words,probes,p_valid", [
    (4, 16, 4, 5, 6, 1.0), (7, 16, 4, 5, 6, 0.7), (2, 256, 4, 80, 6, 0.9),
    (1, 512, 2, 160, 3, 0.5), (3, 16, 4, 2, 1, 0.0)])
def test_bloom_build_matches_pallas_and_ref(groups, per, lanes, n_words,
                                            probes, p_valid):
    rng = np.random.default_rng(groups * per + probes)
    keys = rand_words(rng, (groups, per, lanes))
    valid = rng.random((groups, per)) < p_valid
    got = u(ops.bloom_build(t(keys), torch.from_numpy(valid),
                            n_words=n_words, n_probes=probes))
    pallas = np.asarray(jbloom.bloom_build(
        jnp.asarray(keys), jnp.asarray(valid.astype(np.uint32)),
        n_words=n_words, n_probes=probes, interpret=True))
    oracle = np.asarray(jref.bloom_build(
        jnp.asarray(keys), n_words=n_words, n_probes=probes,
        valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("per,n_words,lanes", [
    (1, 5, 1), (2, 5, 2), (3, 2, 4), (16, 5, 16), (17, 5, 32), (33, 13, 32),
    (16_384, 5, 32), (16, 32, 16), (16, 33, 0), (700, 219, 0),
    (16_384, 5_120, 0), (1, 5_120, 0)])
def test_bloom_build_route_by_shape(per, n_words, lanes):
    """The build's route, chosen on the host by shape: a sub-warp of the
    power of two >= min(keys, 32) lanes a group for a row of up to 32
    words (the paper's 16 keys and 5 words: two groups a warp), one block
    a group (0) beyond."""
    assert tbloom.build_lanes(per, n_words) == lanes
    assert tbloom.SHORT_WORDS == 32


def test_bloom_hashes_match_ref():
    rng = np.random.default_rng(11)
    keys = rand_words(rng, (3, 50, 4))
    h1, h2 = ref.bloom_hashes(t(keys))
    j1, j2 = jref.bloom_hashes(jnp.asarray(keys))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2).astype(np.int64))


# ---------------------------------------------------------------------------
# run-aware merge and tuple sort
# ---------------------------------------------------------------------------


def _runs(rng, lens, lanes=6, distinct=4, pad_runs=()):
    """Sorted runs back to back; runs whose index is in ``pad_runs`` are
    all-ones sentinel rows.  Keys repeat across and within runs."""
    parts = []
    for i, n in enumerate(lens):
        if i in pad_runs:
            parts.append(np.full((n, lanes), 0xFFFFFFFF, np.uint32))
        else:
            r = rng.integers(0, distinct, (n, lanes)).astype(np.uint32)
            r[:, 1] = rng.integers(0, 2**32, n, dtype=np.uint32) | \
                (np.uint32(1) << np.uint32(31))   # above int32 range
            parts.append(lexsorted(r))
    return np.concatenate(parts) if parts else np.zeros((0, lanes),
                                                        np.uint32)


MERGE_CASES = [
    ((40,), ()),                      # k = 1: passthrough
    ((32, 32), ()),
    ((10, 0, 25, 7), ()),             # zero-length run
    ((16, 16, 16, 16, 48), (4,)),     # trailing padding run
    ((20, 20), (0, 1)),               # all padding
    ((5, 9, 13, 2, 30, 1), ()),
]


@pytest.mark.parametrize("lens,pad_runs", MERGE_CASES)
def test_merge_runs_matches_ref(lens, pad_runs):
    rng = np.random.default_rng(sum(lens) + len(lens))
    rows = _runs(rng, lens, pad_runs=pad_runs)
    got = u(ops.merge_runs(t(rows), lens))
    want = np.asarray(jax.jit(functools.partial(
        jref.merge_runs, run_lens=tuple(lens)))(jnp.asarray(rows)))
    np.testing.assert_array_equal(got, want)
    assert merge_path.rows_sorted(got)


def _merge_along_plan(rows: torch.Tensor, lens) -> torch.Tensor:
    """The kernel's schedule walked with the plain two-run merge: each
    level's pairs read and write the buffers the plan names (0 the input,
    1 and 2 scratch); the result is buffer 1."""
    plan = merge_path.plan_levels(tuple(lens))
    if not plan:
        return rows
    bufs = [rows, torch.full_like(rows, -1), torch.full_like(rows, -1)]
    for level in plan:
        for p in level.pairs:
            assert p.dst in (1, 2) and p.dst not in (p.src_a, p.src_b)
            mid, end = p.off + p.len_a, p.off + p.len_a + p.len_b
            bufs[p.dst][p.off:end] = ref.merge_sorted(
                bufs[p.src_a][p.off:mid], bufs[p.src_b][mid:end])
    return bufs[1]


@pytest.mark.parametrize("lens,pad_runs", MERGE_CASES + [
    ((9, 3, 0, 14, 1, 6, 6, 20, 2, 11, 5, 8, 1, 30, 4, 7, 13, 2), ())])
def test_merge_along_plan_levels_matches_ref(lens, pad_runs):
    """Merging along ``plan_levels`` (as the kernel's launches do, with
    the plain two-run merge) gives the plain merge and JAX's; the last
    case has 17 non-empty runs."""
    rng = np.random.default_rng(sum(lens) + len(lens))
    rows = _runs(rng, lens, pad_runs=pad_runs)
    got = u(_merge_along_plan(t(rows), lens))
    np.testing.assert_array_equal(got, u(ref.merge_runs(t(rows), lens)))
    want = np.asarray(jax.jit(functools.partial(
        jref.merge_runs, run_lens=tuple(lens)))(jnp.asarray(rows)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lens", [
    (40,), (0, 40, 0), (32, 32), (10, 0, 25, 7), (1,) * 6,
    (5, 9, 13, 2, 30, 1), (3,) * 16, (3,) * 17, (2,) * 150])
def test_plan_levels_carries_runs_in_place(lens):
    """``ceil(log2 k')`` levels for ``k'`` non-empty runs; at each level
    the pairs and the carried run tile the rows in order, every operand is
    read from the buffer where it lies (an input run in buffer 0, a merged
    one where its pair wrote it, a carried one where it was), and a carried
    run is not written: no run is copied."""
    plan = merge_path.plan_levels(tuple(lens))
    k = sum(1 for n in lens if n)
    assert len(plan) == (k - 1).bit_length()
    offs = np.cumsum((0,) + lens)
    where = {(int(o), n): 0 for o, n in zip(offs, lens) if n}
    for level in plan:
        spans = sorted([(p.off, p.len_a + p.len_b) for p in level.pairs] +
                       [(o, n) for o, n, _ in level.carried])
        assert spans[0][0] == 0 and sum(n for _, n in spans) == sum(lens)
        assert all(a + n == b for (a, n), (b, _) in zip(spans, spans[1:]))
        assert len(level.carried) <= 1
        nxt = {}
        for p in level.pairs:
            assert where.pop((p.off, p.len_a)) == p.src_a
            assert where.pop((p.off + p.len_a, p.len_b)) == p.src_b
            nxt[(p.off, p.len_a + p.len_b)] = p.dst
        for o, n, buf in level.carried:
            assert where.pop((o, n)) == buf
            nxt[(o, n)] = buf
        assert not where
        where = nxt
    if plan:
        assert where == {(0, sum(lens)): 1}


def test_merge_runs_with_index_lane_equals_stable_sort():
    rng = np.random.default_rng(5)
    lens = (30, 17, 50)
    rows = _runs(rng, lens, lanes=5)
    rows = np.concatenate(
        [rows, np.arange(rows.shape[0], dtype=np.uint32)[:, None]], axis=1)
    got = u(ops.merge_runs(t(rows), lens))
    np.testing.assert_array_equal(got, u(ops.sort_tuples(t(rows))))
    np.testing.assert_array_equal(got, lexsorted(rows))


def test_merge_runs_rejects_bad_run_lens():
    with pytest.raises(ValueError):
        ops.merge_runs(t(np.zeros((10, 6), np.uint32)), (4, 4))


def test_assert_runs_sorted():
    rows = np.array([[1, 2], [1, 3], [0, 9], [5, 0]], np.uint32)
    merge_path.assert_runs_sorted(rows, (2, 2))
    with pytest.raises(AssertionError):
        merge_path.assert_runs_sorted(rows, (3, 1))


@pytest.mark.parametrize("jobs", [None, 3])
def test_merge_runs_debug_check_asserts_sorted_runs_as_jax(jobs):
    """ROADMAP A20: ``ops.merge_runs(..., debug_check=True)`` asserts the
    sorted-run precondition on the host as JAX's does (``ops.py:136``),
    each job of a batch on its own."""
    rng = np.random.default_rng(20)
    lens = (30, 17)
    good = _runs(rng, lens, lanes=3)
    bad = good.copy()
    bad[:30] = bad[:30][::-1]
    assert len(np.unique(bad[:30], axis=0)) > 1
    for rows, sorted_ in ((good, True), (bad, False)):
        stack = rows if jobs is None else np.stack([good] * (jobs - 1)
                                                   + [rows])
        if sorted_:
            got = u(ops.merge_runs(t(stack), lens, debug_check=True))
            np.testing.assert_array_equal(got, u(ops.merge_runs(t(stack),
                                                                lens)))
            np.testing.assert_array_equal(
                np.asarray(jops.merge_runs(jnp.asarray(rows), lens,
                                           backend="ref",
                                           debug_check=True)),
                got if jobs is None else got[-1])
        else:
            with pytest.raises(AssertionError):
                ops.merge_runs(t(stack), lens, debug_check=True)
            with pytest.raises(AssertionError):
                jops.merge_runs(jnp.asarray(rows), lens, backend="ref",
                                debug_check=True)


def test_value_types_and_multi_probe_are_jaxs_names():
    """ROADMAP A20: ``formats.VALUE_TYPE`` / ``DELETE_TYPE`` (JAX
    ``formats.py:116-117``) and ``bloom.multi_probe`` (JAX
    ``bloom.py:159``), the latter's plain version against JAX's Pallas
    kernel in interpret mode."""
    assert (formats.VALUE_TYPE, formats.DELETE_TYPE) == (
        jformats.VALUE_TYPE, jformats.DELETE_TYPE) == (1, 0)
    for seq in (0, 7, 2**30):
        for kind in (formats.VALUE_TYPE, formats.DELETE_TYPE):
            assert formats.make_meta(seq, kind) == int(
                jformats.make_meta(seq, kind))
    assert tbloom.multi_probe is tbloom.bloom_multi_probe
    rng = np.random.default_rng(21)
    filters, keys = rand_words(rng, (40, 7)), rand_words(rng, (40, 4))
    want = np.asarray(jbloom.multi_probe(jnp.asarray(filters),
                                         jnp.asarray(keys), n_probes=6,
                                         interpret=True))
    got = ops.bloom_multi_probe(t(filters), t(keys), n_probes=6).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes,tile", [
    (1, 2048), (6, 2048), (8, 2048), (9, 2048), (10, 2048), (12, 2048),
    (13, 1024), (24, 1024), (100, 128), (12_288, 2)])
def test_sort_tile_by_lanes(lanes, tile):
    """Rows up to 8 lanes sort in registers in tiles of 2,048; wider rows
    in shared memory, in the largest power-of-two tile that fits 96 KB."""
    assert tbitonic.tile_rows(lanes) == tile
    assert tile * lanes * 4 <= tbitonic.WIDE_SMEM_BYTES or lanes <= 8


def test_sort_tile_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError, match="do not fit"):
        tbitonic.tile_rows(12_289)
    with pytest.raises(ValueError):
        tbitonic.tile_rows(0)


@pytest.mark.parametrize("n,lanes,launches", [
    (1, 6, 1), (2047, 6, 1), (2048, 6, 1), (2049, 6, 2), (6149, 6, 3),
    (65_536, 6, 6), (262_144, 6, 8), (300_001, 6, 10), (4097, 10, 3),
    (3000, 13, 3), (0, 6, 0)])
def test_sort_plan(n, lanes, launches):
    """The sort's host plan: tiles of ``tile_rows(lanes)`` rows (the last
    one short), the merge tree of ``merge_path.plan_levels`` over them,
    and one launch for the tiles plus one a level table: 6 at 65,536 rows
    and 8 at 262,144 (no level of 262,144 rows splits past MAX_PAIRS);
    300,001 rows (147 tiles) split the first level in two."""
    assert tbitonic.launches(n, lanes) == launches
    if n == 0:
        return
    tile, counts, pairs, n_bufs = tbitonic.plan(n, lanes)
    runs = tbitonic.tile_lens(n, tile)
    assert sum(runs) == n and all(r == tile for r in runs[:-1])
    assert 0 < runs[-1] <= tile
    levels = merge_path.plan_levels(runs)
    assert len(counts) == launches - 1 >= len(levels)
    assert sum(counts) == sum(len(lv.pairs) for lv in levels)
    assert max(counts, default=0) <= merge_path.MAX_PAIRS
    assert list(pairs) == [x for lv in levels for p in lv.pairs for x in p]
    # buffer 0 takes the tiles, 1 the result, 2 where a pair writes it
    assert n_bufs == 1 + bool(levels) + any(
        p.dst == 2 for lv in levels for p in lv.pairs)


def test_sort_along_plan_matches_ref():
    """The sort's schedule walked on the CPU: the tiles sorted by the plain
    sort, then the plan's levels merged as the kernels merge them, equal
    the plain sort of the whole."""
    rng = np.random.default_rng(20)
    n, lanes = 5000, 3
    rows = t(rng.integers(0, 5, (n, lanes)).astype(np.uint32))
    tile = tbitonic.tile_rows(lanes)
    runs = tbitonic.tile_lens(n, tile)
    tiles = torch.cat([ref.sort_tuples(rows[o:o + ln]) for o, ln in zip(
        np.cumsum((0,) + runs[:-1]), runs)])
    np.testing.assert_array_equal(
        u(_merge_along_plan(tiles, runs)), u(ref.sort_tuples(rows)))


@pytest.mark.parametrize("num_keys", [None, 2, 6])
def test_sort_tuples_matches_ref(num_keys):
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 3, (200, 6)).astype(np.uint32)
    rows[:, 2] = rng.integers(0, 2**32, 200, dtype=np.uint32)
    got = u(ops.sort_tuples(t(rows), num_keys))
    want = np.asarray(jref.sort_tuples(jnp.asarray(rows),
                                       num_keys or rows.shape[1]))
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = ops.launch_counts()
    rng = np.random.default_rng(1)
    ops.crc32_sections([t(rand_words(rng, (2, 8)))])
    ops.prefix_encode(t(sorted_keys(rng, 16, 4)))
    ops.prefix_encode_wire(t(sorted_keys(rng, 16, 4)), torch.tensor(9))
    ops.crc32_blocks(t(rand_words(rng, (2, 8))))
    ops.bloom_build(t(rand_words(rng, (2, 16, 4))), n_words=5, n_probes=6)
    ops.merge_runs(t(_runs(rng, (8, 8))), (8, 8))
    ops.bloom_multi_probe(t(rand_words(rng, (3, 5))),
                          t(rand_words(rng, (3, 4))), n_probes=6)
    ops.bloom_query(t(rand_words(rng, (2, 5))),
                    t(rand_words(rng, (2, 3, 4))), n_probes=6)
    z = torch.zeros
    ops.lookup_blocks(z((2, 16, 4), dtype=torch.int32),
                      z((2, 16), dtype=torch.int32),
                      z((2, 16, 3), dtype=torch.int32),
                      z(2, dtype=torch.int32), z((2, 4), dtype=torch.int32))
    ops.bitonic_sort(t(_runs(rng, (8,))))
    ops.selective_scan(*(torch.ones(s) for s in ((1, 4, 8), (1, 4, 8),
                                                 (1, 4, 2), (1, 4, 2), (8, 2),
                                                 (8,))))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("call", [
    lambda: tcrc32.crc32_blocks(torch.zeros((2, 4), dtype=torch.int32)),
    lambda: tprefix.prefix_encode(torch.zeros((16, 4), dtype=torch.int32)),
    lambda: tprefix.prefix_encode_wire(torch.zeros((16, 4), dtype=torch.int32),
                                       torch.tensor(3)),
    lambda: merge_path.merge_runs(torch.zeros((4, 6), dtype=torch.int32),
                                  (2, 2)),
    lambda: tbloom.bloom_multi_probe(torch.zeros((2, 5), dtype=torch.int32),
                                     torch.zeros((2, 4), dtype=torch.int32),
                                     n_probes=6),
    lambda: tbloom.bloom_query(torch.zeros((2, 5), dtype=torch.int32),
                               torch.zeros((2, 3, 4), dtype=torch.int32),
                               n_probes=6),
    lambda: tlookup.lookup_blocks(*(torch.zeros(s, dtype=torch.int32) for s in
                                    ((2, 16, 4), (2, 16), (2, 16, 3), (2,),
                                     (2, 4)))),
    lambda: tbitonic.bitonic_sort(torch.zeros((4, 6), dtype=torch.int32)),
    lambda: tscan.selective_scan(*(torch.ones(s) for s in (
        (1, 4, 8), (1, 4, 8), (1, 4, 2), (1, 4, 2), (8, 2), (8,)))),
    lambda: tbloom.bloom_build(torch.zeros((2, 16, 4), dtype=torch.int32),
                               torch.ones((2, 16), dtype=torch.bool),
                               n_words=5, n_probes=6),
], ids=["crc32", "prefix_encode", "prefix_encode_wire", "merge_runs",
        "bloom_multi_probe",
        "bloom_query", "lookup_blocks", "bitonic_sort", "selective_scan",
        "bloom_build"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches or raises: it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
