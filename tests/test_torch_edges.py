"""The sort's and the bloom build's edge tables (``chip_smoke.SORT_EDGES``,
``chip_smoke.BLOOM_EDGES``, which the card checks too) built on the CPU:
each plain output, what the wrappers run on CPU tensors and what the card
is held against, equals the JAX package's Pallas kernel in interpret mode,
``repro.kernels.bitonic_sort.bitonic_sort`` and
``repro.kernels.bloom.bloom_build``, bit for bit.  The PyTorch route timed
beside the sort (``chip_smoke.unique_sort``) equals the sort where rows
are unique.

JAX's sort pads its input to a power of two with all-ones rows, which sort
last; here every case of a lane count is padded the same way to one size
(8,192 rows, or 2**19 for 300,001), so one compile of the network serves
them, and the first ``n`` rows are the JAX function's output.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitonic_sort as jbitonic
from repro.kernels import bloom as jbloom
from repro_torch.kernels import bitonic_sort as sort_plan
from repro_torch.kernels import ops

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def jax_sorted(rows: np.ndarray) -> np.ndarray:
    """``bitonic_sort(interpret=True)`` of ``rows`` padded with all-ones
    rows to 8,192 rows, or to 2**19 past that; the first ``n`` rows."""
    n, lanes = rows.shape
    size = 8192 if n <= 8192 else 1 << 19
    padded = np.full((size, lanes), 0xFFFFFFFF, np.uint32)
    padded[:n] = rows
    out = jbitonic.bitonic_sort(jnp.asarray(padded), interpret=True)
    return np.asarray(out)[:n]


def test_sort_edges_cover_the_tile_edges():
    """``SORT_TILE`` is the plan's tile for every lane count of the table,
    and the table holds one row, two, the tile's edges, three tiles and
    five, and 300,001 rows, each with and without an index lane."""
    for lanes in chip_smoke.SORT_LANES:
        assert sort_plan.tile_rows(lanes) == chip_smoke.SORT_TILE
    T = chip_smoke.SORT_TILE
    assert {n for n, _, _ in chip_smoke.SORT_EDGES} == {
        1, 2, T - 1, T, T + 1, 3 * T + 5, 300_001}
    assert len(chip_smoke.SORT_EDGES) == 7 * len(chip_smoke.SORT_LANES) * 2


@pytest.mark.parametrize("n,lanes,index_lane", chip_smoke.SORT_EDGES)
def test_sort_edge_matches_pallas(n, lanes, index_lane):
    rows = chip_smoke.sort_edge_rows(n, lanes, index_lane)
    assert rows.dtype == np.uint32 and rows.shape == (n, lanes)
    if index_lane:   # unique rows, the top bit set in some index words
        assert len(np.unique(rows[:, -1])) == n
        assert n < 4 or (rows[:, -1] >= 0x80000000).any()
    got = ops.bitonic_sort(t(rows)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, jax_sorted(rows))


@pytest.mark.parametrize("case", chip_smoke.BLOOM_EDGES, ids=str)
def test_bloom_edge_matches_pallas(case):
    keys, valid = chip_smoke.bloom_edge_inputs(*case)
    n_words, probes = case[3], case[4]
    got = ops.bloom_build(t(keys), torch.from_numpy(valid),
                          n_words=n_words, n_probes=probes)
    want = jbloom.bloom_build(
        jnp.asarray(keys), jnp.asarray(valid.astype(np.uint32)),
        n_words=n_words, n_probes=probes, interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    if case[5] == 0.0:
        assert not got.any()


@pytest.mark.parametrize("n,lanes", [(5000, 6), (777, 3)])
def test_unique_route_equals_the_sort_on_unique_rows(n, lanes):
    rows = chip_smoke.sort_edge_rows(n, lanes, True)
    np.testing.assert_array_equal(
        chip_smoke.unique_sort(t(rows)).numpy().view(np.uint32),
        ops.bitonic_sort(t(rows)).numpy().view(np.uint32))
