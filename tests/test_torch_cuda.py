"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where no CUDA device
is present; on a machine with an H100 (which has no JAX, so this file
imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import offload
from repro_torch.core.formats import SSTGeometry
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("widths,rows", [((1, 64, 16, 1088, 16), 4096),
                                         ((3,), 5), ((7, 300), 33)])
def test_crc32_sections(dev, widths, rows):
    rng = np.random.default_rng(rows)
    secs = [words(rng, (rows, w), dev) for w in widths]
    before = ops.launch_counts()["crc32_sections"]
    assert torch.equal(ops.crc32_sections(secs),
                       ref.crc32_words_sections(secs))
    assert ops.launch_counts()["crc32_sections"] == before + 1


@pytest.mark.parametrize("n,lanes,restart", [(65_536, 4, 16), (96, 2, 8)])
def test_prefix_encode(dev, n, lanes, restart):
    keys = sorted_rows(np.random.default_rng(n), n, lanes, dev, distinct=3)
    assert torch.equal(ops.prefix_encode(keys, restart_interval=restart),
                       ref.prefix_encode(keys, restart_interval=restart))


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
    ((16_384,) * 4 + (4096,), 4), ((3000, 0, 2500, 4000), 2), ((500,), 0),
    ((16_384,) * 16, 15)])
def test_merge_runs(dev, lens, launches):
    rng = np.random.default_rng(len(lens))
    rows = torch.cat([sorted_rows(rng, n, 6, dev) for n in lens])
    before = ops.launch_counts()["merge_pair"]
    assert torch.equal(ops.merge_runs(rows, lens), ref.merge_runs(rows, lens))
    assert ops.launch_counts()["merge_pair"] == before + launches


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
