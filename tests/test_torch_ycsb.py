"""The port's YCSB driver and paper configuration against the JAX
package's, on the CPU: the same seeds give the same streams op for op,
and ``repro_torch.configs.luda_paper`` gives the same fields, geometries,
workloads and scheduler as ``repro.configs.luda_paper``."""

import dataclasses

import numpy as np
import pytest

from repro.configs import luda_paper as jpaper
from repro.data import ycsb as jycsb
from repro_torch.configs import luda_paper
from repro_torch.data import ycsb


@pytest.mark.parametrize("n,theta,seed,size", [
    (10, 0.99, 0, 1000), (1000, 0.99, 7, 5000), (50_000, 0.99, 1, 2000),
    (300, 0.5, 3, 777), (3, 0.8, 11, 64), (1000, 0.99, 5, None)])
def test_zipfian_sample_equals_jax(n, theta, seed, size):
    got = ycsb.ZipfianGenerator(n, theta, seed=seed)
    want = jycsb.ZipfianGenerator(n, theta, seed=seed)
    assert (got.zetan, got.zeta2, got.eta, got.alpha) == \
        (want.zetan, want.zeta2, want.eta, want.alpha)
    for _ in range(2):   # the generator's state advances alike
        a, b = got.sample(size), want.sample(size)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert ((0 <= a) & (a < n)).all()


@pytest.mark.parametrize("seed", [42, 7])
@pytest.mark.parametrize("distribution", ["zipfian", "uniform", "latest"])
@pytest.mark.parametrize("name", ["A", "B", "C", "D"])
def test_streams_equal_jax(name, distribution, seed):
    kw = dict(records=300, operations=900, value_size=100,
              distribution=distribution, seed=seed)
    got = ycsb.YCSBWorkload(ycsb.WorkloadSpec.named(name, **kw))
    want = jycsb.YCSBWorkload(jycsb.WorkloadSpec.named(name, **kw))
    assert list(got.load_ops()) == list(want.load_ops())
    run = list(got.run_ops())
    assert run == list(want.run_ops())
    kinds = {op for op, _, _ in run}
    assert ("insert" in kinds) == (name == "D")
    assert ("update" in kinds) == (name in "AB")


def test_workload_d_inserts_move_the_frontier():
    spec = ycsb.WorkloadSpec.ycsb_d(records=100, operations=2000, seed=3)
    assert spec.distribution == "latest"
    inserted = [k for op, k, _ in ycsb.YCSBWorkload(spec).run_ops()
                if op == "insert"]
    assert inserted == [ycsb.key_of(100 + i) for i in range(len(inserted))]
    assert len(inserted) > 50


def test_key_of_and_named_equal_jax():
    for i in (0, 1, 12345, 2**40 + 3):
        assert ycsb.key_of(i) == jycsb.key_of(i)
    assert ycsb.ZIPF_CONST == jycsb.ZIPF_CONST
    for name in ("A", "b", "C", "d"):
        got = ycsb.WorkloadSpec.named(name, records=9, value_size=64)
        want = jycsb.WorkloadSpec.named(name, records=9, value_size=64)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(ycsb.WorkloadSpec()) == \
        dataclasses.asdict(jycsb.WorkloadSpec())


@pytest.mark.parametrize("make", [
    lambda m: m.WorkloadSpec.named("E"),
    lambda m: m.YCSBWorkload(m.WorkloadSpec(distribution="hotspot")),
], ids=["workload", "distribution"])
def test_errors_equal_jax(make):
    with pytest.raises(ValueError) as want:
        make(jycsb)
    with pytest.raises(ValueError) as got:
        make(ycsb)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["PAPER", "BENCH_SCALE"])
def test_paper_config_equals_jax(which):
    got, want = getattr(luda_paper, which), getattr(jpaper, which)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.scheduler()) == \
        dataclasses.asdict(want.scheduler())
    for v in got.value_sizes:
        g, w = got.geometry(v), want.geometry(v)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.block_kvs, g.sst_kvs, g.wire_words_per_block) == \
            (w.block_kvs, w.sst_kvs, w.wire_words_per_block)
        assert dataclasses.asdict(got.workload(v)) == \
            dataclasses.asdict(want.workload(v))
        assert dataclasses.asdict(got.workload(v, records=5, operations=7)) \
            == dataclasses.asdict(want.workload(v, records=5, operations=7))
        assert dataclasses.asdict(luda_paper.bench_geometry(v)) == \
            dataclasses.asdict(jpaper.bench_geometry(v))


def test_paper_geometry_is_the_stores():
    """The paper's 256 B setting is the store geometry the smoke run's
    phases 3 and 4 drive: 272 B value slots, 4 KB blocks, 4 MB SSTs."""
    g = luda_paper.PAPER.geometry(256)
    assert (g.key_bytes, g.value_bytes, g.block_bytes, g.sst_bytes,
            g.bloom_bits_per_key) == (16, 272, 4096, 4 * 1024 * 1024, 10)
    s = luda_paper.PAPER.scheduler()
    assert (s.l0_trigger, s.base_bytes) == (4, 32 * 1024 * 1024)
