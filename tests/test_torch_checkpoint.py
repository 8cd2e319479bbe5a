"""The port's checkpoint store and token data against the JAX package's
(ROADMAP A14), on the CPU: the same trees saved by both stores give the
same SST files, each package restores the other's checkpoints bit for
bit, ``steps`` and ``gc`` behave alike, and ``BigramStream`` /
``make_train_batch`` give the same bytes.

JAX's store runs its numpy engine (``engine="cpu"``: its device engine
would compile XLA programs for minutes here); the port's runs its torch
engine on the CPU (the kernels' plain versions).  The two engines write
the same files (``tests/test_torch_session_store.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_smoke_config as jax_smoke
from repro.core.formats import SSTGeometry as JGeometry
from repro.core.scheduler import SchedulerConfig as JScheduler
from repro.data import tokens as jtokens
from repro.lsm.db import DBConfig as JConfig
from repro.training import optimizer as joptim
from repro.training import train_step as jts
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data import tokens
from repro_torch.lsm.db import DBConfig
from repro_torch.models import convert
from repro_torch.training import optimizer as optim
from repro_torch.training import train_step as ts

# small memtables and SSTs, so that a few saves flush and compact
SMALL = dict(key_bytes=16, value_bytes=store.CHUNK_BYTES + 96,
             block_bytes=16 * 1024, sst_bytes=256 * 1024)
TINY_QWEN = dict(n_layers=2, d_model=32, n_heads=2, kv_heads=2, d_ff=64,
                 vocab=128, head_dim=16)   # JAX's tests' ``tiny_cfg``


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread in this worker: these tests run the store's
    plain versions (many small int64 passes) while the suite's other
    workers share the cores, and more threads would oversubscribe them.
    Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(small):
    """(JAX's store config, the port's): the checkpoint geometry, or
    ``SMALL`` with 128 KiB memtables and L0 at 3 files."""
    if not small:
        return jstore.checkpoint_db_config("cpu"), \
            store.checkpoint_db_config()
    return (JConfig(geom=JGeometry(**SMALL), engine="cpu",
                    memtable_bytes=128 * 1024,
                    scheduler=JScheduler(l0_trigger=3, base_bytes=1 << 20)),
            DBConfig(geom=SSTGeometry(**SMALL), memtable_bytes=128 * 1024,
                     scheduler=SchedulerConfig(l0_trigger=3,
                                               base_bytes=1 << 20)))


def sst_files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")}


def jax_state(arch="falcon-mamba-7b", state_dtype="bfloat16", **kw):
    """JAX's ``TrainState`` as numpy (bf16 leaves as ml_dtypes arrays)."""
    cfg = jax_smoke(arch).with_(**kw)
    state = jts.init_state(jax.random.key(0), cfg,
                           joptim.AdamWConfig(state_dtype=state_dtype))
    return jax.tree.map(np.asarray, state)


def bumped(state, k):
    """A different state of the same tree for step ``k``."""
    return jax.tree.map(lambda a: (a + k).astype(a.dtype), state)


def same_bytes(got: torch.Tensor, want: np.ndarray):
    name, shape, raw = store._raw(got)
    assert name == str(want.dtype) and shape == list(want.shape)
    assert raw == want.tobytes()


def test_paths_are_jax_s():
    state = jax_state()
    want = [p for p, _ in jstore._tree_paths(state)]
    port = convert.train_state_from_numpy(state, "cpu")
    got = [p for p, _ in store._tree_paths(port)]
    assert got == want
    assert ".params/blocks/p0/mixer/A_log" in got and got[-1] == ".opt/.step"


@pytest.mark.parametrize("small", [True, False], ids=["small", "ckpt-geom"])
def test_same_trees_same_sst_files_as_jax(tmp_path, small):
    """Saves of a training state (bf16 moments) at steps 1-4 with a
    ``gc`` keeping two after each, in both stores: the same manifests,
    steps, level sizes and SST files; the port's compactions drop the
    gc'd records."""
    jcfg, tcfg = configs(small)
    js = jstore.CheckpointStore(str(tmp_path / "jax"), jcfg)
    ps = store.CheckpointStore(str(tmp_path / "port"), tcfg, device="cpu")
    base = jax_state("qwen3-14b", **TINY_QWEN) if small else jax_state()
    for step in (1, 2, 3, 4):
        tree = bumped(base, step)
        want = js.save(step, tree)
        got = ps.save(step, convert.train_state_from_numpy(tree, "cpu"))
        assert got == want
        js.gc(js.steps()[-2:])
        ps.gc(ps.steps()[-2:])
        assert ps.steps() == js.steps()
    assert ps.steps() == [3, 4]
    assert ps.db.level_sizes() == js.db.level_sizes()
    assert sst_files(ps.db.path) == sst_files(js.db.path)
    st = ps.db.stats
    assert st.flushes >= 4 and st.compactions > 0
    assert st.compact_entries_dropped > 0
    js.close()
    ps.close()


def test_jax_saved_restores_in_the_port_bit_for_bit(tmp_path):
    jcfg, tcfg = configs(True)
    js = jstore.CheckpointStore(str(tmp_path / "ck"), jcfg)
    state = jax_state()
    js.save(7, state)
    js.close()
    ps = store.CheckpointStore(str(tmp_path / "ck"), tcfg, device="cpu")
    assert ps.steps() == [7]
    like = ts.abstract_state(get_smoke_config("falcon-mamba-7b"),
                             optim.AdamWConfig(state_dtype="bfloat16"))
    got = ps.restore(7, like=like)
    assert isinstance(got, ts.TrainState)
    want = dict(jstore._tree_paths(state))
    flat = dict(store._tree_paths(got))
    assert sorted(flat) == sorted(want)
    for path, w in want.items():
        assert flat[path].device.type == "cpu"
        same_bytes(flat[path], np.asarray(w))
    assert got.opt.m["embed"]["table"].dtype == torch.bfloat16
    by_path = ps.restore(7)
    assert sorted(by_path) == sorted(want)
    ps.close()


def test_port_saved_restores_in_jax_bit_for_bit(tmp_path):
    jcfg, tcfg = configs(True)
    port = ts.init_state(3, get_smoke_config("qwen3-14b").with_(**TINY_QWEN),
                         optim.AdamWConfig(state_dtype="bfloat16"),
                         device="cpu")
    ps = store.CheckpointStore(str(tmp_path / "ck"), tcfg, device="cpu")
    ps.save(2, port)
    ps.close()
    js = jstore.CheckpointStore(str(tmp_path / "ck"), jcfg)
    like = jax.eval_shape(lambda: jts.init_state(
        jax.random.key(0), jax_smoke("qwen3-14b").with_(**TINY_QWEN),
        joptim.AdamWConfig(state_dtype="bfloat16")))
    got = js.restore(2, like=like)
    flat = dict(store._tree_paths(port))
    for path, leaf in jstore._tree_paths(got):
        same_bytes(flat[path], np.asarray(leaf))
    assert np.asarray(got.opt.m["embed"]["table"]).dtype == jnp.bfloat16
    js.close()


def test_roundtrip_steps_and_gc_as_jax(tmp_path):
    """JAX's ``test_checkpoint_roundtrip`` and ``test_checkpoint_steps_and_
    gc``, on the port's store with numpy and tensor leaves."""
    tree = {"a": np.arange(10000, dtype=np.float32).reshape(100, 100),
            "b": {"c": np.ones((7,), np.int32), "d": np.float32(3.5)}}
    ps = store.CheckpointStore(str(tmp_path / "a"), device="cpu")
    ps.save(3, tree)
    got = ps.restore(3, like=tree)
    assert got["b"]["d"].shape == () and got["b"]["c"].dtype == torch.int32
    for (_, want), (_, leaf) in zip(store._tree_paths(tree),
                                    store._tree_paths(got)):
        same_bytes(leaf, np.asarray(want))
    ps.close()
    ps = store.CheckpointStore(str(tmp_path / "b"), device="cpu")
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64))
                         .astype(np.float32))
    for s in (5, 10, 15):
        ps.save(s, {"w": w})
    assert ps.steps() == [5, 10, 15]
    ps.gc(keep_steps=[15])
    assert ps.steps() == [15]
    assert ps.load_manifest(5) is None
    with pytest.raises(KeyError):
        ps.restore(5, like={"w": w})
    assert torch.equal(ps.restore(15, like={"w": w})["w"], w)
    ps.close()


def test_store_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        store.CheckpointStore(str(tmp_path / "ck"))


# ---------------------------------------------------------------------------
# the token data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-14b", "internvl2-26b",
                                  "whisper-medium"])
def test_batches_are_jax_s_bytes(arch):
    """Within one process both packages' streams give the same bytes (the
    step's seed is Python's salted ``hash``, the same in one process)."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    js, ps = jtokens.BigramStream(jcfg.vocab, seed=3), \
        tokens.BigramStream(tcfg.vocab, seed=3)
    assert np.array_equal(js.table, ps.table)
    for step in (0, 1, 17):
        want = jtokens.make_train_batch(jcfg, js, step, 3, 40)
        got = tokens.make_train_batch(tcfg, ps, step, 3, 40)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), k
    if tcfg.frontend == "vision":
        assert got["tokens"].shape == (3, 40 - tcfg.frontend_len)
        assert got["patches"].shape == (3, tcfg.frontend_len, tcfg.d_model)
    if tcfg.enc_dec:
        assert got["frames"].shape == (3, 40, tcfg.d_model)
