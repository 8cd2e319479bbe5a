"""The port's training loop, supervisor and launcher (ROADMAP A14), on the
CPU: the port's ``Trainer`` against a loop of the JAX package's unsharded
``train_step`` and ``CheckpointStore`` (JAX's own ``Trainer`` needs a
mesh and fails on this CPU, ROADMAP "Caveats"), then the twins of JAX's
training-loop tests (``tests/test_training.py``) on the port, and the
launcher.

Tolerance against JAX: fp32 compute, the losses within 1e-5 relative and
the final params within 1e-5 (both sides fp32; they sum in other orders).
A resumed run must equal an uninterrupted one bit for bit (one process:
the data's seeds come from Python's salted ``hash``, fixed in a process).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.checkpoint.store import _tree_paths as jax_paths
from repro.checkpoint.store import checkpoint_db_config as jax_db_config
from repro.configs import get_smoke_config as jax_smoke
from repro.data.tokens import BigramStream as JStream
from repro.data.tokens import make_train_batch as jax_batch
from repro.training import optimizer as joptim
from repro.training import train_step as jts
from repro_torch.checkpoint.store import CheckpointStore, _tree_paths
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.fault_tolerance import (
    Supervisor, SupervisorConfig)
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.training import optimizer as optim
from repro_torch.training.train_loop import Trainer, TrainLoopConfig

TINY_QWEN = dict(n_layers=2, d_model=32, n_heads=2, kv_heads=2, d_ff=64,
                 vocab=128, head_dim=16)   # JAX's tests' ``tiny_cfg``
FP32 = dict(dtype="float32", ssm_scan_dtype="float32")


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


def tiny_cfg(**kw):
    return get_smoke_config("qwen3-14b").with_(**TINY_QWEN, **kw)


def tiny_loop(**kw):
    defaults = dict(steps=12, batch=4, seq=32, ckpt_every=5, log_every=100)
    defaults.update(kw)
    return TrainLoopConfig(**defaults)


def jax_loop(cfg, loop, ckpt_dir, state):
    """JAX's ``Trainer.run`` without its mesh: JAX's jitted unsharded
    ``train_step`` on JAX's batches, checkpoints through JAX's store (its
    numpy engine).  Returns (losses, final state)."""
    opt = joptim.AdamWConfig(**vars(loop.opt))
    step_fn = jax.jit(functools.partial(jts.train_step, cfg=cfg,
                                        opt_cfg=opt))
    stream = JStream(cfg.vocab, seed=loop.seed)
    losses = []
    for step in range(loop.steps):
        batch = jax_batch(cfg, stream, step, loop.batch, loop.seq)
        state, m = step_fn(state, jax.tree.map(jax.numpy.asarray, batch))
        losses.append((step, float(m["loss"])))
        if (step + 1) % loop.ckpt_every == 0 or step + 1 == loop.steps:
            store = JStore(ckpt_dir, jax_db_config("cpu"))
            store.save(step + 1, state)
            store.gc(store.steps()[-loop.keep_ckpts:])
            store.close()
    return losses, state


def test_trainer_matches_jax_s_train_step_and_store(tmp_path):
    """Both loops start from JAX's initial state (saved as step 0 into the
    port's checkpoint directory, which the port's ``Trainer`` restores)
    and run 7 steps, checkpointing every 3."""
    jcfg = jax_smoke("qwen3-14b").with_(**TINY_QWEN, **FP32)
    tcfg = tiny_cfg(**FP32)
    loop = tiny_loop(steps=7, ckpt_every=3, batch=2, seq=16)
    jstate = jts.init_state(jax.random.key(0), jcfg,
                            joptim.AdamWConfig(**vars(loop.opt)))
    port_dir = str(tmp_path / "port")
    store = CheckpointStore(port_dir, device="cpu")
    store.save(0, convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu"))
    store.close()
    trainer = Trainer(tcfg, loop, port_dir, device="cpu")
    got = trainer.run()
    want, jfinal = jax_loop(jcfg, loop, str(tmp_path / "jax"), jstate)
    assert [s for s, _ in got.losses] == [s for s, _ in want] == \
        list(range(7))
    for (_, g), (_, w) in zip(got.losses, want):
        assert g == pytest.approx(w, rel=1e-5)
    final = dict(_tree_paths(trainer.state))
    for path, w in jax_paths(jax.tree.map(np.asarray, jfinal)):
        if path.startswith(".params"):
            assert np.abs(final[path].numpy() - w).max() <= 1e-5, path
    js, ps = JStore(str(tmp_path / "jax"), jax_db_config("cpu")), \
        CheckpointStore(port_dir, device="cpu")
    assert ps.steps() == js.steps() == [6, 7]
    for step in (6, 7):
        assert [(t["path"], t["shape"], t["dtype"]) for t in
                ps.load_manifest(step)["tensors"]] == \
            [(t["path"], t["shape"], t["dtype"]) for t in
             js.load_manifest(step)["tensors"]]
    restored = ps.restore(7, like=trainer.state_struct)
    for a, b in zip(convert.tree_leaves(restored),
                    convert.tree_leaves(trainer.state)):
        assert torch.equal(a, b)
    js.close()
    ps.close()


def test_loss_decreases(tmp_path):
    # one checkpoint, at the end: the restart tests below save more often
    trainer = Trainer(tiny_cfg(), tiny_loop(steps=30, ckpt_every=30),
                      str(tmp_path / "ck"), device="cpu")
    result = trainer.run()
    first = np.mean([l for _, l in result.losses[:5]])
    last = np.mean([l for _, l in result.losses[-5:]])
    assert last < first - 0.1, (first, last)


def test_restart_resumes_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ck")

    def make_trainer(attempt):
        return Trainer(tiny_cfg(), tiny_loop(steps=12), ckpt, device="cpu",
                       fail_at_step=8 if attempt == 0 else None)

    beat = tmp_path / "heartbeat.json"
    result = Supervisor(make_trainer, SupervisorConfig(
        max_restarts=2, heartbeat_path=str(beat))).run()
    assert result.restarts == 1 and result.final_step == 12
    # the resumed run picks up from the last checkpoint (step 5), not 0
    assert [s for s, _ in result.losses][0] == 5
    assert '"attempt": 1' in beat.read_text()


def test_restart_is_bit_deterministic(tmp_path):
    """A run interrupted and resumed equals an uninterrupted run exactly,
    at every step after the resume and in its final state."""
    def run(ckpt_dir, fail):
        made = []

        def make_trainer(attempt):
            made.append(Trainer(
                tiny_cfg(), tiny_loop(steps=10, ckpt_every=4), ckpt_dir,
                device="cpu",
                fail_at_step=6 if (fail and attempt == 0) else None))
            return made[-1]
        return Supervisor(make_trainer).run(), made[-1].state

    (r_plain, s_plain), (r_fail, s_fail) = run(str(tmp_path / "a"), False), \
        run(str(tmp_path / "b"), True)
    assert r_fail.restarts == 1
    plain, failed = dict(r_plain.losses), dict(r_fail.losses)
    assert sorted(failed) == list(range(4, 10))
    for step in range(4, 10):
        assert plain[step] == failed[step], step
    for a, b in zip(convert.tree_leaves(s_plain), convert.tree_leaves(s_fail)):
        assert torch.equal(a, b)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    def make_trainer(attempt):
        return Trainer(tiny_cfg(), tiny_loop(steps=4, ckpt_every=2),
                       str(tmp_path / "ck"), device="cpu", fail_at_step=1)

    with pytest.raises(RuntimeError, match="max_restarts=1"):
        Supervisor(make_trainer, SupervisorConfig(max_restarts=1)).run()


def test_bf16_optimizer_states_converge(tmp_path):
    loop = tiny_loop(steps=25, ckpt_every=25, opt=optim.AdamWConfig(
        lr=1e-3, warmup_steps=5, state_dtype="bfloat16"))
    trainer = Trainer(tiny_cfg(), loop, str(tmp_path / "ck"), device="cpu")
    result = trainer.run()
    first = np.mean([l for _, l in result.losses[:5]])
    last = np.mean([l for _, l in result.losses[-5:]])
    assert last < first - 0.05, (first, last)
    state, step = trainer.init_or_restore()
    assert step == 25
    m_leaves = convert.tree_leaves(state.opt.m)
    assert any(leaf.dtype == torch.bfloat16 for leaf in m_leaves)


def test_launcher_on_the_cpu(tmp_path, capsys, monkeypatch):
    ckpt = str(tmp_path / "ck")
    result = launch_train.main([
        "--arch", "falcon-mamba-7b", "--smoke", "--steps", "3",
        "--ckpt-every", "2", "--fail-at", "2", "--batch", "2", "--seq",
        "16", "--ckpt", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    assert last.startswith("finished: step=3 restarts=1 final-loss=")
    assert last.endswith(f"ckpt={ckpt}")
    assert np.isfinite(float(last.split("final-loss=")[1].split()[0]))
    assert [s for s, _ in result.losses] == [2]
    # --mesh-shape 1 1: the sharded step in a world of this process alone,
    # started by the launcher from the environment
    from repro_torch.testing.world import free_port
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(free_port())}.items():
        monkeypatch.setenv(k, v)
    ckpt2 = str(tmp_path / "ck2")
    meshed = launch_train.main([
        "--arch", "falcon-mamba-7b", "--smoke", "--steps", "3",
        "--ckpt-every", "2", "--fail-at", "2", "--batch", "2", "--seq",
        "16", "--ckpt", ckpt2, "--mesh-shape", "1", "1", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("finished: step=3 restarts=1 final-loss=")
    assert meshed.losses == result.losses
