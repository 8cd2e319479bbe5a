"""The sharded train step, the ``Trainer`` over a mesh with its elastic
restart, and ``launch/train.py --mesh-shape`` (ROADMAP A15), against the
JAX package's unsharded ``train_step`` and the port's one-device step.

One world of four ``gloo`` ranks runs every multi-rank check of this file
(a module fixture); the (1, 1) mesh runs in a world of this process
alone.  JAX's own sharded step fails in this container (a
``ShardingTypeError`` on the embedding gather), so the reference is JAX's
unsharded step on the same state and batches.  Both archs run fp32:
qwen3's smoke config cut as JAX's ``test_multidevice`` section 2 cuts it,
and falcon-mamba's smoke config, whose scan gradient ``dB`` / ``dC`` is a
partial sum over "model" on a (2, 2) mesh.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.testing.world import TEST_NICE as NICE
from repro_torch.testing.world import one_rank_world, run_world
from repro_torch.training import optimizer as optim
from repro_torch.training import train_step as ts
from repro_torch.training.train_loop import Trainer, TrainLoopConfig

FP32 = dict(dtype="float32", ssm_scan_dtype="float32")
CUT_QWEN = dict(n_layers=2, d_model=32, n_heads=2, kv_heads=2, d_ff=64,
                vocab=128, head_dim=16)   # JAX's test_multidevice sec. 2
ARCHS = {"qwen3-14b": CUT_QWEN, "falcon-mamba-7b": {}}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
STEPS = 3


def tcfg(arch):
    return get_smoke_config(arch).with_(**FP32, **ARCHS[arch])


def batches(cfg, n=STEPS, b=4, s=16):
    rng = np.random.default_rng(10)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        labels = toks.copy()
        labels[0, -3:] = -1
        out.append({"tokens": toks, "labels": labels})
    return out


def jax_run(arch):
    """JAX's unsharded step from its own init: the numpy start state, and
    per step the loss, grad norm and gradients (paths), then the final
    params."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.training import optimizer as joptim
    from repro.training import train_step as jts
    jcfg = jax_smoke(arch).with_(**FP32, **ARCHS[arch])
    jopt = joptim.AdamWConfig(**OPT)
    state = jts.init_state(jax.random.key(0), jcfg, jopt)
    start = jax.tree.map(np.asarray, state)
    real = joptim.update

    def spy(cfg, g, *a, **kw):   # the gradients among the metrics
        p, o, om = real(cfg, g, *a, **kw)
        return p, o, {**om, "grads": g}

    joptim.update = spy
    try:
        step = jax.jit(functools.partial(jts.train_step, cfg=jcfg,
                                         opt_cfg=jopt))
        steps = []
        for b in batches(jcfg):
            state, m = step(state, jax.tree.map(jnp.asarray, b))
            steps.append((float(m["loss"]), float(m["grad_norm"]),
                          m["grads"]))
    finally:
        joptim.update = real
    from repro.checkpoint.store import _tree_paths
    return start, [(loss, gn, {p: np.asarray(a) for p, a in _tree_paths(g)})
                   for loss, gn, g in steps], \
        {p: np.asarray(a) for p, a in _tree_paths(state.params)}


def params_close(got: dict, want: dict, steps) -> None:
    """The parameters within 1e-5, wherever AdamW's step is not set by its
    ``eps``: an element whose gradient was ever within 100 x eps (1e-6) of
    zero moves by ``g / (|g| + eps)``, where fp32 noise in ``g`` (1e-8 on
    a row of 0.07) changes the update by a share of ``lr``.  There the
    bound is the updates' own, ``2 x sum(lr)`` (the rule of
    ``test_torch_training``'s bf16 case).  The gradients themselves are
    held within 1e-4 of their largest."""
    lr_sum = sum(float(optim.schedule(optim.AdamWConfig(**OPT),
                                      torch.tensor(i + 1)))
                 for i in range(len(steps)))
    for path, w in want.items():
        tiny = np.zeros(w.shape, bool)
        for _, _, grads in steps:
            tiny |= np.abs(grads[path]) <= 1e-6
        err = np.abs(got[path].astype(np.float64) - w)
        assert err[~tiny].max(initial=0) <= 1e-5, (path, err[~tiny].max())
        assert err[tiny].max(initial=0) <= 2 * lr_sum, path


def _paths(tree) -> dict:
    from repro_torch.checkpoint.store import _tree_paths
    return dict(_tree_paths(tree))


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _train(state, cfg, mesh):
    """STEPS steps from ``state``: per step (loss, grad_norm, gradients by
    path), and the final params by path, all numpy."""
    real = optim.update
    seen = []

    def spy(c, g, *a, **kw):
        seen.append({p: (t.full_tensor() if hasattr(t, "full_tensor")
                         else t).numpy() for p, t in _paths(g).items()})
        return real(c, g, *a, **kw)

    optim.update = spy
    try:
        topt = optim.AdamWConfig(**OPT)
        if mesh is None:
            step = lambda st, b: ts.train_step(st, b, cfg=cfg,  # noqa: E731
                                               opt_cfg=topt)
        else:
            step, _, _ = ts.shard_train_step(cfg, mesh, 4, 16, topt)
        out = []
        for b in batches(cfg):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        seen.pop()))
    finally:
        optim.update = real
    final = {p: (t.full_tensor() if hasattr(t, "full_tensor") else t)
             .numpy() for p, t in _paths(state.params).items()}
    return out, final


def _rank_checks(rank, world, inputs):
    import torch.distributed as dist

    from repro_torch.distributed.fault_tolerance import (
        Supervisor, SupervisorConfig)
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    mesh22 = make_host_mesh(device="cpu")
    for arch in ARCHS:
        state = convert.train_state_from_numpy(inputs[arch], "cpu")
        out[arch] = _train(state, tcfg(arch), mesh22)

    # -- Trainer over (2, 2), failing at step 3, resumed on (4, 1)
    mesh41 = make_host_mesh(1, device="cpu")
    cfg = tcfg("qwen3-14b")
    loop = TrainLoopConfig(steps=4, batch=4, seq=16, ckpt_every=2,
                           log_every=100,
                           opt=optim.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=4))
    whole = Trainer(cfg, loop, inputs["ckpt"] + "/whole", mesh=mesh22).run()
    meshes = [mesh22, mesh41]
    sup = Supervisor(lambda attempt: Trainer(
        cfg, loop, inputs["ckpt"] + "/elastic", mesh=meshes[attempt],
        fail_at_step=3 if attempt == 0 else None),
        SupervisorConfig(max_restarts=1))
    with contextlib.redirect_stdout(io.StringIO()):
        resumed = sup.run()
    out["elastic"] = (whole.losses, resumed.losses, resumed.restarts)

    # -- the launcher, --mesh-shape 2 2 on this world, and a shape that
    # does not fit it
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main([
            "--arch", "falcon-mamba-7b", "--smoke", "--steps", "1",
            "--ckpt-every", "1", "--batch", "4", "--seq", "16", "--ckpt",
            inputs["ckpt"] + "/launch", "--mesh-shape", "2", "2",
            "--device", "cpu"])
    out["launch"] = buf.getvalue()
    try:
        launch_train.main(["--arch", "falcon-mamba-7b", "--smoke",
                           "--mesh-shape", "4", "2", "--device", "cpu"])
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {arch: jax_run(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(jax_runs, tmp_path_factory):
    inputs = {arch: jax_runs[arch][0] for arch in ARCHS}
    inputs["ckpt"] = str(tmp_path_factory.mktemp("ckpt"))
    return run_world(_rank_checks, 4, inputs, timeout=900, nice=NICE)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_matches_jax_unsharded(world, jax_runs, arch):
    """Three fp32 steps on (2, 2) against JAX's unsharded step: the loss
    within 1e-5, every gradient leaf within 1e-4 of its largest, the
    parameters within 1e-5."""
    _, jsteps, jfinal = jax_runs[arch]
    steps, final = world[0][arch]
    for (loss, gn, grads), (jloss, jgn, jgrads) in zip(steps, jsteps):
        assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-5)
        assert gn == pytest.approx(jgn, rel=1e-5)
        assert sorted(grads) == sorted(jgrads)
        for path, want in jgrads.items():
            gap = np.abs(grads[path] - want).max() / \
                max(np.abs(want).max(), 1e-30)
            assert gap <= 1e-4, (path, gap)
    assert sorted(final) == sorted(jfinal)
    params_close(final, jfinal, jsteps)
    for r in world[1:]:       # every rank holds the same replicated metrics
        assert [s[:2] for s in r[arch][0]] == [s[:2] for s in steps]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_matches_port_one_device(world, jax_runs, arch):
    steps, final = world[0][arch]
    state = convert.train_state_from_numpy(jax_runs[arch][0], "cpu")
    one, one_final = _train(state, tcfg(arch), None)
    for (loss, gn, grads), (oloss, ogn, ograds) in zip(steps, one):
        assert loss == pytest.approx(oloss, rel=1e-5, abs=1e-5)
        for path, want in ograds.items():
            gap = np.abs(grads[path] - want).max() / \
                max(np.abs(want).max(), 1e-30)
            assert gap <= 1e-4, (path, gap)
    params_close(final, one_final, one)


def test_scan_gradients_reduce_over_the_model_axis(world, jax_runs):
    """falcon-mamba's ``x_proj`` gradient, which takes the scan's ``dB``
    and ``dC``: a partial sum over "model" on (2, 2), held element by
    element (a local ``dB`` taken as replicated would be off by the other
    shard's part)."""
    _, jsteps, _ = jax_runs["falcon-mamba-7b"]
    steps, _ = world[0]["falcon-mamba-7b"]
    for (_, _, grads), (_, _, jgrads) in zip(steps, jsteps):
        for path in jgrads:
            if path.endswith("x_proj"):
                np.testing.assert_allclose(grads[path], jgrads[path],
                                           rtol=1e-4, atol=1e-6)


def test_one_by_one_mesh_equals_one_device_bit_for_bit(jax_runs):
    from repro_torch.launch.mesh import make_host_mesh
    for arch in ("falcon-mamba-7b",):   # the arch phase 14 runs on the card
        state = convert.train_state_from_numpy(jax_runs[arch][0], "cpu")
        one, one_final = _train(state, tcfg(arch), None)
        with one_rank_world():
            steps, final = _train(state, tcfg(arch),
                                  make_host_mesh(device="cpu"))
        for (loss, gn, grads), (oloss, ogn, ograds) in zip(steps, one):
            assert (loss, gn) == (oloss, ogn)
            for path, g in ograds.items():
                np.testing.assert_array_equal(grads[path], g, err_msg=path)
        for path, p in one_final.items():
            np.testing.assert_array_equal(final[path], p, err_msg=path)


# ---------------------------------------------------------------------------
# Trainer over a mesh, the elastic restart, the launcher
# ---------------------------------------------------------------------------


def test_elastic_restart_resumes_on_another_mesh(world):
    """Attempt 0 trains on (2, 2) and fails at step 3; attempt 1 restores
    the step-2 checkpoint onto (4, 1) and resumes: its losses equal an
    uninterrupted (2, 2) run's within 1e-5 (JAX's rule)."""
    whole, resumed, restarts = world[0]["elastic"]
    assert restarts == 1
    assert [s for s, _ in resumed] == [2, 3]
    want = dict(whole)
    for step, loss in resumed:
        assert loss == pytest.approx(want[step], abs=1e-5), step
    for r in world[1:]:
        assert r["elastic"] == world[0]["elastic"]


def test_launcher_mesh_shape_on_four_ranks(world):
    last = world[0]["launch"].strip().splitlines()[-1]
    assert last.startswith("finished: step=1 restarts=0 final-loss=")
    assert np.isfinite(float(last.split("final-loss=")[1].split()[0]))
    assert all("finished:" not in r["launch"] for r in world[1:])
    for r in world:
        assert r["mismatch"] is not None
        assert "(4, 2)" in r["mismatch"] and "4 ranks" in r["mismatch"]


def test_shard_train_step_structs_are_jax_s():
    """``shard_train_step`` returns JAX's structs (the state on ``meta``,
    the batch's shapes and dtypes) and the state's shardings by
    ``partition``."""
    from repro_torch.launch.mesh import make_host_mesh
    cfg = tcfg("qwen3-14b")
    with one_rank_world():
        mesh = make_host_mesh(device="cpu")
        fn, state_struct, batch_struct = ts.shard_train_step(cfg, mesh, 4,
                                                             16)
        assert batch_struct == ts.make_batch_struct(cfg, 4, 16)
        ab = ts.abstract_state(cfg)
        assert [(a.shape, a.dtype) for a in convert.tree_leaves(ab)] == [
            (a.shape, a.dtype) for a in convert.tree_leaves(state_struct)]
        assert {a.device.type for a in convert.tree_leaves(state_struct)} \
            == {"meta"}
        sh = fn.shardings
        assert sh.opt.step.mesh is mesh
        assert len(convert.tree_leaves(state_struct)) == \
            len(_flat_shardings(sh))


def _flat_shardings(tree) -> list:
    out = []
    from repro_torch.distributed import partition
    partition.map_specs(out.append, tree)
    return out
