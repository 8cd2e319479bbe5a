"""The port's training step against the JAX package's (ROADMAP A14), on
the CPU: ``model.lm_loss`` and its gradient, ``optimizer.update`` and
``schedule``, and ``train_step`` run unsharded (``mesh=None``; JAX's
``Trainer`` needs a mesh, and fails on this CPU, ROADMAP "Caveats").

The same params go through both (JAX's ``init``, carried across with
``convert``); inputs are made with numpy from a seed.  Tolerances:

- ``lm_loss`` at fp32 (``dtype="float32"``, fp32 scan): 1e-5 relative on
  the loss, and each gradient leaf within 1e-4 of that leaf's largest
  |grad| (both sides fp32; they sum in other orders).
- ``update`` and ``schedule``: 1e-6 relative (the same fp32 arithmetic).
- Three ``train_step``s at fp32: the params within 1e-5.  At bf16 compute
  (the smoke configs' dtype), the working copy's dtypes equal JAX's leaf
  by leaf, and the limits are set from readings of falcon-mamba-7b and
  qwen3-14b (``tiny_cfg``) at batch seeds 10-12, the port's first bf16
  gradient against JAX's bf16 one and both against JAX's fp32 one on the
  same params:

  - the first step's gradient, leaf by leaf: within 0.1 of the leaf's
    largest |grad| of JAX's (read: at most 0.044; JAX's own bf16
    gradient lies up to 0.070 from its fp32 one); the port's largest
    such distance from JAX's fp32 gradient at most twice JAX's own (read:
    0.037 against 0.037, 0.052 against 0.047); the signs of all elements
    agree with JAX's at >= 98 % (read: 99.5 % and 99.8 %);
  - the loss and CE of each step within 2e-4 relative (read: at most
    5.9e-5), the grad norm within 1e-2 (read: at most 2.0e-3);
  - after three steps, the signs of the params' moves agree with JAX's at
    >= 98 % (read: 99.6 % and 99.8 %), and each param lies within two of
    the steps' learning rates summed (AdamW moves a param by about the
    learning rate a step whatever its gradient, so a bf16 gradient of the
    other sign moves it at most twice that far).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _tree_paths as jax_paths
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as jmodel
from repro.training import optimizer as joptim
from repro.training import train_step as jts
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, model
from repro_torch.training import optimizer as optim
from repro_torch.training import train_step as ts

FP32 = dict(dtype="float32", ssm_scan_dtype="float32")
TINY_QWEN = dict(n_layers=2, d_model=32, n_heads=2, kv_heads=2, d_ff=64,
                 vocab=128, head_dim=16)   # JAX's tests' ``tiny_cfg``
ARCHS = {"falcon-mamba-7b": {}, "qwen3-14b": TINY_QWEN,
         "granite-moe-3b-a800m": {}, "internvl2-26b": {}}


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


def configs(arch, **kw):
    kw = {**ARCHS[arch], **kw}
    return jax_smoke(arch).with_(**kw), get_smoke_config(arch).with_(**kw)


def batch_for(cfg, b=2, s=24, seed=1):
    """numpy tokens and labels (a few masked with -1), plus patches for a
    vision arch (whose tokens are ``s - frontend_len`` long)."""
    rng = np.random.default_rng(seed)
    n_tok = s - cfg.frontend_len if cfg.frontend == "vision" else s
    toks = rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)
    labels = toks.copy()
    labels[0, -3:] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)
                                             if a.dtype == jnp.bfloat16
                                             else a), tree)


def leaves_by_path(tree):
    """path -> leaf (JAX's path strings, either package's tree)."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        from repro_torch.checkpoint.store import _tree_paths
        return dict(_tree_paths(tree))
    return dict(jax_paths(tree))


def port_grads(params, batch, cfg, **kw):
    p = convert.tree_map(lambda a: a.detach().requires_grad_(), params)
    loss, parts = model.lm_loss(p, batch, cfg, **kw)
    leaves = convert.tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    it = iter(grads)
    return loss, parts, convert.tree_map(lambda _: next(it), p)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def loss_case(request):
    jcfg, tcfg = configs(request.param, **FP32)
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jcfg))
    batch = batch_for(jcfg)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jmodel.lm_loss(p, jax.tree.map(jnp.asarray, batch), jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, jp))
    tp = convert.params_from_numpy(jp, "cpu")
    return request.param, tcfg, tp, batch, (float(jl), jparts, jg)


def test_lm_loss_and_its_gradient_match_jax(loss_case):
    arch, tcfg, tp, batch, (jl, jparts, jg) = loss_case
    loss, parts, grads = port_grads(tp, to_torch(batch), tcfg)
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    assert float(parts["ce"]) == pytest.approx(float(jparts["ce"]), rel=1e-5)
    assert float(parts["aux"]) == pytest.approx(float(jparts["aux"]),
                                                rel=1e-5, abs=1e-7)
    if arch == "granite-moe-3b-a800m":
        assert float(parts["aux"]) > 0   # the MoE's balance loss counts
    want, got = leaves_by_path(jg), leaves_by_path(grads)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].numpy()
        lim = 1e-4 * float(np.abs(w).max())
        assert np.abs(g - w).max() <= lim, (path, np.abs(g - w).max(), lim)


def test_vision_labels_align_right():
    """internvl2's hidden states cover the patches and the tokens; the loss
    reads the last ``labels`` positions: changing the patches changes the
    loss, through the tokens' positions only."""
    _, tcfg = configs("internvl2-26b", **FP32)
    params = model.init(0, tcfg, device="cpu")
    b = to_torch(batch_for(tcfg))
    with torch.no_grad():
        base = float(model.lm_loss(params, b, tcfg)[0])
        hid, _ = model.forward_hidden(params, b, tcfg)
        assert hid.shape[1] == b["tokens"].shape[1] + tcfg.frontend_len
        b2 = dict(b, patches=b["patches"] * 2)
        assert float(model.lm_loss(params, b2, tcfg)[0]) != base


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen3-14b"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` recomputes each layer in the backward: the loss and
    every gradient are the same bits as without it."""
    _, tcfg = configs(arch, **FP32)
    params = model.init(0, tcfg, device="cpu")
    batch = to_torch(batch_for(tcfg))
    out = [port_grads(params, batch, tcfg.with_(remat=r)) for r in
           (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(convert.tree_leaves(out[0][2]),
                    convert.tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_loss_chunks_sum_as_one():
    """The CE in chunks of 8 (24 next-token positions, 3 chunks) equals
    the one-chunk loss."""
    _, tcfg = configs("qwen3-14b", **FP32)
    params = model.init(0, tcfg, device="cpu")
    batch = to_torch(batch_for(tcfg, s=25))
    with torch.no_grad():
        whole = model.lm_loss(params, batch, tcfg)[0]
        chunked = model.lm_loss(params, batch, tcfg, loss_chunk=8)[0]
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_update_matches_jax(state_dtype):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "l": [rng.standard_normal((2, 3)).astype(np.float32)]}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10,
               state_dtype=state_dtype)
    jcfg, tcfg = joptim.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jo = joptim.init(jp, jcfg)
    tp = convert.params_from_numpy(params, "cpu")
    to = optim.init(tp, tcfg)
    assert to.m["w"].dtype == getattr(torch, state_dtype)
    for step in range(4):
        g = jax.tree.map(lambda a: (a * (step + 1.5)).astype(np.float32),
                         params)
        jp, jo, jm = joptim.update(jcfg, jax.tree.map(jnp.asarray, g), jo,
                                   jp)
        tp, to, tm = optim.update(tcfg, convert.params_from_numpy(g, "cpu"),
                                  to, tp)
        assert int(to.step) == int(jo.step) == step + 1
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        for tree_j, tree_t, dt in ((jp, tp, "float32"),
                                   (jo.m, to.m, state_dtype),
                                   (jo.v, to.v, state_dtype)):
            want, got = leaves_by_path(to_np(tree_j)), leaves_by_path(tree_t)
            assert sorted(want) == sorted(got)
            for path, w in want.items():
                t = got[path]
                np.testing.assert_allclose(t.float().numpy(), w, rtol=1e-6,
                                           atol=1e-9)
                assert str(t.dtype) == f"torch.{dt}"


def test_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_ratio=0.2)
    jcfg, tcfg = joptim.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        want = float(joptim.schedule(jcfg, jnp.int32(step)))
        got = float(optim.schedule(tcfg, torch.tensor(step,
                                                      dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6), step


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def record_working_copy(monkeypatch):
    """Record the dtypes of the params each package's ``lm_loss`` gets
    inside its ``train_step`` (the working copy), by path."""
    seen = {}

    def wrap(mod, key, paths):
        real = mod.lm_loss

        def lm_loss(params, *a, **kw):
            seen[key] = {p: str(leaf.dtype).replace("torch.", "")
                         for p, leaf in paths(params).items()}
            return real(params, *a, **kw)
        monkeypatch.setattr(mod, "lm_loss", lm_loss)

    wrap(jmodel, "jax", lambda p: dict(jax_paths(p)))
    wrap(model, "port", leaves_by_path)
    return seen


def record_grads(monkeypatch):
    """Make each package's ``train_step`` return its gradients among its
    metrics (``"grads"``), by wrapping the ``update`` it calls."""
    for mod in (joptim, optim):
        def update(cfg, grads, *a, _real=mod.update, **kw):
            p, o, om = _real(cfg, grads, *a, **kw)
            return p, o, {**om, "grads": grads}
        monkeypatch.setattr(mod, "update", update)


def gap(got, want) -> float:
    """Max |got - want| over the largest |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def sign_share(got: dict, want: dict) -> float:
    """The share of all elements of two trees (by path) whose signs
    agree."""
    return float(np.concatenate([(np.sign(got[k]) == np.sign(want[k]))
                                 .ravel() for k in want]).mean())


def np_leaves(tree) -> dict:
    if isinstance(convert.tree_leaves(tree)[0], torch.Tensor):
        return {k: v.detach().float().numpy()
                for k, v in leaves_by_path(tree).items()}
    return leaves_by_path(to_np(tree))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen3-14b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax(arch, dtype, monkeypatch):
    kw = dict(FP32) if dtype == "float32" else {}
    jcfg, tcfg = configs(arch, **kw)
    assert jcfg.dtype == dtype
    opt_cfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jopt, topt = joptim.AdamWConfig(**opt_cfg), optim.AdamWConfig(**opt_cfg)
    jstate = jts.init_state(jax.random.key(0), jcfg, jopt)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu")
    seen = record_working_copy(monkeypatch)
    record_grads(monkeypatch)
    jstep = jax.jit(functools.partial(jts.train_step, cfg=jcfg,
                                      opt_cfg=jopt))
    if dtype == "bfloat16":   # JAX's fp32 gradient of the first step
        exact = np_leaves(jax.jit(functools.partial(
            jts.train_step, cfg=jcfg.with_(**FP32), opt_cfg=jopt))(
                jstate, jax.tree.map(jnp.asarray, batch_for(jcfg, seed=10)))
            [1]["grads"])
    start = np_leaves(tstate.params)
    lrs, jlosses = [], []
    for step in range(3):
        batch = batch_for(jcfg, seed=10 + step)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = ts.train_step(tstate, to_torch(batch), cfg=tcfg,
                                   opt_cfg=topt)
        lrs.append(float(jm["lr"]))
        if step == 0:
            jg, tg = np_leaves(jm["grads"]), np_leaves(tm["grads"])
            assert sorted(jg) == sorted(tg)
        for k in ("loss", "ce", "grad_norm"):
            rel = 1e-5 if dtype == "float32" else \
                (1e-2 if k == "grad_norm" else 2e-4)
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel), k
    if dtype == "bfloat16":
        for k in jg:
            assert gap(tg[k], jg[k]) <= 0.1, (k, gap(tg[k], jg[k]))
        assert max(gap(tg[k], exact[k]) for k in jg) <= \
            2 * max(gap(jg[k], exact[k]) for k in jg)
        assert sign_share(tg, jg) >= 0.98
    assert seen["port"] == seen["jax"]
    if dtype == "bfloat16":   # JAX's rule: every fp32 leaf of ndim >= 2
        assert seen["port"]["blocks/p0/norm1/scale"] == "bfloat16"
        if arch == "falcon-mamba-7b":
            assert seen["port"]["blocks/p0/mixer/A_log"] == "bfloat16"
        assert seen["port"]["final_norm/scale"] == "float32"
    assert int(tstate.opt.step) == 3
    lim = 1e-5 if dtype == "float32" else 2 * sum(lrs) + 1e-6
    want = leaves_by_path(to_np(jstate))
    got = leaves_by_path(tstate)
    assert sorted(want) == sorted(got)
    moved = {}
    for path, w in want.items():
        g = got[path]
        assert g.dtype == (torch.int32 if path.endswith(".step")
                           else torch.float32), path
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        if path.startswith(".params"):
            assert err <= lim, (path, err)
            k = path[len(".params/"):]
            moved[k] = (g.numpy() - start[k], w - start[k])
    if dtype == "bfloat16":   # the three steps' updates
        assert sign_share({k: t for k, (t, _) in moved.items()},
                          {k: j for k, (_, j) in moved.items()}) >= 0.98


def test_state_tree_and_abstract_state_are_jax_s():
    """``init_state``'s tree has JAX's paths, shapes and dtypes;
    ``abstract_state`` has them on the ``meta`` device."""
    jcfg, tcfg = configs("falcon-mamba-7b")
    jopt = joptim.AdamWConfig(state_dtype="bfloat16")
    topt = optim.AdamWConfig(state_dtype="bfloat16")
    want = {p: (tuple(a.shape), str(a.dtype)) for p, a in jax_paths(
        jax.eval_shape(lambda: jts.init_state(jax.random.key(0), jcfg,
                                              jopt)))}
    for state, dev in ((ts.init_state(0, tcfg, topt, device="cpu"), "cpu"),
                       (ts.abstract_state(tcfg, topt), "meta")):
        got = {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
               for p, a in leaves_by_path(state).items()}
        assert got == want
        assert {a.device.type for a in convert.tree_leaves(state)} == {dev}
    struct = ts.make_batch_struct(tcfg, 4, 32)
    jstruct = jts.make_batch_struct(jcfg, 4, 32)
    assert {k: (s, str(d).replace("torch.", "")) for k, (s, d) in
            struct.items()} == {k: (v.shape, str(v.dtype)) for k, v in
                                jstruct.items()}
    # the sharded step's structs are these, on a (1, 1) mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.testing.world import one_rank_world
    with one_rank_world():
        fn, sstruct, bstruct = ts.shard_train_step(
            tcfg, make_host_mesh(device="cpu"), batch=4, seq=32,
            opt_cfg=topt)
        assert bstruct == struct
        assert {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
                for p, a in leaves_by_path(sstruct).items()} == want
        assert callable(fn)
