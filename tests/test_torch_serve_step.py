"""The serving steps (``repro_torch.serving.serve_step``, ROADMAP A13)
against the JAX package's: ``serve_prefill`` / ``serve_decode_step`` on
one device against JAX's on the same params (fp32 smoke configs), and
``shard_prefill`` / ``shard_decode_step`` on a (2, 2) mesh (one world of
four ``gloo`` ranks, started by a module fixture) against the one-device
steps: the same greedy tokens, the logits within 1e-4.

The MoE arch runs at capacity factor 64, as JAX's EP test does: the
expert-parallel path sizes its capacity buffers by each rank's tokens and
the dense path by all of them, so the two drop the same tokens only when
neither drops any.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import convert
from repro_torch.serving import serve_step
from repro_torch.testing.world import TEST_NICE as NICE
from repro_torch.testing.world import run_world

FP32 = dict(dtype="float32", ssm_scan_dtype="float32")
ARCHS = {"falcon-mamba-7b": {}, "qwen3-14b": {},
         "granite-moe-3b-a800m": dict(capacity_factor=64.0)}
B, S, MAX_LEN, NEW = 4, 16, 24, 2


def tcfg(arch):
    return get_smoke_config(arch).with_(**FP32, **ARCHS[arch])


def jax_params(arch):
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as jmodel
    jcfg = jax_smoke(arch).with_(**FP32, **ARCHS[arch])
    return jcfg, jax.tree.map(np.asarray, jmodel.init(jax.random.key(1),
                                                      jcfg))


def prompts(cfg):
    return np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def port_greedy(params, cfg, toks, mesh=None):
    """Prefill, then NEW greedy decode steps: the tokens ``[B, 1 + NEW]``
    and each step's logits, numpy; through the ``shard_*`` steps when
    ``mesh`` is given."""
    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
            .detach().numpy()

    batch = {"tokens": torch.from_numpy(toks)}
    if mesh is None:
        nxt, cache, pos = serve_step.serve_prefill(params, batch, cfg=cfg,
                                                   max_len=MAX_LEN)
        step = lambda p, c, t, q: serve_step.serve_decode_step(  # noqa
            p, c, t, q, cfg=cfg)
    else:
        prefill, _, _ = serve_step.shard_prefill(cfg, mesh, B, S,
                                                 max_len=MAX_LEN)
        nxt, cache, pos = prefill(params, batch)
        step, *_ = serve_step.shard_decode_step(cfg, mesh, B, MAX_LEN)
    toks_out, logits = [full(nxt)], []
    for _ in range(NEW):
        nxt, lg, cache = step(params, cache, nxt, pos)
        pos = pos + 1
        toks_out.append(full(nxt))
        logits.append(full(lg))
    return np.concatenate(toks_out, axis=1), np.stack(logits)


def _rank_checks(rank, world, inputs):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    out = {}
    for arch in ARCHS:
        params = convert.params_from_numpy(inputs[arch], "cpu")
        out[arch] = port_greedy(params, tcfg(arch), prompts(tcfg(arch)),
                                mesh)
    return out


@pytest.fixture(scope="module")
def params():
    return {arch: jax_params(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(params):
    return run_world(_rank_checks, 4, {a: params[a][1] for a in ARCHS},
                     timeout=900, nice=NICE)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_device_steps_equal_jax(params, arch):
    import jax
    import jax.numpy as jnp
    from repro.serving import serve_step as jss
    jcfg, p = params[arch]
    jp = jax.tree.map(jnp.asarray, p)
    toks = prompts(jcfg)
    jn, jc, jpos = jss.serve_prefill(jp, {"tokens": jnp.asarray(toks)},
                                     cfg=jcfg, max_len=MAX_LEN)
    got_t, got_l = port_greedy(convert.params_from_numpy(p, "cpu"),
                               tcfg(arch), toks)
    want_t, want_l = [np.asarray(jn)], []
    for _ in range(NEW):
        jn, lg, jc = jss.serve_decode_step(jp, jc, jn, jpos, cfg=jcfg)
        jpos = jpos + 1
        want_t.append(np.asarray(jn))
        want_l.append(np.asarray(lg))
    np.testing.assert_array_equal(got_t, np.concatenate(want_t, axis=1))
    np.testing.assert_allclose(got_l, np.stack(want_l), rtol=1e-4,
                               atol=1e-4)
    assert np.asarray(jpos).tolist() == [[S + NEW]] * B


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_steps_equal_one_device(world, params, arch):
    _, p = params[arch]
    want_t, want_l = port_greedy(convert.params_from_numpy(p, "cpu"),
                                 tcfg(arch), prompts(tcfg(arch)))
    for r in world:
        got_t, got_l = r[arch]
        np.testing.assert_array_equal(got_t, want_t)
        np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-4)


def test_abstract_structs_are_jax_s():
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.serving import serve_step as jss
    for arch in ("falcon-mamba-7b", "internvl2-26b", "whisper-medium"):
        jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
        for j, t in ((jss.abstract_params(jcfg),
                      serve_step.abstract_params(cfg)),
                     (jss.abstract_cache(jcfg, 2, 32),
                      serve_step.abstract_cache(cfg, 2, 32))):
            jl = [(tuple(a.shape), str(a.dtype))
                  for a in jax.tree.leaves(j)]
            tl = [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
                  for a in convert.tree_leaves(t)]
            assert sorted(jl) == sorted(tl), arch
            assert {a.device.type for a in convert.tree_leaves(t)} == \
                {"meta"}
        jb = jss.make_prefill_batch_struct(jcfg, 2, 32)
        tb = serve_step.make_prefill_batch_struct(cfg, 2, 32)
        assert {k: (s, str(d).replace("torch.", "")) for k, (s, d) in
                tb.items()} == {k: (v.shape, str(v.dtype))
                                for k, v in jb.items()}
