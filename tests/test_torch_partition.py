"""The port's sharding rules and annotations (``repro_torch.distributed
.partition`` / ``.annotate``, ``launch.mesh``) against the JAX package's
(ROADMAP A15).

The rules are pure functions of a leaf's path and rank, the config and the
mesh's axis names and sizes, so they are held here on abstract meshes of
(1, 1), (2, 2), (4, 1), (16, 16) and (2, 16, 16) for all 10 archs at
their full configs (the trees on the ``meta`` device / ``eval_shape``): no
world is needed.  Every spec must equal JAX's ``PartitionSpec`` entry for
entry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.distributed import partition as jpart
from repro.models import model as jmodel
from repro.training import train_step as jts
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import annotate, partition
from repro_torch.launch import mesh as tmesh
from repro_torch.models import convert, model
from repro_torch.serving import serve_step
from repro_torch.training import train_step as ts

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
ARCH_NAMES = sorted(ARCHS)


def jax_specs(tree) -> dict:
    """JAX's spec tree as ``{path: tuple of entries}``."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jpart._path_str(p): tuple(s) for p, s in flat}


def port_specs(tree) -> dict:
    """The port's spec tree as ``{path: spec}``."""
    out = {}
    convert.tree_map_with_path(lambda path, s: out.__setitem__(path, s),
                               tree, is_leaf=partition.is_spec)
    return out


@pytest.fixture(scope="module")
def trees():
    """Each arch's full-config param tree, JAX's by ``eval_shape`` and the
    port's on ``meta``, and both cache trees of a small batch."""
    out = {}
    for name in ARCH_NAMES:
        jcfg, tcfg = jax_config(name), get_config(name)
        jp = jax.eval_shape(lambda c=jcfg: jmodel.init(jax.random.key(0), c))
        tp = serve_step._on_meta(lambda c=tcfg: model.init(0, c,
                                                           device="cpu"))
        out[name] = (jcfg, tcfg, jp, tp)
    return out


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_specs_equal_jax_for_every_arch(trees, shape, names, fsdp):
    jm = JaxAbstractMesh(shape, names)
    tm = partition.AbstractMesh(shape, names)
    for name in ARCH_NAMES:
        jcfg, tcfg, jp, tp = trees[name]
        want = jax_specs(jpart.param_specs(jp, jcfg, jm, fsdp=fsdp))
        got = port_specs(partition.param_specs(tp, tcfg, tm, fsdp=fsdp))
        assert sorted(got) == sorted(want), name
        for path, spec in want.items():
            assert got[path] == spec, (name, path, got[path], spec)


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_batch_and_cache_specs_equal_jax(shape, names):
    jm = JaxAbstractMesh(shape, names)
    tm = partition.AbstractMesh(shape, names)
    for b in (1, 8, 64):
        assert partition.batch_spec(tm, b) == tuple(jpart.batch_spec(jm, b))
    for name in ARCH_NAMES:
        jcfg, tcfg = jax_smoke(name), get_smoke_config(name)
        for b in (1, 4, 32):
            jb = jts.make_batch_struct(jcfg, b, 16)
            tb = ts.make_batch_struct(tcfg, b, 16)
            assert partition.batch_specs(tb, tm) == {
                k: tuple(v) for k, v in jpart.batch_specs(jb, jm).items()}
            jc = jax.eval_shape(lambda c=jcfg, b=b: jmodel.init_cache(
                c, b, 32, jnp.bfloat16))
            tc = serve_step.abstract_cache(tcfg, b, 32)
            want = jax_specs(jpart.cache_specs(jc, jm, b))
            got = port_specs(partition.cache_specs(tc, tm, b))
            assert got == want, (name, b)


def test_specs_become_placements_one_a_mesh_dim():
    tm = partition.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert partition.placements((("pod", "data"), "model"), tm) == (
        Shard(0), Shard(0), Shard(1))
    assert partition.placements(("model", None), tm) == (
        Replicate(), Replicate(), Shard(0))
    assert partition.placements((), tm) == (Replicate(),) * 3
    tm2 = partition.AbstractMesh((4, 2), ("data", "model"))
    assert partition.placements((None, "data", "model"), tm2) == (
        Shard(1), Shard(2))


def test_host_and_production_mesh_shapes():
    assert [tmesh.host_mesh_shape(n) for n in (1, 2, 3, 4, 8)] == [
        (1, 1), (1, 2), (3, 1), (2, 2), (4, 2)]
    assert tmesh.host_mesh_shape(4, 1) == (4, 1)
    assert tmesh.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert tmesh.production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))


def test_annotate_context_and_axis_sizes():
    x = torch.ones(4, 6)
    assert not annotate.active()
    assert annotate.constrain(x, "dp", "tp") is x
    assert annotate.axis_size("tp") == annotate.axis_size("dp") == 1
    tm = partition.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    with annotate.mesh_annotations(tm):
        assert annotate.active()
        assert annotate.axis_size("tp") == 16
        assert annotate.axis_size("dp") == 32
        # a plain tensor is returned as it is under a mesh too
        assert annotate.constrain(x, "dp", "tp") is x
        # JAX's divisibility rule: an axis that does not divide drops
        assert annotate.spec_of((64, 48, 8), ("dp", "tp", "tp")) == (
            ("pod", "data"), "model", None)
        assert annotate.spec_of((4, 3), ("dp", None)) == (None, None)
        with pytest.raises(ValueError):
            annotate.spec_of((4,), ("xx",))
    assert not annotate.active()


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_with_and_without_annotations_agree_bit_for_bit(name):
    """``constrain`` is the identity without DTensors: each arch's forward
    under the annotations of a (1, 1) mesh equals the plain forward bit
    for bit (fp32 smoke config)."""
    cfg = get_smoke_config(name).with_(dtype="float32")
    params = model.init(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    s = 16 + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, s - (cfg.frontend_len if cfg.frontend == "vision"
                               else 0))).astype(np.int32))}
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, s, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        plain, aux = model.forward(params, batch, cfg)
        with annotate.mesh_annotations(
                partition.AbstractMesh((1, 1), ("data", "model"))):
            meshed, aux_m = model.forward(params, batch, cfg)
    assert torch.equal(plain, meshed)
    assert torch.equal(torch.as_tensor(aux), torch.as_tensor(aux_m))
    assert convert.tree_leaves(params)  # the tree was built
