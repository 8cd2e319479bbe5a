"""The port's distributed building blocks against the JAX package's
(ROADMAP A15): range-sharded compaction (``offload.sharded_compact`` /
``place_sharded``), expert-parallel MoE (``moe._moe_ffn_ep``), the int8
compressed gradient mean, the pipeline and the checkpoint store's sharded
restore.

One world of four ``gloo`` ranks (``repro_torch.testing.world``) is
started for the whole file by a module fixture; it runs every check and
hands back numpy results, and each test asserts on its part.  The JAX
side runs here, in the test process, on one device: JAX's own sharded
versions need a mesh of devices this process does not have.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import formats, offload
from repro_torch.core.formats import SSTGeometry
from repro_torch.distributed import grad_compress, partition, pipeline
from repro_torch.models import moe
from repro_torch.testing.world import TEST_NICE as NICE
from repro_torch.testing.world import run_world

KW = dict(key_bytes=16, value_bytes=32, block_bytes=1024, sst_bytes=8192)
SHARDS = 4
MOE = dict(capacity_factor=64.0, moe_top_k=2,
           dtype="float32")   # JAX's test_multidevice section 4
MICRO = (2, 4, 8)


# ---------------------------------------------------------------------------
# inputs, made from seeds with numpy
# ---------------------------------------------------------------------------


def shard_runs(seed: int = 0):
    """Per shard, two sorted runs over the shard's own key range (shard
    ``s`` owns the keys ``b"%02d-..." % s``): shadowed versions and
    tombstones to drop.  Host entries ``(keys, meta, vals)`` of 40 rows a
    run."""
    rng = np.random.default_rng(seed)
    geom = SSTGeometry(**KW)
    out = []
    for s in range(SHARDS):
        runs = []
        for r in range(2):
            ids = np.sort(rng.choice(64, 40, replace=False))
            keys = np.stack([formats.pack_key_bytes(b"%02d-key%04d" % (s, i),
                                                    16) for i in ids])
            is_value = (rng.random(40) > 0.2).astype(np.uint32)
            meta = (((np.arange(40) + 1 + 100 * r) << 1) | is_value) \
                .astype(np.uint32)
            vals = rng.integers(0, 2**32, (40, geom.value_words),
                                dtype=np.uint32)
            runs.append((keys, meta, vals))
        out.append(runs)
    return out


def jax_shard_images(runs):
    """Each shard's input image (the two runs built by JAX's flush path,
    concatenated), as numpy."""
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.core import offload as joffload
    jgeom = jformats.SSTGeometry(**KW)
    out = []
    for shard in runs:
        imgs = [joffload.build_image(*(jnp.asarray(a) for a in run),
                                     geom=jgeom, backend="ref")
                for run in shard]
        out.append(tuple(np.asarray(a)
                         for a in jformats.concat_images(imgs)))
    return out


def moe_inputs(n_experts: int):
    """JAX's ``moe_init`` params (numpy) and an input ``[4, 16, d]``."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import moe as jmoe
    jcfg = jax_smoke("phi3.5-moe-42b-a6.6b").with_(**MOE,
                                                    moe_experts=n_experts)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(n_experts),
                                               jcfg))
    x = np.random.default_rng(n_experts).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, p, x


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipe_inputs():
    rng = np.random.default_rng(7)
    params = {"w": (rng.standard_normal((4, 16, 16)) * 0.3)
              .astype(np.float32),
              "b": (rng.standard_normal((4, 16)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((8, 16)).astype(np.float32)
    return params, x


def attn_inputs():
    """q ``[2, 8, 4, 16]``, k and v ``[2, 8, 2, 16]`` (4 query heads, 2 KV
    heads: neither divides a model axis of 4) and positions 0-7."""
    rng = np.random.default_rng(9)
    qkv = tuple(rng.standard_normal((2, 8, h, 16)).astype(np.float32)
                for h in (4, 2, 2))
    return qkv, np.tile(np.arange(8, dtype=np.int32), (2, 1))


# ---------------------------------------------------------------------------
# the world: every check of this file, on each rank
# ---------------------------------------------------------------------------


def _rank_checks(rank, world, inputs):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint.store import CheckpointStore, receive, send
    from repro_torch.distributed import annotate
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import train_step as ts
    import torch.distributed as dist

    out = {}
    geom = SSTGeometry(**KW)
    line = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))

    # -- range-sharded compaction, one key range a rank
    img = formats.concat_images([formats.image_from_numpy(im, "cpu")
                                 for im in inputs["shards"]])
    placed = offload.place_sharded(img, line, ("data",))
    for mode in ("device", "xla"):
        got, stats = offload.sharded_compact(placed, line, ("data",),
                                             geom=geom, sort_mode=mode)
        local = formats.SSTImage(*(a.to_local() for a in got))
        out[f"compact/{mode}"] = (tuple(formats.image_to_numpy(local)),
                                  [tuple(st) for st in stats])
    try:
        offload.sharded_compact(placed, line, ("data",), geom=geom,
                                sort_mode="merge")
        out["merge_raises"] = False
    except ValueError:
        out["merge_raises"] = True

    # -- expert-parallel MoE on (2, 2), forward and gradients
    mesh = make_host_mesh(device="cpu")
    for n_exp in (4, 5):
        cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_(
            **MOE, moe_experts=n_exp)
        p_np, x_np = inputs[f"moe{n_exp}"]
        params = {k: distribute_tensor(torch.from_numpy(v), mesh,
                                       partition.placements((), mesh))
                  .requires_grad_() for k, v in p_np.items()}
        x = distribute_tensor(torch.from_numpy(x_np), mesh,
                              partition.placements((), mesh))
        with annotate.mesh_annotations(mesh), annotate.replicate_plain_tensors():
            y, aux = moe.moe_ffn(params, x, cfg)
            grads = torch.autograd.grad((y ** 2).sum(),
                                        list(params.values()))
        out[f"moe{n_exp}"] = (
            y.full_tensor().detach().numpy(),
            {k: g.full_tensor().numpy() for k, g in zip(params, grads)})

    # -- the production meshes are built only in worlds of their size
    from repro_torch.launch.mesh import make_production_mesh
    refused = []
    for build in (make_production_mesh,
                  lambda device: make_production_mesh(multi_pod=True,
                                                      device=device),
                  lambda device: make_host_mesh(3, device=device)):
        try:
            build(device="cpu")
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused

    # -- the dense-global MoE path under a (4, 1) mesh: the batch sharded
    # over "data", each rank runs its own rows
    mesh41 = make_host_mesh(1, device="cpu")
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_(
        capacity_factor=1.0, moe_top_k=2, moe_experts=4, dtype="float32")
    p_np, x_np = inputs["moe4"]
    params = {k: distribute_tensor(torch.from_numpy(v), mesh41,
                                   partition.placements((), mesh41))
              .requires_grad_() for k, v in p_np.items()}
    x = distribute_tensor(torch.from_numpy(x_np), mesh41,
                          partition.placements(("data",), mesh41))
    with annotate.mesh_annotations(mesh41), annotate.replicate_plain_tensors():
        y, aux = moe.moe_ffn(params, x, cfg)
        grads = torch.autograd.grad((y ** 2).sum() + aux,
                                    list(params.values()))
    out["moe_dense41"] = (
        y.full_tensor().detach().numpy(), float(aux.full_tensor()),
        {k: g.full_tensor().numpy() for k, g in zip(params, grads)})

    # -- attention on (1, 4) with heads that do not divide "model": the
    # query positions sharded over it (the context-parallel route),
    # forward and gradients
    from repro_torch.models import attention
    mesh14 = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                                 "model"))
    qkv, pos = inputs["attn"]
    for chunk in (None, 4):
        q, k, v = (distribute_tensor(torch.from_numpy(a), mesh14, pl)
                   .requires_grad_() for a, pl in zip(
                       qkv, ([Replicate(), Shard(1)], [Replicate()] * 2,
                             [Replicate()] * 2)))
        p_ = torch.from_numpy(pos)
        with annotate.mesh_annotations(mesh14), \
                annotate.replicate_plain_tensors():
            o = attention.mha(q, k, v, p_, p_, causal=True, chunk_kv=chunk)
            grads = torch.autograd.grad((o.float() ** 2).sum(), [q, k, v])
        out[f"attn{chunk}"] = (str(tuple(o.placements)),
                               o.full_tensor().detach().numpy(),
                               [g.full_tensor().numpy() for g in grads])

    # -- the compressed mean over the data axis of a line of 4
    local = inputs["local"][rank]
    mean, err = grad_compress.compressed_grad_mean(
        {"g": torch.from_numpy(local)},
        grad_compress.init_error_state({"g": torch.from_numpy(local)}),
        line, "data")
    out["compressed"] = (mean["g"].numpy(), err["g"].numpy())

    # -- the pipeline over a "pipe" line of 4 stages
    pipe = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
    sp, xp = inputs["pipe"]
    sp = {k: torch.from_numpy(v) for k, v in sp.items()}
    for m in MICRO:
        out[f"pipe{m}"] = pipeline.pipeline_apply(
            sp, torch.from_numpy(xp), stage_fn, pipe,
            microbatches=m).numpy()
    sharded_sp = {k: distribute_tensor(v, pipe, partition.placements(
        ("pipe",), pipe)) for k, v in sp.items()}
    out["pipe_dtensor"] = pipeline.pipeline_apply(
        sharded_sp, torch.from_numpy(xp), stage_fn, pipe).numpy()

    # -- an empty cache built shard by shard on (2, 2): each leaf gathered
    # whole equals the one-device cache's
    from repro_torch.models import model as lm
    from repro_torch.models.convert import tree_leaves as leaves
    cfg = get_smoke_config("jamba-1.5-large-398b")
    whole = lm.init_cache(cfg, 2, 16, device="cpu")
    sharded = lm.init_cache(cfg, 2, 16, device="cpu", mesh=mesh)
    out["init_cache"] = [
        (str(tuple(a.placements)), torch.equal(a.full_tensor(), b))
        for a, b in zip(leaves(sharded), leaves(whole))]

    # -- the checkpoint store: rank 0 saves whole tensors and restores onto
    # (2, 2) shardings; every rank's shard equals the saved tensor's
    cfg = get_smoke_config("qwen3-14b").with_(
        n_layers=2, d_model=32, n_heads=2, kv_heads=2, d_ff=64, vocab=128,
        head_dim=16)
    state = ts.init_state(0, cfg, device="cpu")
    like = ts.abstract_state(cfg)
    shardings = ts.state_shardings(like, cfg, mesh)
    if rank == 0:
        store = CheckpointStore(inputs["ckpt"], device="cpu")
        saved = store.save(5, state)
        restored = store.restore(5, like=like, shardings=shardings)
    else:
        restored = receive(like, shardings, "cpu")
    want = partition.place(state, shardings)
    from repro_torch.models.convert import tree_leaves
    pairs = list(zip(tree_leaves(restored), tree_leaves(want)))
    out["restore"] = (
        len(pairs),
        all(tuple(a.placements) == tuple(b.placements) and
            torch.equal(a.to_local(), b.to_local()) for a, b in pairs),
        sorted({str(tuple(a.placements)) for a, _ in pairs}))

    # -- a save of the sharded state: rank 0 gathers one leaf at a time
    # while the others send; it writes what the save of the whole state did
    out["streamed"] = None
    if rank == 0:
        streamed = store.save(6, want)
        back = store.restore(6, like=like)
        store.close()
        out["streamed"] = (
            streamed["tensors"] == saved["tensors"],
            all(torch.equal(a, b) for a, b in
                zip(tree_leaves(back), tree_leaves(state))))
    else:
        send(want)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    runs = shard_runs()
    inputs = {"shards": jax_shard_images(runs),
              "local": np.random.default_rng(0).standard_normal(
                  (SHARDS, 512)).astype(np.float32),
              "pipe": pipe_inputs(),
              "ckpt": str(tmp_path_factory.mktemp("ckpt") / "db")}
    for n in (4, 5):
        _, p, x = moe_inputs(n)
        inputs[f"moe{n}"] = (p, x)
    inputs["attn"] = attn_inputs()
    return inputs, run_world(_rank_checks, SHARDS, inputs, timeout=900,
                             nice=NICE)


# ---------------------------------------------------------------------------
# sharded compaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["device", "xla"])
def test_sharded_compact_equals_jax_per_shard(world, mode):
    """Each rank's output shard and stats equal JAX's single-device
    ``compaction.compact`` of that shard bit for bit (JAX's plain
    reference backend)."""
    import jax.numpy as jnp
    from repro.core import compaction as jcompaction
    from repro.core import formats as jformats
    inputs, results = world
    jgeom = jformats.SSTGeometry(**KW)
    for s, shard in enumerate(inputs["shards"]):
        want, jst = jcompaction.compact(
            jformats.SSTImage(*(jnp.asarray(a) for a in shard)), geom=jgeom,
            sort_mode=mode, backend="ref")
        got, stats = results[s][f"compact/{mode}"]
        for name, a, b in zip(formats.SSTImage._fields, got, want):
            b = np.asarray(b)
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a.astype(np.uint32),
                                          b.astype(np.uint32), err_msg=name)
        assert stats[s] == tuple(int(x) for x in jst)
        assert stats[s][1] < stats[s][0]      # versions were dropped
        assert all(r[f"compact/{mode}"][1] == stats for r in results)


def test_sharded_compact_rejects_merge_as_jax_does(world):
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import formats as jformats
    from repro.core import offload as joffload
    _, results = world
    assert all(r["merge_raises"] for r in results)
    shard = world[0]["shards"][0]
    import jax
    with pytest.raises(ValueError, match="merge"):
        joffload.sharded_compact(
            jformats.SSTImage(*(jnp.asarray(a) for a in shard)),
            Mesh(np.array(jax.devices()[:1]), ("data",)), ("data",),
            geom=jformats.SSTGeometry(**KW), sort_mode="merge")


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_experts", [4, 5])
def test_ep_moe_equals_jax_dense_and_port_dense(world, n_experts):
    """``_moe_ffn_ep`` on (2, 2) (5 experts: phantom-padded to 6) against
    JAX's dense-global ``moe_ffn`` and the port's dense path: the forward
    within 2e-4, the gradients of ``sum(y**2)`` within 2e-3 (JAX's own
    tolerances)."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    jcfg, p, x = moe_inputs(n_experts)
    _, results = world
    y_ep, g_ep = results[0][f"moe{n_experts}"]
    for r in results[1:]:    # y and the gradients are replicated
        np.testing.assert_array_equal(r[f"moe{n_experts}"][0], y_ep)
    jp = jax.tree.map(jnp.asarray, p)
    yd, _ = jmoe._moe_ffn_dense(jp, jnp.asarray(x), jcfg)
    gd = jax.grad(lambda q: (jmoe._moe_ffn_dense(q, jnp.asarray(x), jcfg)[0]
                             ** 2).sum())(jp)
    np.testing.assert_allclose(y_ep, np.asarray(yd), rtol=2e-4, atol=2e-4)
    for k in gd:
        np.testing.assert_allclose(g_ep[k], np.asarray(gd[k]), rtol=2e-3,
                                   atol=2e-3, err_msg=k)
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_(
        **MOE, moe_experts=n_experts)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in p.items()}
    yt, _ = moe._moe_ffn_dense(tp, torch.from_numpy(x), cfg)
    gt = torch.autograd.grad((yt ** 2).sum(), list(tp.values()))
    np.testing.assert_allclose(y_ep, yt.detach().numpy(), rtol=2e-4,
                               atol=2e-4)
    for k, g in zip(tp, gt):
        np.testing.assert_allclose(g_ep[k], g.numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=k)


def test_meshes_of_another_size_than_the_world_raise(world):
    for r in world[1]:
        prod, pods, host = r["refused"]
        assert "(16, 16)" in prod and "256" in prod and "4 ranks" in prod
        assert "(2, 16, 16)" in pods and "512" in pods
        assert "(1, 3)" in host and "4 ranks" in host


def test_dense_moe_under_a_model_axis_of_one_matches_one_device(world):
    """On a (4, 1) mesh ``moe_ffn`` keeps JAX's dense-global path (its
    capacity ranks every token of the batch, here at a capacity factor of
    1.0, where tokens drop), each rank on its own rows: ``y``, the aux
    loss and the gradients match one device's within 2e-4 (the forward)
    and 2e-3 (the gradients), JAX's own MoE tolerances.  A token dropped
    on one path and kept on the other would be off by its whole output."""
    _, p, x = moe_inputs(4)
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_(
        capacity_factor=1.0, moe_top_k=2, moe_experts=4, dtype="float32")
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in p.items()}
    y, aux = moe._moe_ffn_dense(tp, torch.from_numpy(x), cfg)
    g = torch.autograd.grad((y ** 2).sum() + aux, list(tp.values()))
    for r in world[1]:
        got_y, got_aux, got_g = r["moe_dense41"]
        np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=2e-4,
                                   atol=2e-4)
        assert abs(got_aux - float(aux.detach())) <= 2e-4
        for k, gk in zip(tp, g):
            np.testing.assert_allclose(got_g[k], gk.numpy(), rtol=2e-3,
                                       atol=2e-3, err_msg=k)


# ---------------------------------------------------------------------------
# compressed gradients
# ---------------------------------------------------------------------------


def test_quantize_equals_jax_bit_for_bit():
    import jax.numpy as jnp
    from repro.distributed import grad_compress as jgc
    rng = np.random.default_rng(11)
    for shape in ((512,), (7, 33), (1,)):
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        e = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        jq, js, je = jgc.quantize(jnp.asarray(x), jnp.asarray(e))
        tq, tsc, te = grad_compress.quantize(torch.from_numpy(x),
                                             torch.from_numpy(e))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(tsc.item()) == np.float32(js)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_compressed_mean_within_5_percent_and_error_feedback(world):
    inputs, results = world
    true_mean = inputs["local"].mean(0)
    for r, res in enumerate(results):
        got, err = res["compressed"]
        rel = np.abs(got - true_mean).max() / (np.abs(true_mean).max()
                                               + 1e-9)
        assert rel < 0.05, rel
        np.testing.assert_array_equal(got, results[0]["compressed"][0])
        q, s, e = grad_compress.quantize(
            torch.from_numpy(inputs["local"][r]),
            torch.zeros(512))
        np.testing.assert_array_equal(err, e.numpy())


def test_wire_bytes_equal_jax():
    import jax.numpy as jnp
    from repro.distributed import grad_compress as jgc
    shapes = [(3, 5), (7,), (2, 2, 2)]
    jg = {str(i): jnp.zeros(s) for i, s in enumerate(shapes)}
    tg = {str(i): torch.zeros(s) for i, s in enumerate(shapes)}
    assert grad_compress.wire_bytes_fp32(tg) == jgc.wire_bytes_fp32(jg)
    assert grad_compress.wire_bytes_compressed(tg) == \
        jgc.wire_bytes_compressed(jg)
    e = grad_compress.init_error_state(tg)
    assert all(v.dtype == torch.float32 and not v.any() for v in e.values())


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_matches_sequential_reference(world, m):
    inputs, results = world
    sp, x = inputs["pipe"]
    want = pipeline.sequential_reference(
        {k: torch.from_numpy(v) for k, v in sp.items()},
        torch.from_numpy(x), stage_fn).numpy()
    for r in results:
        np.testing.assert_allclose(r[f"pipe{m}"], want, rtol=1e-5,
                                   atol=1e-5)
    if m == 4:   # stage-sharded DTensor params, 4 microbatches by default
        for r in results:
            np.testing.assert_allclose(r["pipe_dtensor"], want, rtol=1e-5,
                                       atol=1e-5)


def test_sequential_reference_equals_jax():
    import jax.numpy as jnp
    from repro.distributed import pipeline as jpipe
    sp, x = pipe_inputs()
    want = jpipe.sequential_reference(
        {k: jnp.asarray(v) for k, v in sp.items()}, jnp.asarray(x),
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]))
    got = pipeline.sequential_reference(
        {k: torch.from_numpy(v) for k, v in sp.items()},
        torch.from_numpy(x), stage_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the checkpoint store's sharded restore
# ---------------------------------------------------------------------------


def test_restore_onto_shardings_gives_each_rank_its_shard(world):
    _, results = world
    for n, ok, kinds in (r["restore"] for r in results):
        assert n > 10 and ok
        assert len(kinds) > 1       # sharded and replicated leaves both


def test_save_of_a_sharded_state_writes_the_whole_tensors(world):
    """Rank 0's ``save`` of DTensors, the others ``send``ing, writes the
    manifest of the whole state's save, and reads back its tensors bit
    for bit."""
    _, results = world
    assert results[0]["streamed"] == (True, True)
    assert all(r["streamed"] is None for r in results[1:])


def test_sharded_init_cache_equals_the_one_device_cache(world):
    """``model.init_cache(mesh=)`` on (2, 2) (jamba's smoke config: KV
    caches and mamba states): every leaf is sharded somewhere, and each
    gathered whole equals ``init_cache``'s leaf, an empty slot's position
    -1 included."""
    _, results = world
    for r in results:
        got = r["init_cache"]
        assert got and all(same for _, same in got)
        assert any("Shard" in placements for placements, _ in got)


@pytest.mark.parametrize("chunk", [None, 4])
def test_attention_shards_query_positions_when_heads_do_not_divide(world,
                                                                   chunk):
    """ROADMAP A16 (the dry run's production meshes): on (1, 4) with 4
    query and 2 KV heads, ``mha`` of DTensors shards the query positions
    over "model" (its output stays so placed) and equals the one-device
    ``mha``, forward and gradients (the keys' and values' partial sums
    reduced over "model")."""
    from repro_torch.models import attention
    inputs, results = world
    qkv, pos = inputs["attn"]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
    p = torch.from_numpy(pos)
    o = attention.mha(q, k, v, p, p, causal=True, chunk_kv=chunk)
    want = torch.autograd.grad((o.float() ** 2).sum(), [q, k, v])
    for r in results:
        placements, got, grads = r[f"attn{chunk}"]
        assert placements.endswith(", Shard(dim=1))")   # on "model"
        np.testing.assert_allclose(got, o.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5)
