"""The roofline's constants and counters (``repro_torch.roofline``) and the
scan's shape-only route, against the JAX package's roofline (ROADMAP
A16).

The port's dot FLOPs of a forward equal ``repro.roofline.hlo_flops.
hlo_dot_flops`` of JAX's compiled unsharded forward exactly; the dry run's
per-device argument bytes equal what JAX's partition specs give rank 0 on
the production meshes, for every arch; the counters and the memory
estimate equal hand counts.  A fake world runs in a subprocess that owns
its process group.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.distributed import partition as jpart
from repro.models import model as jmodel
from repro.roofline.hlo_flops import hlo_dot_flops
from repro.serving import serve_step as jss
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import partition
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as scan_kernel
from repro_torch.launch import dryrun
from repro_torch.models import model
from repro_torch.roofline import constants
from repro_torch.roofline.counts import Counts
from repro_torch.roofline.memory import PeakMemory

REPO = Path(__file__).resolve().parents[1]
ARCH_NAMES = sorted(ARCHS)
FLOP_ARCHS = ("falcon-mamba-7b", "gemma3-4b", "granite-moe-3b-a800m",
              "qwen3-14b")
PROD_MESHES = [((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]
KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread in this worker, as the suite's other torch
    files: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_are_the_h100s_data_sheet():
    assert constants.PEAK_FLOPS_BF16 == 989.4e12
    assert constants.HBM_BW == 3.35e12
    assert constants.HBM_PER_CHIP == 80 * 10**9
    assert (constants.SCALAR_OPS_PER_S, constants.SFU_PER_CLOCK_PER_SM,
            constants.H100_SMS) == (67e12, 16, 132)
    # an axis inside a node runs over NVLink, a longer one crosses nodes
    assert [constants.link_bw(n) for n in (1, 2, 8, 16, 32)] == [
        450e9, 450e9, 450e9, 50e9, 50e9]
    values = {v for k, v in vars(constants).items() if k.isupper()}
    assert not values & {197e12, 819e9, 16 * 2**30}   # no TPU v5e figure


# ---------------------------------------------------------------------------
# dot FLOPs against JAX's compiled HLO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_forward_dot_flops_equal_jax_hlo(arch):
    """fp32 smoke configs, 2 x 64 tokens from a numpy seed: the port's
    forward on the CPU counted by ``Counts`` (and by ``FlopCounterMode``)
    against ``hlo_dot_flops`` of JAX's compiled forward.  falcon's scan is
    counted by its registered formula, JAX's as the dot at
    ``mamba.py:120``."""
    jcfg = jax_smoke(arch).with_(dtype="float32")
    tcfg = get_smoke_config(arch).with_(dtype="float32")
    tokens = np.random.default_rng(33).integers(
        0, tcfg.vocab, (2, 64)).astype(np.int32)
    jp = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jcfg))
    txt = jax.jit(lambda p, b: jmodel.forward(p, b, jcfg)).lower(
        jp, {"tokens": jnp.asarray(tokens)}).compile().as_text()
    want = hlo_dot_flops(txt)["flops"]
    params = model.init(0, tcfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    with Counts() as counts:
        model.forward(params, batch, tcfg)
    with FlopCounterMode(display=False) as fc:
        model.forward(params, batch, tcfg)
    assert counts.dot_flops()["flops"] == want == fc.get_total_flops()
    assert counts.dot_flops()["dot_ops"] > 0


# ---------------------------------------------------------------------------
# parameter counts and argument bytes against JAX, every arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_and_model_flops_equal_jax(arch):
    jcfg, tcfg = jax_config(arch), dryrun.lm_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for name, shape in SHAPES.items():
        tokens = shape.batch if shape.kind == "decode" else \
            shape.batch * shape.seq
        per = 6 if shape.kind == "train" else 2
        assert dryrun.model_flops(tcfg, shape) == (
            tokens, per * jcfg.active_param_count() * tokens), name


def jax_rank0_bytes(structs, specs, mesh) -> int:
    """Rank 0's bytes of every leaf of ``structs`` sharded by ``specs`` on
    JAX's abstract ``mesh``: each dim divided, rounding up, by the sizes
    of the axes its spec entry names."""
    leaves = jax.tree.leaves(structs)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    shape[d] = -(-shape[d] // mesh.shape[a])
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


def jax_arguments(jcfg, shape, mesh):
    """JAX's step arguments and their specs, as its shard builders make
    them (``shard_train_step``, ``shard_prefill``,
    ``shard_decode_step(fsdp=True)``)."""
    if shape.kind == "train":
        opt_cfg = jopt.AdamWConfig(state_dtype="bfloat16" if
                                   jcfg.param_count() > 1e11 else "float32")
        state = jts.abstract_state(jcfg, opt_cfg)
        ps = jpart.param_specs(state.params, jcfg, mesh, fsdp=True)
        batch = jts.make_batch_struct(jcfg, shape.batch, shape.seq)
        return (state, batch), (jts.TrainState(
            params=ps, opt=jopt.OptState(m=ps, v=ps, step=P())),
            jpart.batch_specs(batch, mesh))
    params = jss.abstract_params(jcfg)
    if shape.kind == "prefill":
        batch = jss.make_prefill_batch_struct(jcfg, shape.batch, shape.seq)
        return (params, batch), (
            jpart.param_specs(params, jcfg, mesh, fsdp=False),
            jpart.batch_specs(batch, mesh))
    cache = jss.abstract_cache(jcfg, shape.batch, shape.seq)
    bspec = tuple(jpart.batch_spec(mesh, shape.batch))
    one = jax.ShapeDtypeStruct((shape.batch, 1), jnp.int32)
    structs = [params, cache, one, one]
    specs = [jpart.param_specs(params, jcfg, mesh, fsdp=True),
             jpart.cache_specs(cache, mesh, shape.batch),
             P(*bspec, None), P(*bspec, None)]
    if jcfg.enc_dec:
        structs.append(jax.ShapeDtypeStruct(
            (shape.batch, 1500, jcfg.d_model), jnp.bfloat16))
        specs.append(P(*bspec, None, None))
    return tuple(structs), tuple(specs)


@pytest.mark.parametrize("kind", sorted(KIND_SHAPES))
@pytest.mark.parametrize("mesh_shape,names", PROD_MESHES,
                         ids=["x".join(map(str, s)) for s, _ in PROD_MESHES])
def test_argument_bytes_equal_jax_specs_for_every_arch(mesh_shape, names,
                                                       kind):
    """Rank 0's argument bytes of each arch's production cell (full
    config, the dry run's bf16) on (16, 16) and (2, 16, 16): the port's
    partition rules on an ``AbstractMesh`` against JAX's specs on
    ``jax.sharding.AbstractMesh`` for JAX's abstract state, params,
    batch and cache."""
    shape = SHAPES[KIND_SHAPES[kind]]
    jm = JaxAbstractMesh(mesh_shape, names)
    tm = partition.AbstractMesh(mesh_shape, names)
    for arch in ARCH_NAMES:
        jcfg = jax_config(arch).with_(dtype="bfloat16",
                                      attn_chunk_min_seq=4096)
        tcfg = dryrun.lm_config(arch)
        want = jax_rank0_bytes(*jax_arguments(jcfg, shape, jm), jm)
        got = dryrun.argument_bytes(*dryrun.arguments(tcfg, shape, tm), tm)
        assert got == want, (arch, kind, got, want)


# ---------------------------------------------------------------------------
# the counters against hand counts
# ---------------------------------------------------------------------------

WORLD_CODE = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import build_mesh, fake_world
from repro_torch.roofline.counts import Counts, LocalOps, propagating
from repro_torch.roofline.memory import PeakMemory

torch.set_num_threads(1)
out = {}
with fake_world(8):
    mesh = build_mesh((4, 2), ("data", "model"), "cpu")
    with FakeTensorMode():
        # x [256, 512] rows over data; w [512, 1024] columns over model
        x = DTensor.from_local(torch.empty(64, 512), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(512, 512), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        mem = PeakMemory()
        mem.hold((x, w))
        with Counts() as c, mem:
            y = x @ w
            z = y.redistribute(mesh, [Shard(0), Replicate()])
        out["product"] = dict(flops=c.dot_flops(), bytes=c.traffic_bytes(),
                              coll=c.collective_bytes(),
                              mem=mem.analysis(z))
        # a [256, 512] @ b [512, 128], the contraction split over model: a
        # partial sum, then all-reduced
        a = DTensor.from_local(torch.empty(64, 256), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        b = DTensor.from_local(torch.empty(256, 128), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        with Counts() as c:
            (a @ b).redistribute(mesh, [Shard(0), Replicate()])
            t = torch.empty(64, 32)
            funcol.wait_tensor(funcol.all_to_all_single(
                t, None, None, group=mesh.get_group("data")))
        out["partial"] = dict(flops=c.dot_flops(), coll=c.collective_bytes())
        # DTensor's propagation runs the product at the global shapes: the
        # counters see it marked, and count only rank 0's local product
        class Probe(LocalOps):
            def __init__(self):
                super().__init__()
                self.shapes = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten.mm.default and not any(
                        issubclass(t, DTensor) for t in types):
                    self.shapes.append([list(args[0].shape), propagating()])
                return super().__torch_dispatch__(func, types, args, kwargs)

            def on_op(self, *a):
                pass
        x2 = DTensor.from_local(torch.empty(64, 96), mesh,
                                [Shard(0), Replicate()], run_check=False)
        w2 = DTensor.from_local(torch.empty(96, 40), mesh,
                                [Replicate(), Shard(1)], run_check=False)
        with Probe() as probe:
            x2 @ w2
        out["probe"] = probe.shapes
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def world_counts(tmp_path_factory):
    """The counters in an 8-rank fake world, (4, 2) mesh, in a subprocess
    that owns the process group."""
    path = tmp_path_factory.mktemp("counts") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", WORLD_CODE, str(path)], env=env,
                   check=True, timeout=300, cwd=REPO)
    return json.loads(path.read_text())


def test_counters_on_a_sharded_product_and_a_redistribute(world_counts):
    r = world_counts["product"]
    # rank 0's product: its 64 rows against its 512 of w's columns
    assert r["flops"] == {"flops": 2.0 * 64 * 512 * 512, "dot_ops": 1}
    y = 64 * 512 * 4                       # rank 0's shard of y, fp32
    # the product reads x and w and writes y; the redistribute gathers y
    # over "model" (operand y, result 2 y) and lays the two column halves
    # side by side (reads 2 y, writes 2 y); views and waits move nothing
    product = (64 * 512 + 512 * 512) * 4 + y
    assert r["bytes"] == {"bytes": float(product + 3 * y + 4 * y)}
    assert r["coll"] == {"all-gather": {"bytes": y, "count": 1,
                                        "seconds": y / 450e9},
                         "total_bytes": y}
    args = (64 * 512 + 512 * 512) * 4
    # live at the peak: the arguments, y, the gathered y (2 y) and the
    # output (2 y)
    assert r["mem"] == {"argument_bytes": args, "output_bytes": 2 * y,
                        "temp_bytes": 3 * y, "alias_bytes": 0,
                        "peak_bytes": args + 5 * y}


def test_counters_on_a_partial_sum_and_an_all_to_all(world_counts):
    r = world_counts["partial"]
    # rank 0 contracts its 256 of the 512: half the product's FLOPs
    assert r["flops"] == {"flops": 2.0 * 64 * 256 * 128, "dot_ops": 1}
    partial = 64 * 128 * 4
    alltoall = 64 * 32 * 4
    assert r["coll"] == {
        "all-reduce": {"bytes": partial, "count": 1,
                       "seconds": partial / 450e9},
        "all-to-all": {"bytes": alltoall, "count": 1,
                       "seconds": alltoall / 450e9},
        "total_bytes": partial + alltoall}


def test_sharding_propagation_is_marked_and_not_counted(world_counts):
    """The product DTensor's propagation runs at the global shape (256
    rows) comes with ``propagating()`` set; rank 0's local one (64 rows)
    without."""
    shapes = world_counts["probe"]
    assert [[64, 96], False] in shapes and [[256, 96], True] in shapes
    assert all(p for s, p in shapes if s != [64, 96])


def test_ops_on_meta_tensors_count_nothing():
    """A ``meta`` tensor is a shape with no data (the serving cache's
    shapes are built so): its ops count no bytes and hold no memory."""
    mem = PeakMemory()
    with Counts() as counts, mem:
        a = torch.zeros((1000, 16), device="meta")
        a.repeat(4, 1).sum()
        torch.full((8,), -1, device="meta")
    assert counts.traffic_bytes() == {"bytes": 0.0}
    assert mem.peak == 0


def test_peak_memory_on_a_known_sequence_of_allocations():
    with FakeTensorMode():
        a = torch.empty(250)                     # 1,000 B, the argument
        mem = PeakMemory()
        mem.hold(a)
        with mem:
            b = a + 1                            # 1,000 B
            c = torch.zeros(200)                 # 800 B
            v = b.view(10, 25)                   # a view: no storage
            v.mul_(2)                            # in place: none
            del b, v                             # 1,000 B freed
            d = torch.ones(25, dtype=torch.float64)   # 200 B
        got = mem.analysis((c, d))
    assert got == {"argument_bytes": 1000, "output_bytes": 1000,
                   "temp_bytes": 800, "alias_bytes": 0,
                   "peak_bytes": 2800}
    assert mem.live == 2000


# ---------------------------------------------------------------------------
# the scan's shape-only route
# ---------------------------------------------------------------------------


def scan_inputs(bsz=2, seq=12, di=8, ds=4, seed=3):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    return (f(bsz, seq, di), torch.nn.functional.softplus(f(bsz, seq, di)),
            f(bsz, seq, ds), f(bsz, seq, ds), f(di, ds, scale=0.5),
            f(di), f(bsz, di, ds))


def shapes_dtypes(ts):
    return [None if t is None else (tuple(t.shape), t.dtype) for t in ts]


def test_scan_fake_and_meta_inputs_take_the_shape_only_route(monkeypatch):
    args = scan_inputs()
    want_y = ref.selective_scan(*args)
    y_dy = torch.ones_like(want_y[0])
    want_g = ref.selective_scan_bwd(*args, y_dy, None)

    def never(*a, **kw):
        raise AssertionError("a fake input reached a kernel or the plain "
                             "version")
    for owner, name in ((scan_kernel, "selective_scan"),
                        (scan_kernel, "selective_scan_bwd"),
                        (ref, "selective_scan"),
                        (ref, "selective_scan_bwd")):
        monkeypatch.setattr(owner, name, never)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t).requires_grad_() for t in args]
        y, h = ops.selective_scan(*fake)
        grads = torch.autograd.grad(y, fake, torch.ones_like(y))
    assert shapes_dtypes((y, h)) == shapes_dtypes(want_y)
    assert shapes_dtypes(grads) == shapes_dtypes(want_g)
    meta = [t.to("meta") for t in args]
    assert shapes_dtypes(ops.selective_scan(*meta)) == shapes_dtypes(want_y)
    assert shapes_dtypes(ops.selective_scan(*meta[:6])) == \
        shapes_dtypes(want_y)


def test_store_kernels_take_the_shape_only_route_on_meta():
    keys = torch.empty((64, 4), dtype=torch.int32, device="meta")
    count = torch.empty((), dtype=torch.int64, device="meta")
    shared, wire = ops.prefix_encode_wire(keys, count)
    assert shapes_dtypes((shared, wire)) == [((64,), torch.int32),
                                             ((64, 4), torch.int32)]
    assert shapes_dtypes([ops.bitonic_sort(keys)]) == [((64, 4),
                                                        torch.int32)]
    assert shapes_dtypes([ops.crc32_sections([keys, keys[:, :2]])]) == [
        ((64,), torch.int32)]
    groups = keys.reshape(4, 16, 4)
    assert shapes_dtypes([ops.bloom_build(groups, n_words=5,
                                          n_probes=6)]) == [
        ((4, 5), torch.int32)]


class OpNames(TorchDispatchMode):
    """Records the name of each op that reaches it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.name())
        return func(*args, **(kwargs or {}))


def dispatched(fn) -> list[str]:
    """The ``repro_torch`` operators that the profiler saw ``fn`` call."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted({e.name for e in prof.events()
                   if e.name.startswith("repro_torch::")})


def test_real_tensors_reach_the_operators_only_under_a_dispatch_mode():
    """A plain call on real tensors skips the dispatcher's way through the
    operators (its cost a call); under a dispatch mode, a counter's, each
    kernel is one op, the plain versions' own ops unseen, and the values
    are the same."""
    rows = torch.from_numpy(np.random.default_rng(5).integers(
        0, 1000, (64, 4)).astype(np.int32))
    args = scan_inputs()

    def calls():
        return (ops.bitonic_sort(rows), ops.crc32_sections([rows]),
                *ops.prefix_encode_wire(rows, torch.tensor(64)),
                ops.bloom_build(rows.reshape(4, 16, 4), n_words=5,
                                n_probes=6),
                *ops.selective_scan(*args))
    plain = calls()
    assert dispatched(calls) == []
    mode = OpNames()
    with mode:
        counted = calls()
    assert [n for n in mode.names if n.startswith("repro_torch::")] == [
        "repro_torch::bitonic_sort", "repro_torch::crc32_sections",
        "repro_torch::prefix_encode_wire", "repro_torch::bloom_build",
        "repro_torch::selective_scan"]
    # the calls' own argument ops, none of the plain versions' (the
    # scan's alone runs hundreds)
    assert len(mode.names) < 10
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))
    with OpNames():
        assert len(dispatched(calls)) == 5


def test_scan_real_cpu_inputs_run_the_plain_version():
    args = scan_inputs()
    y, h = ops.selective_scan(*args)
    want = ref.selective_scan(*args)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = ops.selective_scan(*leaves)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(y.shape)).astype(np.float32))
    got = torch.autograd.grad(y, leaves, dy)
    want = ref.selective_scan_bwd(*args, dy, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_scan_cuda_inputs_are_routed_to_the_kernel(monkeypatch):
    """A tensor ``_on_card`` takes for a card's goes to the kernel's
    wrappers (stand-ins here for the launches, which need a card: the
    forward's gives the plain values, the gradient's zeros)."""
    calls = []

    def fwd(*a):
        calls.append("fwd")
        return ref.selective_scan(*a)

    def bwd(u, dt, b, c, a_log, d_skip, h0, dy, dh_last):
        calls.append("bwd")
        return (*(torch.zeros_like(t) for t in (u, dt, b, c, a_log,
                                                  d_skip)),
                None if h0 is None else torch.zeros_like(h0))
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(scan_kernel, "selective_scan", fwd)
    monkeypatch.setattr(scan_kernel, "selective_scan_bwd", bwd)
    args = [t.requires_grad_() for t in scan_inputs()]
    y, _ = ops.selective_scan(*args)
    grads = torch.autograd.grad(y.sum(), args)
    assert calls == ["fwd", "bwd"]
    assert all(not g.any() for g in grads)


def test_scan_flop_formulas_count_jaxs_dot():
    args = [t.requires_grad_() for t in scan_inputs()]
    bsz, seq, di = args[0].shape
    ds = args[2].shape[-1]
    with FlopCounterMode(display=False) as fc:
        y, _ = ops.selective_scan(*args)
    assert fc.get_total_flops() == 2 * bsz * seq * di * ds
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(y.sum(), args)
    assert fc.get_total_flops() == 2 * bsz * seq * di * ds
