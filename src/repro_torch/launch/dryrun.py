"""The dry run for the H100: every (arch x shape x mesh) cell traced on
fake tensors, one rank of the production mesh, and its memory, FLOPs,
traffic and collectives written out per device (the twin of the JAX
package's ``repro.launch.dryrun``, with the same record keys, so that its
``repro.roofline.analysis`` reads these files too).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --compaction
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch falcon-mamba-7b --shape decode_32k

Where JAX lowers and compiles a cell on 512 host devices, the port traces
it: a fake world of 256 or 512 ranks (``launch.mesh.fake_world``) holds
the mesh, this process is its rank 0, and the step (``shard_train_step``,
``shard_prefill`` or ``shard_decode_step(fsdp=True)``) runs once on fake
DTensors placed by the partition rules, under ``roofline.counts.Counts``
and ``roofline.memory.PeakMemory``.  So a cell's numbers are rank 0's:
its local ops, its collectives and its live storages.  The record:

* ``compile_seconds``: the trace's seconds (there is no compile);
* ``memory``: ``argument_bytes`` from the partition rules on a
  ``partition.AbstractMesh`` (rank 0's shard of every argument; the trace's
  own count must agree), ``output_bytes`` and ``temp_bytes`` from the
  trace, ``alias_bytes`` 0 (the port donates no argument), and
  ``peak_estimate_bytes`` the trace's peak, arguments, outputs and
  temporaries together (JAX's leaves out the outputs, which alias its
  donated arguments); ``fits`` against ``constants.HBM_PER_CHIP``;
* ``cost``: ``flops_per_device`` (``Counts.dot_flops``),
  ``bytes_per_device`` (``Counts.traffic_bytes``) and their totals over
  the mesh.  JAX's ``cost_analysis_flops_per_device`` (XLA's own estimate,
  which counts a loop body once) has no counterpart and is left out;
* ``collectives`` (``Counts.collective_bytes``) and ``roofline``:
  ``compute_s`` over ``PEAK_FLOPS_BF16``, ``memory_s`` over ``HBM_BW``,
  ``collective_s`` each collective's bytes over its group's link
  (``constants.link_bw``: NVLink inside a node, the network beyond), and
  the ``dominant`` term.

These are estimates from the data sheet's peaks, not measurements.  The
entry point runs on the card unless asked for the CPU (``--device cpu``);
the traces need no device memory, the compaction cell runs one shard for
real on the device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCHS, SHAPES, get_config, skip_reason
from repro_torch.device import resolve_device
from repro_torch.distributed import partition
from repro_torch.launch.mesh import (build_mesh, fake_world,
                                     production_mesh_shape)
from repro_torch.models.convert import tree_map
from repro_torch.roofline import constants
from repro_torch.roofline.counts import Counts
from repro_torch.roofline.memory import PeakMemory

OUT_DIR = "build/dryrun"


def _analyze(counts: Counts, memory: dict, mesh_shape: dict, *,
             seconds: float, extra: dict) -> dict:
    """JAX's record from the trace's counters and memory (``memory``: the
    fields of ``PeakMemory.analysis``, ``argument_bytes`` from the
    partition rules)."""
    n = math.prod(mesh_shape.values())
    dot = counts.dot_flops()
    flops_dev = dot["flops"]
    bytes_dev = counts.traffic_bytes()["bytes"]
    peak = (memory["argument_bytes"] + memory["output_bytes"]
            + memory["temp_bytes"] - memory["alias_bytes"])
    rec = {
        "mesh": {"shape": dict(mesh_shape), "devices": n},
        "compile_seconds": seconds,
        "memory": {
            "argument_bytes": memory["argument_bytes"],
            "output_bytes": memory["output_bytes"],
            "temp_bytes": memory["temp_bytes"],
            "alias_bytes": memory["alias_bytes"],
            "peak_estimate_bytes": peak,
            "hbm_per_chip": constants.HBM_PER_CHIP,
            "fits": peak < constants.HBM_PER_CHIP,
            "note": "alias_bytes 0: the port donates no argument, so the "
                    "outputs count in the peak beside the arguments",
        },
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev,
                 "flops_global": flops_dev * n,
                 "bytes_global": bytes_dev * n,
                 "dot_flop_stats": dot},
        "collectives": counts.collective_bytes(),
        "roofline": {
            "compute_s": flops_dev / constants.PEAK_FLOPS_BF16,
            "memory_s": bytes_dev / constants.HBM_BW,
            "collective_s": counts.collective_seconds(),
        },
        **extra,
    }
    terms = rec["roofline"]
    rec["roofline"]["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return rec


# ---------------------------------------------------------------------------
# arguments: rank 0's shards
# ---------------------------------------------------------------------------


def _is_pair(x) -> bool:
    """A batch struct's leaf: a ``(shape, dtype)`` pair."""
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[1], torch.dtype)


def _struct(leaf) -> tuple[tuple, torch.dtype]:
    """``(shape, dtype)`` of a ``meta`` tensor or of a pair."""
    if _is_pair(leaf):
        return tuple(leaf[0]), leaf[1]
    return tuple(leaf.shape), leaf.dtype


def shard_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` placed by ``spec`` on
    ``mesh`` (a ``DeviceMesh`` or a ``partition.AbstractMesh``): each dim
    divided, rounding up, by the sizes of the axes its entry names."""
    axes = partition.mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for a in names:
            if a is not None:
                out[d] = -(-out[d] // axes[a])
    return tuple(out)


def argument_bytes(structs, specs, mesh) -> int:
    """Rank 0's bytes of every argument: the shards ``specs`` (a spec tree
    of ``structs``'s structure) give on ``mesh``."""
    sizes = []

    def one(leaf, spec):
        shape, dtype = _struct(leaf)
        sizes.append(math.prod(shard_shape(shape, spec, mesh))
                     * dtype.itemsize)
    tree_map(one, structs, specs, is_leaf=_is_pair)
    return sum(sizes)


def abstract(mesh) -> partition.AbstractMesh:
    """``mesh``'s axis names and sizes (read outside any fake mode: a
    ``DeviceMesh`` holds its ranks in a real tensor)."""
    axes = partition.mesh_axes(mesh)
    return partition.AbstractMesh(tuple(axes.values()), tuple(axes))


def _fake_args(structs, specs, mesh, amesh, device):
    """Fake DTensors of ``structs`` placed by ``specs`` on ``mesh`` (whose
    axes ``amesh`` gives): each rank 0's fake shard, of the global shape.
    Call inside a ``FakeTensorMode``."""
    def one(leaf, spec):
        shape, dtype = _struct(leaf)
        local = torch.empty(shard_shape(shape, spec, amesh), dtype=dtype,
                            device=device)
        stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
        return DTensor.from_local(local, mesh,
                                  partition.placements(spec, amesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)
    return tree_map(one, structs, specs, is_leaf=_is_pair)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def train_opt(cfg):
    """JAX's dry-run optimizer: capacity-bound giants (above 1e11
    parameters) keep their Adam moments in bf16."""
    from repro_torch.training import optimizer as opt
    return opt.AdamWConfig(state_dtype="bfloat16" if cfg.param_count() > 1e11
                           else "float32")


def model_flops(cfg, shape) -> tuple[int, int]:
    """``(tokens a step, the model's FLOPs a step)``, as JAX's dry run
    counts them: 6 (train) or 2 FLOPs an active parameter a token."""
    tokens = shape.batch if shape.kind == "decode" else \
        shape.batch * shape.seq
    per = 6 if shape.kind == "train" else 2
    return tokens, per * cfg.active_param_count() * tokens


def arguments(cfg, shape, mesh) -> tuple:
    """``(structs, specs)`` of the cell's step arguments on ``mesh`` (a
    ``DeviceMesh`` or a ``partition.AbstractMesh``): the train state and
    batch, the serving params and batch, or the params, cache, tokens and
    positions (and the encoder's frames for an encoder-decoder), each
    leaf a ``meta`` tensor or a ``(shape, dtype)`` pair, placed as JAX's
    steps place them."""
    from repro_torch.serving import serve_step
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    if shape.kind == "train":
        state_s = ts.abstract_state(cfg, train_opt(cfg))
        batch_s = ts.make_batch_struct(cfg, shape.batch, shape.seq)
        ps = partition.param_specs(state_s.params, cfg, mesh, fsdp=True)
        return (state_s, batch_s), (
            ts.TrainState(params=ps, opt=opt.OptState(m=ps, v=ps, step=())),
            partition.batch_specs(batch_s, mesh))
    params_s = serve_step.abstract_params(cfg)
    if shape.kind == "prefill":
        batch_s = serve_step.make_prefill_batch_struct(cfg, shape.batch,
                                                       shape.seq)
        return (params_s, batch_s), (
            partition.param_specs(params_s, cfg, mesh, fsdp=False),
            partition.batch_specs(batch_s, mesh))
    # decode; fsdp=True: serving weights shard over the data axes too
    # (ZeRO-inference), as JAX's
    cache_s = serve_step.abstract_cache(cfg, shape.batch, shape.seq)
    bspec = partition.batch_spec(mesh, shape.batch)
    one = ((shape.batch, 1), torch.int32)
    structs = (params_s, cache_s, one, one)
    specs = (partition.param_specs(params_s, cfg, mesh, fsdp=True),
             partition.cache_specs(cache_s, mesh, shape.batch),
             bspec + (None,), bspec + (None,))
    if cfg.enc_dec:   # whisper: 1,500 encoder frames
        structs += (((shape.batch, 1500, cfg.d_model), torch.bfloat16),)
        specs += (bspec + (None, None),)
    return structs, specs


def step_fn(cfg, shape, mesh):
    """The cell's step on ``mesh``: ``shard_train_step``,
    ``shard_prefill`` or ``shard_decode_step(fsdp=True)``."""
    from repro_torch.serving import serve_step
    from repro_torch.training import train_step as ts
    if shape.kind == "train":
        return ts.shard_train_step(cfg, mesh, batch=shape.batch,
                                   seq=shape.seq, opt_cfg=train_opt(cfg))[0]
    if shape.kind == "prefill":
        return serve_step.shard_prefill(cfg, mesh, batch=shape.batch,
                                        seq=shape.seq)[0]
    return serve_step.shard_decode_step(cfg, mesh, batch=shape.batch,
                                        cache_len=shape.seq, fsdp=True)[0]


def trace_step(fn, structs, specs, mesh, device) -> tuple[Counts, dict,
                                                          float]:
    """``fn(*args)`` once on fake DTensors of ``structs`` placed by
    ``specs``, counted: ``(counts, memory fields, seconds)``."""
    amesh = abstract(mesh)
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = _fake_args(structs, specs, mesh, amesh, device)
        memory = PeakMemory()
        memory.hold(args)
        with Counts() as counts, memory:
            out = fn(*args)
        fields = memory.analysis(out)
        del out, args
    return counts, fields, time.perf_counter() - t0


def lm_cell(cfg, shape, mesh_shape: tuple, axis_names: tuple,
            device=None) -> dict:
    """The record of ``cfg`` at ``shape`` (a ``ShapeSpec``) on a mesh of
    ``mesh_shape`` with ``axis_names``, traced in a fake world of its
    size.  The record's ``arch`` and ``shape`` keys are the caller's."""
    dev = resolve_device(device)
    amesh = partition.AbstractMesh(tuple(mesh_shape), tuple(axis_names))
    structs, specs = arguments(cfg, shape, amesh)
    want = argument_bytes(structs, specs, amesh)
    tokens, flops = model_flops(cfg, shape)
    with fake_world(math.prod(mesh_shape)):
        mesh = build_mesh(tuple(mesh_shape), tuple(axis_names), dev)
        counts, memory, seconds = trace_step(step_fn(cfg, shape, mesh),
                                             structs, specs, mesh, dev)
    if memory["argument_bytes"] != want:
        raise AssertionError(f"the trace held {memory['argument_bytes']} "
                             f"argument bytes, the partition rules give "
                             f"{want}")
    rec = _analyze(counts, memory, amesh.shape, seconds=seconds, extra={
        "kind": shape.kind, "tokens_per_step": tokens,
        "model_flops": flops,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "device": dev.type,
    })
    rec["useful_flops_ratio"] = (flops /
                                 max(rec["cost"]["flops_global"], 1.0))
    return rec


def lm_config(arch: str):
    """JAX's dry-run config of ``arch``: bf16, chunked attention from 4,096
    tokens."""
    return get_config(arch).with_(dtype="bfloat16", attn_chunk_min_seq=4096)


def run_lm_cell(arch: str, shape_name: str, multi_pod: bool, *,
                device=None) -> dict:
    reason = skip_reason(arch, shape_name)
    if reason:
        return {"skipped": reason}
    rec = lm_cell(lm_config(arch), SHAPES[shape_name],
                  *production_mesh_shape(multi_pod=multi_pod), device)
    rec.update(arch=arch, shape=shape_name)
    return rec


# ---------------------------------------------------------------------------
# the compaction cell
# ---------------------------------------------------------------------------


def compaction_image(blocks: int, geom, seed: int, device):
    """An L0 job of ``blocks`` blocks (at least 4) at ``geom``: four
    sorted runs of ``blocks // 4`` blocks over one key space, a tenth of
    the entries tombstones, later runs shadowing earlier ones, each packed
    by ``offload.build_image`` (a flush) on ``device``, then padded with
    empty blocks up to ``blocks``; keys and values from ``seed``."""
    from repro_torch.core import formats, offload
    if blocks < 4:
        raise ValueError(f"a job of four runs needs 4 blocks, got {blocks}")
    rng = np.random.default_rng(seed)
    rows = blocks // 4 * geom.block_kvs
    lanes = geom.key_lanes
    images = []
    for r in range(4):
        ids = np.sort(rng.choice(2 * rows, rows, replace=False))
        keys = np.zeros((rows, lanes), dtype=np.uint32)
        keys[:, 0] = 0x6B657900          # a prefix every key shares
        keys[:, lanes - 1] = ids.astype(np.uint32)
        is_value = (rng.random(rows) >= 0.1).astype(np.uint32)
        meta = (((np.arange(rows, dtype=np.uint32) + 1 + r * rows) << 1)
                | is_value).astype(np.uint32)
        vals = rng.integers(0, 2**32, (rows, geom.value_words),
                            dtype=np.uint32)
        k, m, v = formats.words_to_tensors([keys, meta, vals], device)
        images.append(offload.build_image(k, m, v, geom=geom))
    return offload.pad_image_blocks(formats.concat_images(images), blocks,
                                    geom)


def run_compaction_cell(multi_pod: bool, blocks_per_shard: int = 2048, *,
                        device=None, seed: int = 0) -> dict:
    """The paper's technique on the production mesh: range-partitioned
    device compaction, one LUDA pipeline a rank (``offload.
    sharded_compact``).  The pipeline reads its counts back to the host,
    so the cell cannot be traced on fake tensors: it runs one shard for
    real, ``compaction.compact(sort_mode="device")`` of a
    ``blocks_per_shard``-block image at ``PAPER.geometry(256)`` on the
    device, counted by the same modes (its kernels count once each, with
    their operands and results), then run once more, uncounted, timed by
    the device's clock (``job_seconds``: CUDA events on the card, the host
    clock on the CPU; the counted run is host-bound).
    The shards are uniform, so one shard's numbers are each device's.  The
    collective terms come from tracing ``sharded_compact``'s placement
    (``offload.shard_local``, ``shard_global``) on the fake world: a placed
    image moves nothing.  Its exchange of the shards' stats (one
    ``all_gather_object`` of a few hundred bytes a rank, read on the host)
    is not traced.  ``wire_bytes_global`` and ``entries_global`` keep
    JAX's meaning: the whole mesh's input."""
    from repro_torch.configs.luda_paper import PAPER
    from repro_torch.core import compaction, formats, offload
    from repro_torch.device import DeviceTimer
    dev = resolve_device(device)
    geom = PAPER.geometry(256)
    mesh_shape, names = production_mesh_shape(multi_pod=multi_pod)
    n = math.prod(mesh_shape)
    b = n * blocks_per_shard
    img = compaction_image(blocks_per_shard, geom, seed, dev)
    memory = PeakMemory()
    memory.hold(img)
    t0 = time.perf_counter()
    with Counts() as counts, memory:
        out, stats = compaction.compact(img, geom=geom, sort_mode="device")
    fields = memory.analysis(out)
    timer = DeviceTimer(dev)
    t1 = time.perf_counter()
    with timer.span("job"):
        compaction.compact(img, geom=geom, sort_mode="device")
    job_s = timer.seconds("job") if timer.enabled else \
        time.perf_counter() - t1
    # the placement on the whole mesh: every field's block axis over every
    # mesh axis, rank 0 holding this image's shapes
    structs = {f: ((n * a.shape[0],) + tuple(a.shape[1:]), a.dtype)
               for f, a in zip(img._fields, img)}
    with fake_world(n):
        mesh = build_mesh(mesh_shape, names, dev)
        amesh = abstract(mesh)
        with FakeTensorMode():
            placed = formats.SSTImage(**_fake_args(
                structs, {f: (names,) for f in structs}, mesh, amesh, dev))
            with Counts() as placement:
                offload.shard_global(offload.shard_local(placed, mesh, names),
                                     mesh, names)
    counts.collectives = placement.collectives
    seconds = time.perf_counter() - t0
    k = geom.block_kvs
    return _analyze(counts, fields, dict(zip(names, mesh_shape)),
                    seconds=seconds, extra={
                        "arch": "luda-compaction",
                        "shape": f"{blocks_per_shard}bps",
                        "kind": "compaction",
                        "wire_bytes_global": geom.wire_words_per_block * 4
                        * b,
                        "entries_global": b * k,
                        "model_flops": 0,
                        "device": dev.type,
                        "job_seconds": job_s,
                        "stats": stats._asdict(),
                    })


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def cell_name(arch, shape, multi_pod):
    mesh = "pod2" if multi_pod else "pod1"
    return f"{arch}--{shape}--{mesh}"


def run_and_save(arch, shape, multi_pod, out_dir=OUT_DIR,
                 skip_existing=False, *, device=None) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_name(arch, shape, multi_pod) + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    try:
        if arch == "luda-compaction":
            rec = run_compaction_cell(multi_pod, device=device)
        else:
            rec = run_lm_cell(arch, shape, multi_pod, device=device)
    except Exception as e:  # a failure here is a bug in the port
        rec = {"error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    rec["cell"] = cell_name(arch, shape, multi_pod)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None,
                   help="arch id or 'luda-compaction'")
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--compaction", action="store_true")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--out", default=OUT_DIR)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    jobs = []
    if args.all:
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                jobs.append((arch, shape))
        jobs.append(("luda-compaction", "paper"))
    elif args.compaction:
        jobs.append(("luda-compaction", "paper"))
    else:
        if not (args.arch and (args.shape or
                               args.arch == "luda-compaction")):
            p.error("give --arch and --shape, --compaction or --all")
        jobs.append((args.arch, args.shape or "paper"))

    t_start = time.time()
    for arch, shape in jobs:
        for mp in meshes:
            rec = run_and_save(arch, shape, mp, args.out,
                               args.skip_existing, device=device)
            status = ("SKIP: " + rec["skipped"]) if "skipped" in rec else \
                ("ERROR: " + rec["error"]) if "error" in rec else \
                ("ok %.0fs fits=%s dom=%s" % (
                    rec["compile_seconds"], rec["memory"]["fits"],
                    rec["roofline"]["dominant"]))
            print(f"[{time.time()-t_start:7.0f}s] "
                  f"{cell_name(arch, shape, mp):55s} {status}", flush=True)
            if "memory" in rec:
                print("    memory: args=%.2fGB temp=%.2fGB "
                      "peak=%.2fGB" % (
                          rec["memory"]["argument_bytes"] / 2**30,
                          rec["memory"]["temp_bytes"] / 2**30,
                          rec["memory"]["peak_estimate_bytes"] / 2**30),
                      flush=True)


if __name__ == "__main__":
    main()
