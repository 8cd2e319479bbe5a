"""GPipe-style pipeline parallelism over a "pipe" mesh axis (the JAX
package's ``repro.distributed.pipeline``).

Optional feature (the production meshes are DP x TP); provided for meshes
that add a ``pipe`` axis at larger scale.  Each rank of the axis is one
stage; stages pass activations on a ring of ``batch_isend_irecv`` (JAX's
``ppermute``), and microbatches fill/drain the pipeline with the standard
(S + M - 1)-tick schedule.

The model is one stage function applied to stage-stacked parameters
(leading axis = stage).  Correctness contract: pipeline(stages,
microbatches) == the sequential layer stack on the same params
(``sequential_reference``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.convert import tree_leaves, tree_map


def _shift(y: torch.Tensor, group, idx: int, n: int) -> torch.Tensor:
    """Stage ``idx`` sends ``y`` to stage ``idx + 1`` and receives stage
    ``idx - 1``'s (a ring, as JAX's ``ppermute``)."""
    if n == 1:
        return y
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(),
                      dist.get_global_rank(group, (idx + 1) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (idx - 1) % n), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def pipeline_apply(stage_params, x: torch.Tensor, stage_fn, mesh, *,
                   axis: str = "pipe", microbatches: int | None = None):
    """Run ``stage_fn(params_s, x) -> x`` over ``n_stages`` = the size of
    ``axis`` of ``mesh``.

    ``stage_params``: a tree with a leading stage axis on every leaf
    (whole tensors, or DTensors sharded on it over ``axis``); ``x``:
    ``[B, ...]`` the global batch, the same on every rank (B divisible by
    the microbatches; only stage 0 consumes it).  Returns the last stage's
    output on every rank.  A collective: every rank of the axis calls it.
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    idx = mesh.get_local_rank(axis)
    m = microbatches or n_stages
    b = x.shape[0]
    assert b % m == 0, (b, m)
    mb = b // m

    def my_stage(a):   # this stage's slice of the stage axis
        if isinstance(a, DTensor):
            pl = [Shard(0) if n == axis else Replicate()
                  for n in a.device_mesh.mesh_dim_names]
            return a.redistribute(a.device_mesh, pl).to_local()[0]
        return a[idx]

    params = tree_map(my_stage, stage_params)
    xs = x.reshape(m, mb, *x.shape[1:])
    buf = torch.zeros_like(xs[0])          # activation entering my stage
    outs = torch.zeros_like(xs)
    for t in range(m + n_stages - 1):
        if idx == 0 and t < m:             # stage 0 ingests microbatch t
            buf = xs[t]
        y = stage_fn(params, buf)
        emit_t = t - (n_stages - 1)        # the last stage emits
        if idx == n_stages - 1 and emit_t >= 0:
            outs[emit_t] = y
        buf = _shift(y, group, idx, n_stages)   # down the pipe
    # replicate the result from the last stage to all stages
    gathered = [torch.empty_like(outs) for _ in range(n_stages)]
    dist.all_gather(gathered, outs, group=group)
    return gathered[n_stages - 1].reshape(b, *x.shape[1:])


def sequential_reference(stage_params, x: torch.Tensor, stage_fn):
    """Oracle: apply the stages in order on one device."""
    n = tree_leaves(stage_params)[0].shape[0]
    for i in range(n):
        x = stage_fn(tree_map(lambda a, i=i: a[i], stage_params), x)
    return x
