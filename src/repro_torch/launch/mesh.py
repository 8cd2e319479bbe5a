"""Mesh construction (the JAX package's ``repro.launch.mesh``), as
``torch.distributed`` ``DeviceMesh``es over the ranks of the current world.

The caller starts the world (``torch.distributed.init_process_group``, or a
launcher such as ``torchrun``); a mesh takes every rank of it.  The device
type is ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """JAX's production shape and axis names: a 16x16 pod (256 chips), or
    2x16x16 across two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def host_mesh_shape(world: int, model_axis: int | None = None
                    ) -> tuple[int, int]:
    """JAX's rule: the model axis is 2 when the world is even and above 1,
    else 1; the data axis takes the rest."""
    m = model_axis or (2 if world % 2 == 0 and world > 1 else 1)
    return world // m, m


def build_mesh(shape: tuple[int, ...], names: tuple[str, ...], device=None):
    """A mesh of ``shape`` and axis ``names`` over every rank of the
    world; raises ``ValueError`` with both sizes when they differ."""
    dev = resolve_device(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} ({math.prod(shape)} "
                         f"ranks) over a world of {world} ranks")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh, built only in a world of its size (256 or 512
    ranks); raises ``ValueError`` with both sizes otherwise."""
    return build_mesh(*production_mesh_shape(multi_pod=multi_pod), device)


def make_host_mesh(model_axis: int | None = None, *, device=None):
    """A ``("data", "model")`` mesh over every rank of the world; the
    device is resolved before the world is read, so without a card it
    refuses as every other entry point does."""
    dev = resolve_device(device)
    return build_mesh(host_mesh_shape(dist.get_world_size(), model_axis),
                      ("data", "model"), dev)


@contextlib.contextmanager
def fake_world(world: int):
    """A world of ``world`` ranks in this process alone, as its rank 0, for
    the ``with`` block: torch's fake backend, whose collectives return at
    once and move nothing (the dry run's world: what one rank of a
    production mesh runs, with no other rank).  Any world already started
    is an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
