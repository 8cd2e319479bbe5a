"""Shared-prefix lengths of sorted keys on the card (``csrc/prefix.cu``).

The port's counterpart of ``repro.kernels.prefix``; the plain versions are
``ref.prefix_encode`` and ``ref.prefix_encode_wire``.  Both routes are one
launch of one C entry point, counted as ``prefix_encode``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(keys: torch.Tensor, restart_interval: int) -> None:
    _build.check_cuda(keys, "prefix_encode keys", torch.int32, 2)
    if keys.shape[0] % restart_interval:
        raise ValueError("prefix_encode: rows must fill restart intervals")


def prefix_encode(keys: torch.Tensor, *,
                  restart_interval: int = 16) -> torch.Tensor:
    """``keys``: contiguous int32 ``[n, lanes]`` CUDA tensor of sorted
    big-endian key lanes.  Returns int32 ``[n]``."""
    _check(keys, restart_interval)
    n, lanes = keys.shape
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    _build.launch("prefix_encode", keys.data_ptr(), n, lanes,
                  restart_interval, None, out.data_ptr(), None,
                  _build.stream_handle(out))
    return out


def prefix_encode_wire(keys: torch.Tensor, count: torch.Tensor, *,
                       restart_interval: int = 16
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's prefix step in one launch: ``keys`` as for
    :func:`prefix_encode`, ``count`` the survivors (an int64 scalar on the
    same card, read there: no host sync).  Returns ``(shared, wire)``:
    int32 ``[n]`` shared lengths, 0 from row ``count`` on, and the keys
    with their first ``shared`` bytes zeroed."""
    _check(keys, restart_interval)
    _build.check_cuda(count, "prefix_encode count", torch.int64, 0)
    if count.device != keys.device:
        raise ValueError("prefix_encode: count must be on the keys' device")
    n, lanes = keys.shape
    shared = torch.empty(n, dtype=torch.int32, device=keys.device)
    wire = torch.empty_like(keys)
    _build.launch("prefix_encode", keys.data_ptr(), n, lanes,
                  restart_interval, count.data_ptr(), shared.data_ptr(),
                  wire.data_ptr(), _build.stream_handle(shared))
    return shared, wire
