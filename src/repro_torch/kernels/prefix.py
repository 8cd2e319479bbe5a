"""Shared-prefix lengths of sorted keys on the card (``csrc/prefix.cu``).

The port's counterpart of ``repro.kernels.prefix``; the plain version is
``ref.prefix_encode``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def prefix_encode(keys: torch.Tensor, *,
                  restart_interval: int = 16) -> torch.Tensor:
    """``keys``: contiguous int32 ``[n, lanes]`` CUDA tensor of sorted
    big-endian key lanes.  Returns int32 ``[n]``."""
    _build.check_cuda(keys, "prefix_encode keys", torch.int32, 2)
    n, lanes = keys.shape
    if n % restart_interval:
        raise ValueError("prefix_encode: rows must fill restart intervals")
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    _build.launch("prefix_encode", keys.data_ptr(), n, lanes,
                  restart_interval, out.data_ptr(),
                  _build.stream_handle(out))
    return out
