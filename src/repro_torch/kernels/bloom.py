"""Bloom filter construction on the card (``csrc/bloom.cu``).

The port's counterpart of ``repro.kernels.bloom.bloom_build``; the plain
version is ``ref.bloom_build``.  Query and multi-probe are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def bloom_build(keys: torch.Tensor, valid: torch.Tensor, *, n_words: int,
                n_probes: int) -> torch.Tensor:
    """``keys``: int32 ``[groups, per_group, lanes]``; ``valid``: bool
    ``[groups, per_group]``.  Returns int32 ``[groups, n_words]``."""
    _build.check_cuda(keys, "bloom_build keys", torch.int32, 3)
    _build.check_cuda(valid, "bloom_build valid", torch.bool, 2)
    g, per, lanes = keys.shape
    if tuple(valid.shape) != (g, per) or valid.device != keys.device:
        raise ValueError("bloom_build: valid must be [groups, per_group] "
                         "on the keys' device")
    out = torch.empty((g, n_words), dtype=torch.int32, device=keys.device)
    _build.launch("bloom_build", keys.data_ptr(), valid.data_ptr(), g, per,
                  lanes, n_words, n_probes, out.data_ptr(),
                  _build.stream_handle(out))
    return out
