"""Bloom filter build and probes on the card (``csrc/bloom.cu``).

The port's counterparts of ``repro.kernels.bloom`` ``bloom_build``,
``multi_probe`` and ``bloom_query``; the plain versions are
``ref.bloom_build``, ``ref.bloom_multi_probe`` and ``ref.bloom_query``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


#: Filter words a sub-warp holds in registers (``kShortWords`` in
#: ``csrc/bloom.cu``); longer rows take one block a group.
SHORT_WORDS = 32


def build_lanes(per_group: int, n_words: int) -> int:
    """The build's route, chosen by shape: the lanes of the sub-warp that
    builds one group's filter (the power of two >= min(per_group, 32)) for
    a row of up to ``SHORT_WORDS`` words, or 0 for one block a group with
    the bitmap in shared memory (an SST's 5,120 words)."""
    if n_words > SHORT_WORDS:
        return 0
    return 1 << (min(per_group, 32) - 1).bit_length()


def bloom_build(keys: torch.Tensor, valid: torch.Tensor, *, n_words: int,
                n_probes: int) -> torch.Tensor:
    """``keys``: int32 ``[groups, per_group, lanes]``; ``valid``: bool
    ``[groups, per_group]``.  Returns int32 ``[groups, n_words]``; one
    launch by the route of :func:`build_lanes`."""
    _build.check_cuda(keys, "bloom_build keys", torch.int32, 3)
    _build.check_cuda(valid, "bloom_build valid", torch.bool, 2)
    g, per, lanes = keys.shape
    if tuple(valid.shape) != (g, per) or valid.device != keys.device:
        raise ValueError("bloom_build: valid must be [groups, per_group] "
                         "on the keys' device")
    out = torch.empty((g, n_words), dtype=torch.int32, device=keys.device)
    _build.launch("bloom_build", keys.data_ptr(), valid.data_ptr(), g, per,
                  lanes, n_words, n_probes, build_lanes(per, n_words),
                  out.data_ptr(), _build.stream_handle(out))
    return out


def bloom_multi_probe(filters: torch.Tensor, keys: torch.Tensor, *,
                      n_probes: int) -> torch.Tensor:
    """Key row ``i`` of int32 ``[C, lanes]`` against filter row ``i`` of
    int32 ``[C, W]``.  Returns bool ``[C]`` (True = maybe present)."""
    _build.check_cuda(filters, "bloom_multi_probe filters", torch.int32, 2)
    _build.check_cuda(keys, "bloom_multi_probe keys", torch.int32, 2)
    c, lanes = keys.shape
    if filters.shape[0] != c or filters.device != keys.device:
        raise ValueError("bloom_multi_probe: one filter row per key row, "
                         "on the keys' device")
    out = torch.empty(c, dtype=torch.bool, device=keys.device)
    _build.launch("bloom_multi_probe", filters.data_ptr(), keys.data_ptr(),
                  c, lanes, filters.shape[1], n_probes, out.data_ptr(),
                  _build.stream_handle(out))
    return out


def bloom_query(filters: torch.Tensor, keys: torch.Tensor, *,
                n_probes: int) -> torch.Tensor:
    """Each of the Q keys of group ``g`` (int32 ``[G, Q, lanes]``) against
    filter ``g`` (int32 ``[G, W]``).  Returns bool ``[G, Q]``."""
    _build.check_cuda(filters, "bloom_query filters", torch.int32, 2)
    _build.check_cuda(keys, "bloom_query keys", torch.int32, 3)
    g, q, lanes = keys.shape
    if filters.shape[0] != g or filters.device != keys.device:
        raise ValueError("bloom_query: one filter row per group, on the "
                         "keys' device")
    out = torch.empty((g, q), dtype=torch.bool, device=keys.device)
    _build.launch("bloom_query", filters.data_ptr(), keys.data_ptr(), g, q,
                  lanes, filters.shape[1], n_probes, out.data_ptr(),
                  _build.stream_handle(out))
    return out


#: JAX's name for :func:`bloom_multi_probe` (``repro.kernels.bloom.
#: multi_probe``; its ``cand_tile`` and ``interpret`` belong to the Pallas
#: kernel and have no counterpart here)
multi_probe = bloom_multi_probe
