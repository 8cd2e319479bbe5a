"""Batched point lookup on the card (``csrc/lookup.cu``): the ``multi_get``
gather.

The port's counterpart of ``repro.kernels.lookup.lookup_blocks``; the
plain versions are ``ref.lookup_blocks`` and ``ref.lookup_blocks_packed``.
The kernel writes the packed form, which the read path copies back in one
transfer.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def lookup_blocks_packed(keys: torch.Tensor, meta: torch.Tensor,
                         vals: torch.Tensor, nvalid: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """Query row ``i`` searched in block ``i``, in one launch.  int32 CUDA
    tensors: ``keys [C, K, L]`` (sorted, all-ones at and after ``nvalid``),
    ``meta [C, K]``, ``vals [C, K, Vw]``, ``nvalid [C]``, ``queries
    [C, L]``.  Returns int32 ``[C, 2 + Vw]``: found (0 or 1), the meta
    word, the value; zeroed where not found."""
    _build.check_cuda(keys, "lookup_blocks keys", torch.int32, 3)
    _build.check_cuda(meta, "lookup_blocks meta", torch.int32, 2)
    _build.check_cuda(vals, "lookup_blocks vals", torch.int32, 3)
    _build.check_cuda(nvalid, "lookup_blocks nvalid", torch.int32, 1)
    _build.check_cuda(queries, "lookup_blocks queries", torch.int32, 2)
    c, k, lanes = keys.shape
    vw = vals.shape[2]
    if k == 0 or tuple(meta.shape) != (c, k) or vals.shape[:2] != (c, k) \
            or tuple(nvalid.shape) != (c,) or \
            tuple(queries.shape) != (c, lanes):
        raise ValueError("lookup_blocks: shapes must be keys [C, K>0, L], "
                         "meta [C, K], vals [C, K, Vw], nvalid [C], "
                         "queries [C, L]")
    if len({t.device for t in (keys, meta, vals, nvalid, queries)}) != 1:
        raise ValueError("lookup_blocks: inputs on different devices")
    out = torch.empty((c, 2 + vw), dtype=torch.int32, device=keys.device)
    _build.launch("lookup_blocks", keys.data_ptr(), meta.data_ptr(),
                  vals.data_ptr(), nvalid.data_ptr(), queries.data_ptr(), c,
                  k, lanes, vw, out.data_ptr(), _build.stream_handle(out))
    return out


def lookup_blocks(keys: torch.Tensor, meta: torch.Tensor, vals: torch.Tensor,
                  nvalid: torch.Tensor, queries: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`lookup_blocks_packed` split into ``(found bool [C], meta
    int32 [C], value int32 [C, Vw])`` (the last two are views of the
    packed output)."""
    out = lookup_blocks_packed(keys, meta, vals, nvalid, queries)
    return out[:, 0] != 0, out[:, 1], out[:, 2:]
