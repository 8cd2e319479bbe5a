"""Batched point lookup on the card (``csrc/lookup.cu``): the ``multi_get``
gather.

The port's counterpart of ``repro.kernels.lookup.lookup_blocks``; the
plain version is ``ref.lookup_blocks``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def lookup_blocks(keys: torch.Tensor, meta: torch.Tensor, vals: torch.Tensor,
                  nvalid: torch.Tensor, queries: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query row ``i`` searched in block ``i``.  int32 CUDA tensors:
    ``keys [C, K, L]`` (sorted, all-ones at and after ``nvalid``),
    ``meta [C, K]``, ``vals [C, K, Vw]``, ``nvalid [C]``, ``queries
    [C, L]``.  Returns ``(found bool [C], meta int32 [C], value int32
    [C, Vw])``, zeroed where not found."""
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
    found = torch.empty(c, dtype=torch.bool, device=keys.device)
    meta_out = torch.empty(c, dtype=torch.int32, device=keys.device)
    vals_out = torch.empty((c, vw), dtype=torch.int32, device=keys.device)
    _build.launch("lookup_blocks", keys.data_ptr(), meta.data_ptr(),
                  vals.data_ptr(), nvalid.data_ptr(), queries.data_ptr(), c,
                  k, lanes, vw, found.data_ptr(), meta_out.data_ptr(),
                  vals_out.data_ptr(), _build.stream_handle(found))
    return found, meta_out, vals_out
