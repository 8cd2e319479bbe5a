"""Mamba-1 selective scan on the card (``csrc/selective_scan.cu``): the
prefill path of ``models.mamba.mamba_forward``.

The port's counterpart of ``repro.kernels.selective_scan.selective_scan``;
the plain version is ``ref.selective_scan``.  The state stays in the
kernel's registers for the whole sequence, so unlike the JAX wrapper this
one does not chunk the sequence; a carried ``h0`` is still taken.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STATE = 16   # ds the kernel holds in registers (kMaxState)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def selective_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``u`` bf16 or fp32 ``[B, S, di]`` on the card; ``dt`` ``[B, S, di]``,
    ``b``/``c`` ``[B, S, ds]``, ``a_log`` ``[di, ds]``, ``d_skip`` ``[di]``
    and ``h0`` ``[B, di, ds]`` (or None) are taken in fp32, as the JAX
    wrapper casts them.  Returns fp32 ``(y [B, S, di], h_last [B, di, ds])``
    with ``D * u`` added to ``y``."""
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"selective_scan u: expected bfloat16 or float32, "
                        f"got {u.dtype}")
    u = u.contiguous()
    _build.check_cuda(u, "selective_scan u", u.dtype, 3)
    bsz, seq, di = u.shape
    ds = b.shape[-1]
    if not 0 < ds <= MAX_STATE:
        raise ValueError(f"selective_scan: the kernel holds 1..{MAX_STATE} "
                         f"states a channel, got ds={ds}")
    dt, b, c, a_log, d_skip = map(_f32, (dt, b, c, a_log, d_skip))
    want = {"dt": (dt, (bsz, seq, di)), "b": (b, (bsz, seq, ds)),
            "c": (c, (bsz, seq, ds)), "a_log": (a_log, (di, ds)),
            "d_skip": (d_skip, (di,))}
    if h0 is not None:
        h0 = _f32(h0)
        want["h0"] = (h0, (bsz, di, ds))
    for name, (t, shape) in want.items():
        _build.check_cuda(t, f"selective_scan {name}", torch.float32,
                          len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan {name}: expected shape "
                             f"{shape}, got {tuple(t.shape)}")
    y = torch.empty((bsz, seq, di), dtype=torch.float32, device=u.device)
    h_last = torch.empty((bsz, di, ds), dtype=torch.float32, device=u.device)
    _build.launch("selective_scan", u.data_ptr(),
                  int(u.dtype == torch.bfloat16), dt.data_ptr(),
                  b.data_ptr(), c.data_ptr(), a_log.data_ptr(),
                  d_skip.data_ptr(), None if h0 is None else h0.data_ptr(),
                  y.data_ptr(), h_last.data_ptr(), bsz, seq, di, ds,
                  _build.stream_handle(y))
    return y, h_last
