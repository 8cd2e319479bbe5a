"""Mamba-1 selective scan on the card (``csrc/selective_scan.cu``): the
prefill path of ``models.mamba.mamba_forward``; and its gradient
(``csrc/selective_scan_bwd.cu``), the training path's.

The port's counterpart of ``repro.kernels.selective_scan.selective_scan``;
the plain version is ``ref.selective_scan``.  The state stays in the
kernel's registers for the whole sequence, so unlike the JAX wrapper this
one does not chunk the sequence; a carried ``h0`` is still taken.  The
backward (:func:`selective_scan_bwd`, plain version
``ref.selective_scan_bwd``) has no TPU counterpart: JAX trains through an
``associative_scan``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STATE = 16   # ds the kernel holds in registers (kMaxState)
BWD_CHUNK = 16   # steps between the backward's stored states (kChunk)
BWD_CHANNELS = 32   # channels a block of the backward (kChannels)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _check_scan_inputs(what: str, u: torch.Tensor, dt, b, c, a_log, d_skip,
                       h0=None, dy=None, dh_last=None) -> tuple:
    """Check the scan's inputs as the C entry points take them: ``u`` bf16
    or fp32 ``[B, S, di]``, the others (None allowed for ``h0``, ``dy``
    and ``dh_last``) converted to contiguous fp32.  Returns ``(u, {name:
    tensor or None})``."""
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} u: expected bfloat16 or float32, "
                        f"got {u.dtype}")
    u = u.contiguous()
    _build.check_cuda(u, f"{what} u", u.dtype, 3)
    bsz, seq, di = u.shape
    ds = b.shape[-1]
    if not 0 < ds <= MAX_STATE:
        raise ValueError(f"{what}: the kernel holds 1..{MAX_STATE} "
                         f"states a channel, got ds={ds}")
    steps, states = (bsz, seq, di), (bsz, di, ds)
    want = {"dt": (dt, steps), "b": (b, (bsz, seq, ds)),
            "c": (c, (bsz, seq, ds)), "a_log": (a_log, (di, ds)),
            "d_skip": (d_skip, (di,)), "h0": (h0, states), "dy": (dy, steps),
            "dh_last": (dh_last, states)}
    out = {}
    for name, (t, shape) in want.items():
        if t is not None:
            t = _f32(t)
            _build.check_cuda(t, f"{what} {name}", torch.float32, len(shape))
            if tuple(t.shape) != shape:
                raise ValueError(f"{what} {name}: expected shape "
                                 f"{shape}, got {tuple(t.shape)}")
        out[name] = t
    return u, out


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def selective_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``u`` bf16 or fp32 ``[B, S, di]`` on the card; ``dt`` ``[B, S, di]``,
    ``b``/``c`` ``[B, S, ds]``, ``a_log`` ``[di, ds]``, ``d_skip`` ``[di]``
    and ``h0`` ``[B, di, ds]`` (or None) are taken in fp32, as the JAX
    wrapper casts them.  Returns fp32 ``(y [B, S, di], h_last [B, di, ds])``
    with ``D * u`` added to ``y``."""
    u, t = _check_scan_inputs("selective_scan", u, dt, b, c, a_log, d_skip,
                              h0=h0)
    bsz, seq, di = u.shape
    ds = b.shape[-1]
    y = torch.empty((bsz, seq, di), dtype=torch.float32, device=u.device)
    h_last = torch.empty((bsz, di, ds), dtype=torch.float32, device=u.device)
    _build.launch("selective_scan", u.data_ptr(),
                  int(u.dtype == torch.bfloat16), t["dt"].data_ptr(),
                  t["b"].data_ptr(), t["c"].data_ptr(), t["a_log"].data_ptr(),
                  t["d_skip"].data_ptr(), _ptr(t["h0"]), y.data_ptr(),
                  h_last.data_ptr(), bsz, seq, di, ds,
                  _build.stream_handle(y))
    return y, h_last


def selective_scan_bwd(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a_log: torch.Tensor,
                       d_skip: torch.Tensor, h0: torch.Tensor | None,
                       dy: torch.Tensor, dh_last: torch.Tensor | None = None
                       ) -> tuple:
    """The gradient of :func:`selective_scan` on the card: given the
    forward's inputs (as :func:`selective_scan` takes them), ``dy`` ``[B,
    S, di]`` and ``dh_last`` ``[B, di, ds]`` (or None: zeros), returns
    ``(du, ddt, db, dc, da_log, dd_skip, dh0)``: ``du`` in ``u``'s dtype
    (the kernel rounds its fp32 sum once), the rest fp32, ``dh0`` None
    when ``h0`` is None.  One call, two kernels (the scan, then the ordered sums over
    channel blocks and batch rows); no float atomics, so a rerun gives the
    same bits."""
    u, t = _check_scan_inputs("selective_scan_bwd", u, dt, b, c, a_log,
                              d_skip, h0=h0, dy=dy, dh_last=dh_last)
    bsz, seq, di = u.shape
    ds = b.shape[-1]

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=u.device)

    du = torch.empty((bsz, seq, di), dtype=u.dtype, device=u.device)
    ddt, db, dc = f32(bsz, seq, di), f32(bsz, seq, ds), f32(bsz, seq, ds)
    da_log, dd_skip = f32(di, ds), f32(di)
    dh0 = None if h0 is None else f32(bsz, di, ds)
    hck = f32(bsz, -(-seq // BWD_CHUNK), di, MAX_STATE)
    part = f32(-(-di // BWD_CHANNELS), bsz, seq, 2, ds)
    da_part, dd_part = f32(bsz, di, ds), f32(bsz, di)
    _build.launch("selective_scan_bwd", u.data_ptr(),
                  int(u.dtype == torch.bfloat16), t["dt"].data_ptr(),
                  t["b"].data_ptr(), t["c"].data_ptr(), t["a_log"].data_ptr(),
                  t["d_skip"].data_ptr(), _ptr(t["h0"]), t["dy"].data_ptr(),
                  _ptr(t["dh_last"]), du.data_ptr(), ddt.data_ptr(),
                  db.data_ptr(), dc.data_ptr(), da_log.data_ptr(),
                  dd_skip.data_ptr(), _ptr(dh0), hck.data_ptr(),
                  part.data_ptr(), da_part.data_ptr(), dd_part.data_ptr(),
                  bsz, seq, di, ds, _build.stream_handle(du))
    return du, ddt, db, dc, da_log, dd_skip, dh0
