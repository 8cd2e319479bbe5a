"""Mamba-1 selective scan on the card (``csrc/selective_scan.cu``): the
prefill path of ``models.mamba.mamba_forward``; and its gradient
(``csrc/selective_scan_bwd.cu``), the training path's.

The port's counterpart of ``repro.kernels.selective_scan.selective_scan``;
the plain version is ``ref.selective_scan``.  The state stays in the
kernel's registers for the whole sequence, so unlike the JAX wrapper this
one does not chunk the sequence; a carried ``h0`` is still taken.  The
backward (:func:`selective_scan_bwd`, plain version
``ref.selective_scan_bwd``) has no TPU counterpart: JAX trains through an
``associative_scan``.  It cuts the sequence into segments that run in
parallel (:func:`bwd_plan` picks their length from the shape alone, so the
summation order, and with it every bit of the result, depends on nothing
else).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

MAX_STATE = 16   # ds the kernel holds in registers (kMaxState)
BWD_CHUNK = 8    # steps a chunk of the backward: its history in shared
#                  memory, and the spacing of the sweep's stored states
BWD_CHANNELS = 64       # channels a block of the backward's walk
BWD_SWEEP_CHANNELS = 64  # channels a block of its forward sweep
BWD_BLOCKS = 512    # walk blocks the plan adds segments to reach


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How :func:`selective_scan_bwd` cuts a ``[B, S, di]`` problem: segments
    of ``seg_len`` steps (a multiple of ``chunk``), ``n_seg`` of them, the
    last ragged; the walk's grid ``(channel_blocks, n_seg, B)`` and the
    sweep's ``(sweep_blocks, n_seg, B)``; and the fp32 scratch shapes, by
    name, in the order the C entry point takes them (an empty shape where
    one segment needs no carry)."""
    chunk: int
    seg_len: int
    n_seg: int
    n_chunks: int
    channel_blocks: int
    sweep_blocks: int
    scratch: dict

    @property
    def walk_grid(self) -> tuple:
        return (self.channel_blocks, self.n_seg,
                self.scratch["da_part"][0])

    @property
    def sweep_grid(self) -> tuple:
        return (self.sweep_blocks, self.n_seg, self.scratch["da_part"][0])


def bwd_plan(bsz: int, seq: int, di: int, ds: int) -> BwdPlan:
    """The backward's plan from the shape alone: one segment when ``B *
    ceil(di / BWD_CHANNELS)`` walk blocks reach ``BWD_BLOCKS``, else as
    many more as reach it (at most one a chunk), of equal length in whole
    chunks.  Scratch: the sweep's chunk-start states ``hck`` and, past the
    first segment, their transfers from the segment's start ``qck`` ([B,
    chunks, di, 16]); the segments' transfers, end states and adjoints
    ``summ`` [B, n_seg, 3, di, 16] and the carried start states and
    adjoints ``carry`` [B, n_seg, 2, di, 16] (both empty for one segment);
    the blocks' dB / dC ``part`` [channel blocks, B, S, 2, ds]; dA and dD
    by batch row and segment, ``da_part`` [B, n_seg, di, ds] and
    ``dd_part`` [B, n_seg, di]."""
    chunk = BWD_CHUNK
    n_chunks = -(-seq // chunk)
    channel_blocks = -(-di // BWD_CHANNELS)
    want = -(-BWD_BLOCKS // max(bsz * channel_blocks, 1))
    n_seg = max(1, min(want, n_chunks))
    seg_len = max(-(-n_chunks // n_seg), 1) * chunk
    n_seg = max(1, -(-seq // seg_len))
    many = n_seg > 1
    st = (bsz, n_chunks, di, MAX_STATE)
    scratch = {"hck": st, "qck": st if many else (0,),
               "summ": (bsz, n_seg, 3, di, MAX_STATE) if many else (0,),
               "carry": (bsz, n_seg, 2, di, MAX_STATE) if many else (0,),
               "part": (channel_blocks, bsz, seq, 2, ds),
               "da_part": (bsz, n_seg, di, ds), "dd_part": (bsz, n_seg, di)}
    return BwdPlan(chunk=chunk, seg_len=seg_len, n_seg=n_seg,
                   n_chunks=n_chunks, channel_blocks=channel_blocks,
                   sweep_blocks=-(-di // BWD_SWEEP_CHANNELS),
                   scratch=scratch)


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
    when ``h0`` is None.  One call (one counted launch), four kernels
    (:func:`bwd_plan`'s segments swept forward, their carry, the walks
    back, then the ordered sums over channel blocks, batch rows and
    segments); no float atomics, so a rerun gives the same bits."""
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
    plan = bwd_plan(bsz, seq, di, ds)
    scratch = [f32(*shape) for shape in plan.scratch.values()]
    _build.launch("selective_scan_bwd", u.data_ptr(),
                  int(u.dtype == torch.bfloat16), t["dt"].data_ptr(),
                  t["b"].data_ptr(), t["c"].data_ptr(), t["a_log"].data_ptr(),
                  t["d_skip"].data_ptr(), _ptr(t["h0"]), t["dy"].data_ptr(),
                  _ptr(t["dh_last"]), du.data_ptr(), ddt.data_ptr(),
                  db.data_ptr(), dc.data_ptr(), da_log.data_ptr(),
                  dd_skip.data_ptr(), _ptr(dh0),
                  *(x.data_ptr() for x in scratch),
                  bsz, seq, di, ds, plan.seg_len, _build.stream_handle(du))
    return du, ddt, db, dc, da_log, dd_skip, dh0
