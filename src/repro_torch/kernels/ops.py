"""Public API over the port's kernels.

Dispatch goes by the device of the tensors: a CUDA tensor launches the
hand-written Hopper kernel (or the launch raises), a CPU tensor takes the
plain PyTorch version in ``ref``.  There is no other selection and no
fallback.  Each kernel counts its launches (:func:`launch_counts`), so a
run can show that its main path went through the kernels.

Words are uint32 bit patterns carried in ``int32`` tensors (see ``ref``);
the selective scan works on floats.

The wrappers that a traced path reaches are also operators of their own,
``torch.ops.repro_torch.<name>``: the selective scan and its gradient (the
LM steps) and the four kernels of a device-sort compaction
(``crc32_sections``, ``bitonic_sort``, ``prefix_encode_wire``,
``bloom_build``).  Such a wrapper calls its operator only for a fake or
``meta`` input, which takes the operator's fake kernel: the outputs' shapes
and dtypes, nothing computed (the dry run's shape-only route); and under a
dispatch mode, where a counter (``roofline.counts``, ``roofline.memory``,
``FlopCounterMode``) sees the kernel as one op with its operands and
results, as XLA's fusion-aware count sees a custom call.  Otherwise it
dispatches by device itself, as above: the dispatcher's way through an
operator costs tens of microseconds a call.  The scan's FLOP formulas
(``torch.utils.flop_counter``) count the products JAX's scan runs as a dot
(``repro/models/mamba.py:120``).
"""

from __future__ import annotations

import torch
import torch.utils.flop_counter as flop_counter
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.kernels import bitonic_sort as _bitonic
from repro_torch.kernels import bloom as _bloom
from repro_torch.kernels import crc32 as _crc32
from repro_torch.kernels import lookup as _lookup
from repro_torch.kernels import merge_path as _merge_path
from repro_torch.kernels import prefix as _prefix
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _scan

launch_counts = _build.launch_counts
reset_launch_counts = _build.reset_launch_counts
launch_marks = _build.launch_marks

# the dispatch keys a thread starts with (this module is imported outside
# any operator): the plain backward runs under them inside its operator
_THREAD_KEYS = (torch._C._dispatch_tls_local_include_set(),
                torch._C._dispatch_tls_local_exclude_set())


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device.  Fake and ``meta`` tensors never reach it: they take the
    operators' fake kernels."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _through_operator(t: torch.Tensor) -> bool:
    """True where a wrapper calls its operator: a fake or ``meta`` input,
    or any input under a dispatch mode (see the module's docstring)."""
    return (t.is_meta or isinstance(t, FakeTensor)
            or torch._C._len_torch_dispatch_stack() > 0)


def _operator(name: str, schema: str):
    """Register ``fn``, which dispatches by device, as the operator
    ``torch.ops.repro_torch.<name>`` too, and return a function that calls
    the operator where :func:`_through_operator` says so (of the first
    tensor) and ``fn`` itself otherwise.  Its ``register_fake`` is the
    operator's."""
    def register(fn):
        op = torch.library.custom_op(f"repro_torch::{name}", fn,
                                     mutates_args=(), schema=schema)

        def call(first, *rest):
            t = first[0] if isinstance(first, list) else first
            return (op if _through_operator(t) else fn)(first, *rest)
        call.register_fake = op.register_fake
        return call
    return register


def crc32_blocks(words: torch.Tensor) -> torch.Tensor:
    """int32 ``[n_blocks]`` CRC-32 of each row of ``words`` (int32
    ``[n_blocks, n_words]``); equal to ``binascii.crc32`` per row."""
    if _on_card(words):
        return _crc32.crc32_blocks(words)
    return ref.crc32_words(words)


def crc32_sections(sections) -> torch.Tensor:
    """int32 ``[n_blocks]`` CRC-32 of the concatenated per-block sections
    (each ``[n_blocks, w_i]``); equal to ``binascii.crc32`` per row."""
    return _crc32_sections(list(sections))


@_operator("crc32_sections", "(Tensor[] sections) -> Tensor")
def _crc32_sections(sections):
    if _on_card(sections[0]):
        return _crc32.crc32_blocks_sections(sections)
    return ref.crc32_words_sections(sections)


@_crc32_sections.register_fake
def _(sections):
    return sections[0].new_empty(sections[0].shape[:-1], dtype=torch.int32)


def bloom_build(keys: torch.Tensor, valid: torch.Tensor | None = None, *,
                n_words: int, n_probes: int) -> torch.Tensor:
    """int32 ``[groups, n_words]`` bitmaps of keys ``[groups, per, L]``;
    ``valid`` is a bool ``[groups, per]`` mask (None: every slot)."""
    if valid is None:
        valid = torch.ones(keys.shape[:-1], dtype=torch.bool,
                           device=keys.device)
    return _bloom_build(keys, valid, n_words, n_probes)


@_operator("bloom_build",
           "(Tensor keys, Tensor valid, int n_words, int n_probes) -> Tensor")
def _bloom_build(keys, valid, n_words, n_probes):
    if _on_card(keys):
        return _bloom.bloom_build(keys, valid, n_words=n_words,
                                  n_probes=n_probes)
    return ref.bloom_build(keys, n_words=n_words, n_probes=n_probes,
                           valid=valid)


@_bloom_build.register_fake
def _(keys, valid, n_words, n_probes):
    return keys.new_empty((keys.shape[0], n_words), dtype=torch.int32)


def bloom_query(filters: torch.Tensor, keys: torch.Tensor, *,
                n_probes: int) -> torch.Tensor:
    """bool ``[G, Q]``: keys ``[G, Q, L]`` probed against filters
    ``[G, W]`` (True = maybe present)."""
    if _on_card(keys):
        return _bloom.bloom_query(filters, keys, n_probes=n_probes)
    return ref.bloom_query(filters, keys, n_probes=n_probes)


def bloom_multi_probe(filters: torch.Tensor, keys: torch.Tensor, *,
                      n_probes: int) -> torch.Tensor:
    """bool ``[C]``: key row ``i`` of ``[C, L]`` probed against filter row
    ``i`` of ``[C, W]`` (the ``multi_get`` prune)."""
    if _on_card(keys):
        return _bloom.bloom_multi_probe(filters, keys, n_probes=n_probes)
    return ref.bloom_multi_probe(filters, keys, n_probes=n_probes)


def lookup_blocks(keys: torch.Tensor, meta: torch.Tensor, vals: torch.Tensor,
                  nvalid: torch.Tensor, queries: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(found [C], meta [C], value [C, Vw])`` of query row ``i`` in
    block ``i`` (the ``multi_get`` gather); contract as
    ``ref.lookup_blocks``."""
    if _on_card(keys):
        return _lookup.lookup_blocks(keys, meta, vals, nvalid, queries)
    return ref.lookup_blocks(keys, meta, vals, nvalid, queries)


def lookup_blocks_packed(keys: torch.Tensor, meta: torch.Tensor,
                         vals: torch.Tensor, nvalid: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """:func:`lookup_blocks` as one int32 ``[C, 2 + Vw]`` tensor: found (0
    or 1), the meta word, the value (what the read path copies back)."""
    if _on_card(keys):
        return _lookup.lookup_blocks_packed(keys, meta, vals, nvalid, queries)
    return ref.lookup_blocks_packed(keys, meta, vals, nvalid, queries)


def prefix_encode(keys: torch.Tensor, *,
                  restart_interval: int = 16) -> torch.Tensor:
    if _on_card(keys):
        return _prefix.prefix_encode(keys, restart_interval=restart_interval)
    return ref.prefix_encode(keys, restart_interval=restart_interval)


def prefix_encode_wire(keys: torch.Tensor, count: torch.Tensor, *,
                       restart_interval: int = 16
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's prefix step, one launch on the card: ``(shared, wire)``,
    ``shared`` 0 from row ``count`` (an int64 scalar tensor, the survivors)
    on and the keys' first ``shared`` bytes zeroed in ``wire``; equal to
    JAX's ``where(valid, prefix_encode(...), 0)`` then
    ``formats.zero_prefix_lanes``.  Keys ``[J, n, L]`` with int64 counts
    ``[J]`` are a batch of jobs, each encoded on its own (still one launch
    on the card; plain version ``ref.prefix_encode_wire_batched``)."""
    return _prefix_encode_wire(keys, count, restart_interval)


@_operator("prefix_encode_wire",
           "(Tensor keys, Tensor count, int restart_interval) "
           "-> (Tensor, Tensor)")
def _prefix_encode_wire(keys, count, restart_interval):
    if _on_card(keys):
        return _prefix.prefix_encode_wire(keys, count,
                                          restart_interval=restart_interval)
    if keys.dim() == 3:
        return ref.prefix_encode_wire_batched(
            keys, count, restart_interval=restart_interval)
    return ref.prefix_encode_wire(keys, count,
                                  restart_interval=restart_interval)


@_prefix_encode_wire.register_fake
def _(keys, count, restart_interval):
    return (keys.new_empty(keys.shape[:-1], dtype=torch.int32),
            torch.empty_like(keys))


def prefix_decode(shared: torch.Tensor, keys_raw: torch.Tensor, *,
                  restart_interval: int = 16) -> torch.Tensor:
    """Plain PyTorch on either device: JAX runs this as a ``lax.scan``
    with no Pallas kernel, so the port has none yet either."""
    return ref.prefix_decode(shared, keys_raw,
                             restart_interval=restart_interval)


def sort_tuples(rows: torch.Tensor, num_keys: int | None = None
                ) -> torch.Tensor:
    """Stable lexicographic sort (``sort_mode="xla"``; plain PyTorch, as
    the JAX package leaves it to XLA's sort)."""
    return ref.sort_tuples(rows, num_keys)


def bitonic_sort(rows: torch.Tensor) -> torch.Tensor:
    """Ascending lexicographic sort over all lanes (``sort_mode=
    "device"``).  On the card there is no row cap: the JAX package's
    2**17 (``ops.sort_tuples(device_sort_max=...)``) is a VMEM limit.
    Rows ``[J, n, L]`` are a batch of jobs, each sorted on its own, in
    the one job's launches on the card."""
    return _bitonic_sort(rows)


@_operator("bitonic_sort", "(Tensor rows) -> Tensor")
def _bitonic_sort(rows):
    if _on_card(rows):
        return _bitonic.bitonic_sort(rows)
    if rows.dim() == 3:
        return torch.stack([ref.sort_tuples(r) for r in rows]) \
            if rows.shape[0] else rows.clone()
    return ref.sort_tuples(rows)


@_bitonic_sort.register_fake
def _(rows):
    return torch.empty_like(rows)


def merge_runs(rows: torch.Tensor, run_lens=None, *,
               debug_check: bool = False) -> torch.Tensor:
    """Merge ``k`` sorted runs stored back to back in int32 ``[n, L]``
    rows; ``run_lens`` gives their lengths (None: one run).  With a
    unique index lane the result equals a stable sort of the rows.  Rows
    ``[J, n, L]`` are a batch of jobs with the same runs, each merged on
    its own, in the one job's launches on the card (plain version
    ``ref.merge_runs_batched``).  ``debug_check=True`` asserts the
    sorted-run precondition on the host first (a copy back and a wait),
    as ``CompactionExecutor(debug_check_runs=True)`` does for a job."""
    n = rows.shape[-2]
    run_lens = (n,) if run_lens is None else tuple(int(r) for r in run_lens)
    if debug_check:
        host = rows.cpu().numpy()
        for job in (host if host.ndim == 3 else [host]):
            _merge_path.assert_runs_sorted(job, run_lens)
    if _on_card(rows):
        return _merge_path.merge_runs(rows, run_lens)
    if rows.dim() == 3:
        return ref.merge_runs_batched(rows, run_lens)
    return ref.merge_runs(rows, run_lens)


@_operator("selective_scan",
           "(Tensor u, Tensor dt, Tensor b, Tensor c, Tensor a_log, "
           "Tensor d_skip, Tensor? h0) -> (Tensor, Tensor)")
def _scan_op(u, dt, b, c, a_log, d_skip, h0):
    if _on_card(u):
        return _scan.selective_scan(u, dt, b, c, a_log, d_skip, h0)
    y, h = ref.selective_scan(u, dt, b, c, a_log, d_skip, h0)
    return y, (h.clone() if h is h0 else h)   # an empty sequence


@_scan_op.register_fake
def _(u, dt, b, c, a_log, d_skip, h0):
    bsz, seq, di = u.shape
    f32 = torch.float32
    return (u.new_empty((bsz, seq, di), dtype=f32),
            u.new_empty((bsz, di, b.shape[-1]), dtype=f32))


@_operator("selective_scan_bwd",
           "(Tensor u, Tensor dt, Tensor b, Tensor c, Tensor a_log, "
           "Tensor d_skip, Tensor? h0, Tensor dy, Tensor? dh_last) -> "
           "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _scan_bwd_op(u, dt, b, c, a_log, d_skip, h0, dy, dh_last):
    """The scan's gradient, ``dh0`` empty when ``h0`` is None."""
    args = (u, dt, b, c, a_log, d_skip, h0, dy, dh_last)
    if _on_card(u):
        grads = _scan.selective_scan_bwd(*args)
    else:
        # the plain backward takes its gradient by autograd, whose keys
        # the dispatcher excludes inside an operator's kernel: it runs
        # under a thread's starting keys
        with torch._C._ForceDispatchKeyGuard(*_THREAD_KEYS):
            grads = ref.selective_scan_bwd(*args)
    *grads, dh0 = grads
    return (*grads, u.new_empty((0,), dtype=torch.float32)
            if dh0 is None else dh0)


@_scan_bwd_op.register_fake
def _(u, dt, b, c, a_log, d_skip, h0, dy, dh_last):
    bsz, seq, di = u.shape
    ds = b.shape[-1]
    f32 = torch.float32
    return (torch.empty_like(u), u.new_empty((bsz, seq, di), dtype=f32),
            u.new_empty((bsz, seq, ds), dtype=f32),
            u.new_empty((bsz, seq, ds), dtype=f32),
            u.new_empty((di, ds), dtype=f32), u.new_empty((di,), dtype=f32),
            u.new_empty((0,) if h0 is None else (bsz, di, ds), dtype=f32))


@flop_counter.register_flop_formula(torch.ops.repro_torch.selective_scan)
def _scan_flops(u_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """JAX's one dot of the scan (``repro/models/mamba.py:120``, ``y =
    einsum("bcis,bcs->bci", hs, C)``): 2 * B * S * d_inner * d_state."""
    bsz, seq, di = u_shape
    return 2 * bsz * seq * di * b_shape[-1]


@flop_counter.register_flop_formula(torch.ops.repro_torch.selective_scan_bwd)
def _scan_bwd_flops(u_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """That dot's gradient as JAX's compiled step counts it: one dot, C's
    (the states' gradient, an outer product of ``dy`` and ``C``, XLA runs
    as a multiply), as many FLOPs as the forward's."""
    bsz, seq, di = u_shape
    return 2 * bsz * seq * di * b_shape[-1]


class _SelectiveScan(torch.autograd.Function):
    """The scan with its gradient: the forward as :func:`selective_scan`
    without gradients, the backward ``selective_scan_bwd``'s (the kernel
    on the card, ``ref.selective_scan_bwd`` on the CPU)."""

    @staticmethod
    def forward(ctx, u, dt, b, c, a_log, d_skip, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, b, c, a_log, d_skip, h0)
        return _scan_op(u, dt, b, c, a_log, d_skip, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, dt, b, c, a_log, d_skip, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        du, ddt, db, dc, da_log, dd_skip, dh0 = _scan_bwd_op(
            u, dt, b, c, a_log, d_skip, h0, dy, dh_last)
        dh0 = None if h0 is None else dh0
        return (du, ddt.to(dt.dtype), db.to(b.dtype),
                dc.to(c.dtype), da_log.to(a_log.dtype),
                dd_skip.to(d_skip.dtype),
                None if dh0 is None else dh0.to(h0.dtype))


def selective_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 forward recurrence in fp32: ``(y [B, S, di],
    h_last [B, di, ds])``, ``y`` with the ``D * u`` skip added; ``h0`` is
    a carried state (None: zeros).  Contract as ``ref.selective_scan``.
    DTensors on a mesh are scanned shard by shard
    (:func:`_selective_scan_dtensor`).
    When an input requires a gradient (and gradients are on), the call is
    differentiable: its backward is ``selective_scan_bwd`` on the card,
    ``ref.selective_scan_bwd`` on the CPU; otherwise it is the forward
    alone and saves nothing.  Fake and ``meta`` inputs give the outputs'
    shapes and dtypes and compute nothing."""
    args = (u, dt, b, c, a_log, d_skip, h0)
    if isinstance(u, DTensor):
        return _selective_scan_dtensor(*args)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    return _scan_op(*args)


def _selective_scan_dtensor(u, dt, b, c, a_log, d_skip, h0=None):
    """The scan of DTensors on a ``("data", "model")``-style mesh: each
    rank scans its own batch rows (over the data axes) and ``d_inner``
    channels (over ``"model"``), with the kernel on the card and the plain
    version on the CPU -- the forward is local per channel.  ``B`` and
    ``C`` are replicated over ``"model"``, so their gradients, sums over
    ``d_inner``, are partial sums there (``Partial()``, reduced by the
    caller's redistribution); ``A_log``'s and ``D``'s gradients are
    partial over the data axes for the same reason.  An axis that does not
    divide its dim replicates.  Plain tensors count as replicated."""
    from repro_torch.distributed import annotate
    mesh = u.device_mesh
    on = annotate.plan(mesh, u.shape[0], u.shape[2])

    def pl(*dims, **kw):
        return annotate.local_placements(mesh, *on, *dims, **kw)

    seq = pl(0, 2)                       # u, dt, y: [B, S, di]
    bc = pl(0, None)                     # B, C: [B, S, ds]
    chan = pl(None, 0)                   # A_log [di, ds], D [di]
    state = pl(0, 1)                     # h0, h: [B, di, ds]
    spec = ((u, seq, seq), (dt, seq, seq),
            (b, bc, pl(0, None, partial_chan=True)),
            (c, bc, pl(0, None, partial_chan=True)),
            (a_log, chan, pl(None, 0, partial_batch=True)),
            (d_skip, chan, pl(None, 0, partial_batch=True)),
            (h0, state, state))
    local = [None if t is None else annotate.to_mesh(t, mesh).redistribute(
        mesh, fwd).to_local(grad_placements=grad) for t, fwd, grad in spec]
    y, h = selective_scan(*local)
    return (DTensor.from_local(y, mesh, seq, run_check=False),
            DTensor.from_local(h, mesh, state, run_check=False))
