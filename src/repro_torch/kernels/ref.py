"""Plain PyTorch versions of the port's kernels (compaction, read and
model paths).

These are the port's counterparts of ``repro.kernels.ref``: the CPU tests
hold them bit for bit against the JAX functions, the kernel wrappers use
them for tensors that lie on the CPU, and ``chip_smoke.py`` holds every
CUDA kernel against them on the card.

Word representation.  An image stores uint32 words as their bit patterns
in ``int32`` tensors (a ``view`` of the numpy ``uint32`` array): torch's
``uint32`` lacks ``>>``, ``<<``, ``+``, ``<`` and ``%``.  The functions
below widen words to ``int64`` holding the unsigned value
(:func:`u32`), do their arithmetic there, mask back to 32 bits after each
``+``, ``*`` and ``<<``, and return ``int32`` bit patterns
(:func:`as_i32`).  Unsigned order is the order of the widened values.
The selective scan (:func:`selective_scan`, and its gradient
:func:`selective_scan_bwd`) works on floats and is held
against the JAX oracle within a stated tolerance instead.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import tables

MASK32 = 0xFFFFFFFF
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619


def u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of the unsigned values of 32-bit words."""
    return x.to(torch.int64) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of int64 values (low 32 bits kept)."""
    return (x & MASK32).to(torch.int32)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``c`` < 2**32, split in 16-bit halves so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


# ---------------------------------------------------------------------------
# CRC-32 (GF(2)-affine form, see tables.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _table(n_words: int, device: str) -> torch.Tensor:
    t = tables.crc32_operator_table(n_words).astype("int64")
    return torch.from_numpy(t).to(device)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis by halving folds."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def _crc_contrib(words: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """XOR of the operator words of every set bit; int64 ``[...]``."""
    w = u32(words)
    acc = torch.zeros_like(w)
    for j in range(32):
        acc ^= ((w >> j) & 1) * T[:, j]
    return _xor_reduce(acc)


def crc32_words(words: torch.Tensor) -> torch.Tensor:
    """CRC-32 of each row of ``words`` (``[..., n_words]``, the message
    bytes being the little-endian serialization of the row): int32 bit
    patterns equal to ``binascii.crc32(row.tobytes())``."""
    n_words = words.shape[-1]
    T = _table(n_words, str(words.device))
    base = tables.crc32_zero_message(n_words * 4)
    return as_i32(_crc_contrib(words, T) ^ base)


def crc32_words_sections(sections) -> torch.Tensor:
    """CRC-32 of the logical concatenation of ``sections`` (each
    ``[..., w_i]``) without building it."""
    total = sum(s.shape[-1] for s in sections)
    T = _table(total, str(sections[0].device))
    acc = torch.full(sections[0].shape[:-1], tables.crc32_zero_message(
        total * 4), dtype=torch.int64, device=sections[0].device)
    off = 0
    for s in sections:
        w = s.shape[-1]
        acc = acc ^ _crc_contrib(s, T[off:off + w])
        off += w
    return as_i32(acc)


# ---------------------------------------------------------------------------
# Bloom filter (double hashing over FNV + murmur fmix32)
# ---------------------------------------------------------------------------


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bloom_hashes(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two 32-bit hashes per key (int64 values). ``keys``: ``[..., L]``."""
    k = u32(keys)
    h1 = torch.full(k.shape[:-1], _FNV_OFFSET, dtype=torch.int64,
                    device=k.device)
    h2 = torch.full_like(h1, _FNV_OFFSET ^ 0xDEADBEEF)
    for lane in range(k.shape[-1]):
        h1 = ((h1 ^ k[..., lane]) * _FNV_PRIME) & MASK32
        h2 = ((h2 ^ 0x9E3779B9 ^ k[..., lane]) * _FNV_PRIME) & MASK32
    return _mix32(h1), _mix32(h2) | 1


def bloom_build(keys: torch.Tensor, *, n_words: int, n_probes: int,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """One bitmap per group: ``keys`` ``[G, K, L]``, ``valid`` bool
    ``[G, K]`` -> int32 ``[G, n_words]`` (m = 32 * n_words bits)."""
    g = keys.shape[0]
    m = n_words * 32
    h1, h2 = bloom_hashes(keys)
    # one spare column takes the probes of invalid slots
    bits = torch.zeros((g, m + 1), dtype=torch.bool, device=keys.device)
    for i in range(n_probes):
        pos = ((h1 + i * h2) & MASK32) % m
        if valid is not None:
            pos = torch.where(valid, pos, m)
        bits.scatter_(1, pos, True)
    bits = bits[:, :m].reshape(g, n_words, 32).to(torch.int64)
    shifts = torch.arange(32, device=keys.device)
    return as_i32((bits << shifts).sum(-1))


def bloom_query(filters: torch.Tensor, keys: torch.Tensor, *,
                n_probes: int) -> torch.Tensor:
    """Membership probe of ``keys`` ``[G, Q, L]`` against the filters
    ``[G, W]`` (m = 32 * W bits, any W): bool ``[G, Q]``, True = maybe
    present.  The probe position wraps at 2**32 before the modulo."""
    h1, h2 = bloom_hashes(keys)
    m = filters.shape[-1] * 32
    fw = u32(filters)
    ok = torch.ones(h1.shape, dtype=torch.bool, device=keys.device)
    for i in range(n_probes):
        pos = ((h1 + i * h2) & MASK32) % m
        word = torch.gather(fw, 1, pos >> 5)
        ok &= ((word >> (pos & 31)) & 1) == 1
    return ok


def bloom_multi_probe(filters: torch.Tensor, keys: torch.Tensor, *,
                      n_probes: int) -> torch.Tensor:
    """Pairwise probe: key row ``i`` (``[C, L]``) against filter row ``i``
    (``[C, W]``).  Returns bool ``[C]``."""
    return bloom_query(filters, keys[:, None, :], n_probes=n_probes)[:, 0]


# ---------------------------------------------------------------------------
# Shared-prefix encode / decode
# ---------------------------------------------------------------------------


_BYTE_SHIFTS = (24, 16, 8, 0)


def u32_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """Big-endian bytes ``[..., 4L]`` (int64) of uint32 lanes ``[..., L]``,
    so byte order equals lane order."""
    shifts = torch.tensor(_BYTE_SHIFTS, device=words.device)
    b = (u32(words)[..., None] >> shifts) & 0xFF
    return b.reshape(*words.shape[:-1], words.shape[-1] * 4)


def bytes_to_u32(b: torch.Tensor) -> torch.Tensor:
    """Pack big-endian bytes ``[..., 4L]`` back to int32 lanes ``[..., L]``."""
    L = b.shape[-1] // 4
    shifts = torch.tensor(_BYTE_SHIFTS, device=b.device)
    b4 = b.reshape(*b.shape[:-1], L, 4).to(torch.int64)
    return as_i32((b4 << shifts).sum(-1))


def prefix_encode(keys: torch.Tensor, *,
                  restart_interval: int) -> torch.Tensor:
    """For sorted keys ``[n, L]``: int32 ``[n]`` count of leading bytes
    shared with the previous key, 0 at every restart point."""
    kb = u32_to_bytes(keys)
    eq = (kb == torch.roll(kb, 1, dims=0)).to(torch.int32)
    shared = torch.cumprod(eq, dim=-1).sum(-1)
    idx = torch.arange(keys.shape[0], device=keys.device)
    return torch.where(idx % restart_interval == 0, 0,
                       shared).to(torch.int32)


def prefix_mask(nz: torch.Tensor) -> torch.Tensor:
    """int64 lane masks covering the first ``nz`` (0..4) big-endian bytes."""
    return ~(torch.full_like(nz, MASK32) >> (8 * nz)) & MASK32


def zero_prefix_lanes(keys: torch.Tensor,
                      shared: torch.Tensor) -> torch.Tensor:
    """Zero the first ``shared[i]`` bytes of each big-endian-lane key in
    lane space."""
    lanes = keys.shape[-1]
    i4 = 4 * torch.arange(lanes, device=keys.device)
    nz = torch.clamp(shared.to(torch.int64)[:, None] - i4[None, :], 0, 4)
    return keys & (~prefix_mask(nz)).to(torch.int32)


def prefix_encode_wire(keys: torch.Tensor, count: torch.Tensor, *,
                       restart_interval: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's prefix step: ``(shared, wire)``, the shared lengths of
    :func:`prefix_encode` set to 0 from row ``count`` (the survivors) on,
    and the keys with their first ``shared`` bytes zeroed."""
    valid = torch.arange(keys.shape[0], device=keys.device) < count
    shared = torch.where(valid, prefix_encode(
        keys, restart_interval=restart_interval), 0)
    return shared, zero_prefix_lanes(keys, shared)


def prefix_encode_wire_batched(keys: torch.Tensor, counts: torch.Tensor, *,
                               restart_interval: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`prefix_encode_wire` for a batch of jobs: keys ``[J, n, L]``
    and int64 ``counts [J]``, each job on its own (``shared [J, n]``,
    ``wire [J, n, L]``)."""
    parts = [prefix_encode_wire(k, c, restart_interval=restart_interval)
             for k, c in zip(keys, counts)]
    if not parts:
        return (keys.new_zeros(keys.shape[:-1]), keys.clone())
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def prefix_decode(shared: torch.Tensor, keys_raw: torch.Tensor, *,
                  restart_interval: int) -> torch.Tensor:
    """Restore full keys from the prefix-zeroed lanes: row ``t`` of an
    interval takes its first ``shared[t]`` bytes from row ``t - 1``.
    Vectorised across restart intervals; the loop runs over the
    ``restart_interval`` rows of one interval (the data dependence)."""
    n, lanes = keys_raw.shape
    r = restart_interval
    k = u32(keys_raw).reshape(n // r, r, lanes)
    sh = shared.to(torch.int64).reshape(n // r, r)
    i4 = 4 * torch.arange(lanes, device=keys_raw.device)
    prev = torch.zeros_like(k[:, 0])
    rows = []
    for t in range(r):
        mask = prefix_mask(torch.clamp(sh[:, t, None] - i4, 0, 4))
        prev = (prev & mask) | (k[:, t] & ~mask & MASK32)
        rows.append(prev)
    return as_i32(torch.stack(rows, dim=1).reshape(n, lanes))


# ---------------------------------------------------------------------------
# Lexicographic order, tuple sort, run-aware merge
# ---------------------------------------------------------------------------


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over the last axis of int64 unsigned
    values (see :func:`u32`)."""
    res = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(res)
    for lane in range(a.shape[-1]):
        res = res | (eq & (a[..., lane] < b[..., lane]))
        eq = eq & (a[..., lane] == b[..., lane])
    return res


def lex_searchsorted(hay: torch.Tensor, q: torch.Tensor, *,
                     side: str = "left") -> torch.Tensor:
    """Binary search of rows ``q`` in sorted rows ``hay`` (both int64
    unsigned values): ``left`` counts hay rows < q, ``right`` rows <= q."""
    n = hay.shape[0]
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, n)
    if n == 0:
        return lo
    for _ in range((n + 1).bit_length()):
        go = lo < hi
        mid = (lo + hi) >> 1
        row = hay[torch.clamp(mid, 0, n - 1)]
        if side == "left":
            descend = lex_less(row, q)
        else:
            descend = ~lex_less(q, row)
        lo = torch.where(go & descend, mid + 1, lo)
        hi = torch.where(go & ~descend, mid, hi)
    return lo


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted int32 row arrays by rank and scatter; ties go to
    ``a`` (the earlier run)."""
    m, n = a.shape[0], b.shape[0]
    if m == 0:
        return b
    if n == 0:
        return a
    ua, ub = u32(a), u32(b)
    pos_a = torch.arange(m, device=a.device) + lex_searchsorted(ub, ua)
    pos_b = torch.arange(n, device=a.device) + lex_searchsorted(
        ua, ub, side="right")
    out = torch.empty((m + n, a.shape[1]), dtype=a.dtype, device=a.device)
    out.index_copy_(0, pos_a, a)
    out.index_copy_(0, pos_b, b)
    return out


def tree_merge(items: list, merge2):
    """Pairwise merge tree: ``ceil(log2 k)`` levels over adjacent pairs,
    an odd leftover carried up.  Left operands precede right ones, so a
    ties-to-left ``merge2`` gives a stable merge (the same tree as
    ``repro.kernels.common.tree_merge``)."""
    items = list(items)
    if not items:
        raise ValueError("tree_merge needs at least one item")
    while len(items) > 1:
        nxt = [merge2(items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def split_runs(rows: torch.Tensor, run_lens) -> list[torch.Tensor]:
    """The non-empty runs of ``rows`` (``run_lens`` must cover it)."""
    if sum(run_lens) != rows.shape[0]:
        raise ValueError(f"run_lens {tuple(run_lens)} must cover "
                         f"{rows.shape[0]} rows")
    runs, off = [], 0
    for ln in run_lens:
        if ln > 0:
            runs.append(rows[off:off + ln])
        off += ln
    return runs


def merge_runs(rows: torch.Tensor, run_lens) -> torch.Tensor:
    """Merge the sorted runs stored back to back in ``rows``; zero-length
    runs are skipped and one run passes through."""
    runs = split_runs(rows, run_lens)
    if not runs:
        return rows
    return tree_merge(runs, merge_sorted)


def merge_runs_batched(rows: torch.Tensor, run_lens) -> torch.Tensor:
    """:func:`merge_runs` for a batch of jobs with the same runs: rows
    ``[J, n, L]``, each job merged on its own."""
    if rows.shape[0] == 0:
        return rows
    return torch.stack([merge_runs(r, run_lens) for r in rows])


def sort_tuples(rows: torch.Tensor, num_keys: int | None = None
                ) -> torch.Tensor:
    """Stable ascending lexicographic sort of rows ``[n, L]`` by their
    first ``num_keys`` lanes (unsigned), by stable passes from the last
    key lane to the first."""
    if num_keys is None:
        num_keys = rows.shape[1]
    order = torch.arange(rows.shape[0], device=rows.device)
    for lane in reversed(range(num_keys)):
        o = torch.sort(u32(rows[order, lane]), stable=True).indices
        order = order[o]
    return rows[order]


def lookup_blocks(keys: torch.Tensor, meta: torch.Tensor, vals: torch.Tensor,
                  nvalid: torch.Tensor, queries: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query row ``i`` (``[C, L]``) searched in block ``i``: ``keys``
    ``[C, K, L]`` sorted, with the all-ones sentinel at and after
    ``nvalid[i]``; ``meta`` ``[C, K]``; ``vals`` ``[C, K, Vw]``.  Returns
    ``(found bool [C], meta int32 [C], value int32 [C, Vw])``, zeroed
    where not found.  The match is the lower bound (the leftmost equal
    row, the newest version); a row with ``nvalid = 0`` finds nothing."""
    c, k, _ = keys.shape
    uk, uq = u32(keys), u32(queries)
    rows = torch.arange(c, device=keys.device)
    lo = torch.zeros(c, dtype=torch.int64, device=keys.device)
    hi = torch.full_like(lo, k)
    for _ in range((k + 1).bit_length()):
        go = lo < hi
        mid = (lo + hi) >> 1
        descend = lex_less(uk[rows, torch.clamp(mid, 0, k - 1)], uq)
        lo = torch.where(go & descend, mid + 1, lo)
        hi = torch.where(go & ~descend, mid, hi)
    idx = torch.clamp(lo, 0, k - 1)
    found = (keys[rows, idx] == queries).all(-1) & \
        (lo < nvalid.to(torch.int64))
    m = torch.where(found, meta[rows, idx], 0)
    v = torch.where(found[:, None], vals[rows, idx], 0)
    return found, m, v


def lookup_blocks_packed(keys: torch.Tensor, meta: torch.Tensor,
                         vals: torch.Tensor, nvalid: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """:func:`lookup_blocks`'s three outputs side by side: int32
    ``[C, 2 + Vw]`` of found (0 or 1), the meta word and the value."""
    found, m, v = lookup_blocks(keys, meta, vals, nvalid, queries)
    return torch.cat([found.to(torch.int32)[:, None], m[:, None], v], dim=1)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 forward recurrence, one step at a time in fp32 (the
    port's ``selective_scan_ref``).  ``u``/``dt`` ``[B, S, di]``, ``b``/``c``
    ``[B, S, ds]``, ``a_log`` ``[di, ds]``, ``d_skip`` ``[di]``, ``h0``
    ``[B, di, ds]`` or None (zeros).  Returns ``(y [B, S, di],
    h_last [B, di, ds])``, both fp32; ``y`` includes the ``D * u`` skip."""
    bsz, seq, di = u.shape
    ds = b.shape[-1]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    h = torch.zeros((bsz, di, ds), dtype=f32, device=u.device) \
        if h0 is None else h0.to(f32)
    u, dt, b, c = (x.to(f32) for x in (u, dt, b, c))
    d_skip = d_skip.to(f32)
    y = torch.empty((bsz, seq, di), dtype=f32, device=u.device)
    for t in range(seq):
        da = torch.exp(dt[:, t, :, None] * a)
        dbu = (dt[:, t] * u[:, t])[..., None] * b[:, t, None, :]
        h = da * h + dbu
        y[:, t] = (h * c[:, t, None, :]).sum(-1) + d_skip * u[:, t]
    return y, h


def selective_scan_bwd(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a_log: torch.Tensor,
                       d_skip: torch.Tensor, h0: torch.Tensor | None,
                       dy: torch.Tensor, dh_last: torch.Tensor | None = None
                       ) -> tuple:
    """The gradient of :func:`selective_scan`: autograd through it, the
    forward recomputed under ``torch.enable_grad``.  Returns ``(du, ddt,
    db, dc, da_log, dd_skip, dh0)``: ``du`` in ``u``'s dtype (the gradient
    taken in fp32, as the scan reads ``u``, then rounded once), the rest
    fp32, ``dh0`` None when ``h0`` is None; ``dh_last`` None means no
    gradient reaches ``h_last``."""
    f32 = torch.float32
    with torch.enable_grad():
        ins = [x.detach().to(f32).requires_grad_()
               for x in (u, dt, b, c, a_log, d_skip)]
        h = None if h0 is None else h0.detach().to(f32).requires_grad_()
        y, h_last = selective_scan(*ins, h)
        outs, grads = [y], [dy.to(f32)]
        if dh_last is not None:
            outs.append(h_last)
            grads.append(dh_last.to(f32))
        wrt = ins + ([] if h is None else [h])
        got = torch.autograd.grad(outs, wrt, grads)
    return (got[0].to(u.dtype), *got[1:6], None if h is None else got[6])
