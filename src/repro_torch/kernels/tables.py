"""Host-side precomputed CRC-32 tables: the bit-parallel operator table of
the plain version, and the byte table and GF(2) shift operators of the
card's segmented CRC.

CRC-32 (the IEEE 802.3 polynomial used by LevelDB block trailers via
``binascii.crc32``) is an *affine* map over GF(2): for two equal-length
messages ``A`` and ``B``::

    crc32(A) ^ crc32(B) == L(A ^ B)

where ``L`` is linear in the message bits.  Therefore for a fixed message
length ``n`` bytes::

    crc32(M) == XOR_{set bits (w, j) of M} T[w, j]  ^  crc32(0^n)

with ``T[w, j] = crc32(e_{w,j}) ^ crc32(0^n)`` and ``e_{w,j}`` the message
that is all zeros except bit ``j`` of little-endian uint32 word ``w``.

This turns the byte-serial CRC into a wide XOR-reduction -- the TPU-native
formulation used by the Pallas kernel (a serial table-driven CRC would leave
the VPU idle; gathers from a 256-entry table are pathological on TPU).

The table only depends on the message length, so it is computed once per
block geometry on the host (numpy + binascii, exact) and cached.  (A copy
of ``repro.kernels.tables``: the port's CUDA kernel, ``csrc/crc32.cu``,
reads the byte table and shift operators at the end of this module;
the plain version reads the operator table.)

The segmented form the card runs.  With ``raw(M)`` the CRC register after
the bytes of ``M`` from a zero register, without the final inversion,
``crc32(M) == raw(M) ^ crc32(0^n)``, and for a split ``M = A || B``::

    raw(A || B) == shift(raw(A), len(B)) ^ raw(B)

where ``shift(x, n)`` runs ``n`` zero bytes through the register from
``x``: a GF(2)-linear map, stored as its 32 columns ``shift(1 << j, n)``.
A warp cuts a row into 32 runs, one a lane; each lane runs the byte-table
CRC over its run (one table load a byte), applies the shift operator for
the bytes after its run, and the warp XORs the 32 results.  :func:`crc32_segmented` walks the same
algorithm in numpy.
"""

from __future__ import annotations

import binascii
import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def crc32_zero_message(n_bytes: int) -> int:
    """crc32 of ``n_bytes`` zero bytes (the affine constant for length n)."""
    return binascii.crc32(b"\x00" * n_bytes) & 0xFFFFFFFF


@functools.lru_cache(maxsize=16)
def crc32_operator_table(n_words: int) -> np.ndarray:
    """Return ``T`` of shape ``(n_words, 32)`` uint32.

    ``T[w, j]`` is the CRC contribution of bit ``j`` of little-endian word
    ``w`` in an ``n_words * 4``-byte message.

    Cost: ``32 * n_words`` binascii CRCs over the zero prefix.  We exploit the
    shift structure: the contribution of a bit only depends on its distance
    from the *end* of the message, so we compute the 32 bit patterns for every
    *byte offset from the end* once, and the table rows are just slices.
    """
    n_bytes = n_words * 4
    base = crc32_zero_message(n_bytes)
    # contribution of bit b of the byte at distance d from the end, for
    # d in [0, n_bytes) and b in [0, 8).
    per_byte = np.zeros((n_bytes, 8), dtype=np.uint64)
    # crc32 of (one-hot byte) followed by d zero bytes equals the contribution
    # of that byte at distance d, xor the zero-message constant of length d+1.
    # Incrementally extend the zero tail instead of recomputing full messages.
    for b in range(8):
        onehot = bytes([1 << b])
        state = binascii.crc32(onehot)  # message length 1, distance 0
        zstate = binascii.crc32(b"\x00")
        per_byte[0, b] = (state ^ zstate) & 0xFFFFFFFF
        s, z = state, zstate
        for d in range(1, n_bytes):
            s = binascii.crc32(b"\x00", s)
            z = binascii.crc32(b"\x00", z)
            per_byte[d, b] = (s ^ z) & 0xFFFFFFFF
    # Map (word w, bit j) -> (byte offset w*4 + j//8, bit j%8), distance from
    # end = n_bytes - 1 - byte_offset.
    T = np.zeros((n_words, 32), dtype=np.uint32)
    for j in range(32):
        byte_in_word = j // 8
        bit = j % 8
        offsets = np.arange(n_words) * 4 + byte_in_word
        dist = n_bytes - 1 - offsets
        T[:, j] = per_byte[dist, bit].astype(np.uint32)
    # Consistency probe: one-hot message check (cheap, catches table bugs).
    probe = bytearray(n_bytes)
    probe[0] = 0x01
    want = binascii.crc32(bytes(probe)) & 0xFFFFFFFF
    got = int(T[0, 0]) ^ base
    if want != got:
        raise AssertionError("crc32 operator table self-check failed")
    return T


# ---------------------------------------------------------------------------
# segmented CRC (csrc/crc32.cu)
# ---------------------------------------------------------------------------

CRC32_POLY = 0xEDB88320      # IEEE 802.3, bit-reflected
CRC32_RUNS = 32              # runs a chunk: one a lane of a warp (kRuns)
CRC32_MAX_RUN = 39           # words a run at most (kMaxRun); odd, so the
                             # lanes' run starts fall in distinct banks
CRC32_SLOTS = 2 * CRC32_RUNS + 2    # shift operators in the kernel's table


@functools.lru_cache(maxsize=1)
def crc32_byte_table() -> np.ndarray:
    """The byte table ``[256]`` uint32 of the reflected register update
    ``r = (r >> 8) ^ T[(r ^ b) & 0xFF]``."""
    t = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if c & 1 else 0)
        t[i] = c
    return t


def crc32_raw_words(words: np.ndarray) -> np.ndarray:
    """``raw`` of each row of uint32 ``words [..., n]`` (little-endian
    bytes) as the kernel's lanes run it: XOR a word into the register, then
    four byte steps."""
    t = crc32_byte_table()
    words = np.asarray(words, np.uint32)
    s = np.zeros(words.shape[:-1], np.uint32)
    for w in np.moveaxis(words, -1, 0):
        s ^= w
        for _ in range(4):
            s = (s >> np.uint32(8)) ^ t[s & 0xFF]
    return s


def crc32_shift_columns(distances) -> np.ndarray:
    """``[len(distances), 32]`` uint32: row ``k`` holds the columns of
    ``shift(., distances[k])`` (bytes), column ``j`` being ``shift(1 << j,
    d)``."""
    distances = [int(d) for d in distances]
    t0 = crc32_byte_table()
    out = np.zeros((len(distances), 32), np.uint32)
    state = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    want = sorted(set(distances))
    done = 0
    at = {}
    for d in want:
        for _ in range(d - done):
            state = (state >> np.uint32(8)) ^ t0[state & 0xFF]
        done = d
        at[d] = state.copy()
    for k, d in enumerate(distances):
        out[k] = at[d]
    return out


def crc32_apply_shift(columns: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Apply the shift operator with ``columns [32]`` to each of ``x``."""
    x = np.asarray(x, np.uint32)
    bits = (x[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, columns, np.uint32(0)),
                                 axis=-1).astype(np.uint32)


def crc32_run_plan(n_words: int) -> tuple[int, int, int, int]:
    """How the kernel cuts a row of ``n_words``: ``(run, chunk, n_chunks,
    last)`` -- ``run`` words a run (odd, at most ``CRC32_MAX_RUN``),
    ``chunk = CRC32_RUNS * run`` words staged at a time, and the ``last``
    chunk's words (1..chunk)."""
    if n_words < 1:
        raise ValueError(f"crc32: a row needs at least one word, got "
                         f"{n_words}")
    run = min(-(-n_words // CRC32_RUNS) | 1, CRC32_MAX_RUN)
    chunk = CRC32_RUNS * run
    n_chunks = -(-n_words // chunk)
    return run, chunk, n_chunks, n_words - (n_chunks - 1) * chunk


def _run_distances(words: int, run: int) -> list[int]:
    """Bytes after each run in a chunk of ``words`` (0 for an empty
    run)."""
    return [4 * (words - min((r + 1) * run, words))
            if r * run < words else 0 for r in range(CRC32_RUNS)]


@functools.lru_cache(maxsize=16)
def crc32_kernel_tables(n_words: int) -> tuple[int, np.ndarray]:
    """``(run, table)`` for rows of ``n_words``: ``table`` is uint32, the
    byte table (256 words) then the shift operators as ``[32,
    CRC32_SLOTS]`` (column ``j`` of slot ``k`` at ``j * CRC32_SLOTS + k``,
    so the lanes of a warp read consecutive words).  Slots: 0..31 run
    ``r``'s shift in a full chunk, 32..63 in the last chunk, 64 the shift
    by a full chunk, 65 by the last chunk."""
    run, chunk, _, last = crc32_run_plan(n_words)
    d = _run_distances(chunk, run) + _run_distances(last, run) + \
        [4 * chunk, 4 * last]
    ops = crc32_shift_columns(d).T    # [32, slots]
    return run, np.concatenate([crc32_byte_table(),
                                np.ascontiguousarray(ops).ravel()])


def crc32_segmented(words: np.ndarray) -> np.ndarray:
    """CRC-32 of each row of uint32 ``words [n_rows, n_words]`` by the
    kernel's algorithm, step for step, read from
    :func:`crc32_kernel_tables`: runs of ``run`` words, each shifted by its
    operator, XORed across the warp, chunks joined by the chunk shift, then
    the zero-message constant."""
    words = np.asarray(words, np.uint32)
    n_words = words.shape[-1]
    run, chunk, n_chunks, last = crc32_run_plan(n_words)
    _, table = crc32_kernel_tables(n_words)
    ops = table[256:].reshape(32, CRC32_SLOTS)
    acc = np.zeros(words.shape[:-1], np.uint32)
    for c in range(n_chunks):
        is_last = c == n_chunks - 1
        width = last if is_last else chunk
        part = np.zeros_like(acc)
        for r in range(CRC32_RUNS):
            lo, hi = r * run, min((r + 1) * run, width)
            if lo >= hi:
                continue
            raw = crc32_raw_words(words[..., c * chunk + lo:c * chunk + hi])
            slot = r + (CRC32_RUNS if is_last else 0)
            part ^= crc32_apply_shift(ops[:, slot], raw)
        acc = crc32_apply_shift(ops[:, 2 * CRC32_RUNS + is_last], acc) ^ \
            part
    return acc ^ np.uint32(crc32_zero_message(n_words * 4))
