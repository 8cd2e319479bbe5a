"""Host-side precomputed operator tables for the bit-parallel CRC-32 kernel.

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
and its plain version read the same table.)
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
