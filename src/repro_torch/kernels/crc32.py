"""Sectioned CRC-32 of SST block rows on the card (``csrc/crc32.cu``, a
segmented byte-table CRC).

The port's counterpart of ``repro.kernels.crc32``; the plain version is
``ref.crc32_words_sections``.  The kernel reads the byte table and shift
operators of ``tables.crc32_kernel_tables`` (9.5 KB), not the plain
version's ``[W, 32]`` operator table.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, tables

MAX_SECTIONS = 5


@functools.lru_cache(maxsize=16)
def kernel_tables(n_words: int, device: str) -> tuple[int, torch.Tensor]:
    """``(run, table)``: the words a lane for rows of ``n_words`` and the
    kernel's byte table and shift operators as int32 bit patterns."""
    run, t = tables.crc32_kernel_tables(n_words)
    return run, torch.from_numpy(t.view("int32").copy()).to(device)


def crc32_blocks_sections(sections) -> torch.Tensor:
    """CRC-32 of the logical concatenation of per-block sections: each
    section a contiguous int32 ``[n_blocks, w_i]`` CUDA tensor of uint32
    bit patterns.  Returns int32 ``[n_blocks]`` bit patterns."""
    sections = list(sections)
    if not 1 <= len(sections) <= MAX_SECTIONS:
        raise ValueError(f"crc32: 1..{MAX_SECTIONS} sections, got "
                         f"{len(sections)}")
    n = sections[0].shape[0]
    for s in sections:
        _build.check_cuda(s, "crc32 section", torch.int32, 2)
        if s.shape[0] != n or s.device != sections[0].device:
            raise ValueError("crc32: sections differ in rows or device")
    total = sum(s.shape[1] for s in sections)
    run, table = kernel_tables(total, str(sections[0].device))
    out = torch.empty(n, dtype=torch.int32, device=sections[0].device)
    ptrs = [s.data_ptr() for s in sections] + \
        [None] * (MAX_SECTIONS - len(sections))
    widths = [s.shape[1] for s in sections] + \
        [0] * (MAX_SECTIONS - len(sections))
    _build.launch("crc32_sections", *ptrs, *widths, len(sections),
                  table.data_ptr(), run, tables.crc32_zero_message(total * 4),
                  out.data_ptr(), n, _build.stream_handle(out))
    return out


def crc32_blocks(words: torch.Tensor) -> torch.Tensor:
    """CRC-32 of each row of ``words`` (int32 ``[n_blocks, n_words]``)."""
    return crc32_blocks_sections([words])
