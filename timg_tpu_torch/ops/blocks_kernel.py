"""Wrapper of the CUDA block-cell kernels (csrc/block_cells.cu).

Replaces the device side of timg_tpu/ops/blocks.py ``quarter_blocks``
and ``half_blocks`` with timg_tpu/ops/diff.py ``window_cell_diff`` (XLA
in the reference, one fused pass; no Pallas kernel): one launch a window,
one thread a cell, reading the resized [B, th, tw] int32 RGBA words with
the odd-height blank row and the previous window's tail supplied by
indexing.  Half cells are bound by device-memory bytes (8 B in and 10 B
out a cell), quarter cells by instruction issue (a few hundred float
operations a cell, none contracted).  A call allocates one byte buffer
for its four outputs, handed out as views, so the host fetches a window
with one copy (``ops/blocks.cells_to_host``).  The plain versions are
``ops/blocks.quarter_cells_plain`` and ``half_cells_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from timg_tpu_torch.ops import _build

QUARTER_LAUNCHES = 0   # quarter-cell launches (one per call)
HALF_LAUNCHES = 0      # half-cell launches (one per call)

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.timg_quarter_cells, lib.timg_half_cells):
            fn.argtypes = [p, p, i, i, i, i, p, p, p, p, p]
            fn.restype = ctypes.c_int
        _bound = lib
    return _bound


def _stream(index: int) -> int:
    """The handle of the device's current stream, as torch's own compiled
    kernels read it: ``torch.cuda.current_stream()`` builds a Stream
    object, 6 us a call on the card's host."""
    return torch._C._cuda_getCurrentRawStream(index)


def _cells_cuda(entry: str, counter: str, cell_w: int, words: torch.Tensor,
                use_upper: bool, prev: Optional[torch.Tensor], diff: bool):
    if not (words.is_cuda and words.dtype == torch.int32
            and words.dim() == 3):
        raise ValueError(f"{entry} takes [B, th, tw] int32 CUDA words")
    b, th, tw = words.shape
    if tw % cell_w:
        raise ValueError(f"{entry}: width {tw} is not a multiple of "
                         f"{cell_w}")
    if prev is not None and (prev.shape != (th, tw)
                             or prev.dtype != torch.int32
                             or prev.device != words.device):
        raise ValueError(f"{entry}: the tail must be [{th}, {tw}] int32 "
                         "words on the window's device")
    words = words.contiguous()
    if words.data_ptr() % 8:         # the kernel loads 8-byte word pairs
        words = words.clone()
    if prev is not None:
        prev = prev.contiguous()
        if prev.data_ptr() % 8:
            prev = prev.clone()
    glyph, fg, bg, eq = cell_outputs((b, (th + 1) // 2, tw // cell_w), diff,
                                     words.device)
    if glyph.numel() == 0:
        return glyph, fg, bg, eq
    with torch.cuda.device(words.device):  # the C launch's current device
        _build.check(getattr(_lib(), entry)(
            words.data_ptr(), prev.data_ptr() if prev is not None else None,
            b, th, tw, int(bool(use_upper)), glyph.data_ptr(),
            fg.data_ptr(), bg.data_ptr(), eq.data_ptr() if diff else None,
            _stream(words.device.index)), entry)
    globals()[counter] += 1
    return glyph, fg, bg, eq


def cell_outputs(shape, diff: bool, device):
    """The outputs of one call as views of one uint8 buffer: fg and bg
    (int32 words, first, so 4-byte aligned), then glyph (uint8) and eq
    (bool, or None without the diff), each of ``shape``.  Each view is
    one as_strided of the buffer: on the card's host every tensor op
    costs microseconds, as much as the kernel at the CLI's geometry."""
    b, h, w = shape
    n = b * h * w
    stride = (h * w, w, 1)
    buf = torch.empty(-(-n * (10 if diff else 9) // 4) * 4, dtype=torch.uint8,
                      device=device)
    words = buf.view(torch.int32)
    return (buf.as_strided(shape, stride, 8 * n),
            words.as_strided(shape, stride, 0),
            words.as_strided(shape, stride, n),
            buf.view(torch.bool).as_strided(shape, stride, 9 * n)
            if diff else None)


def quarter_cells_cuda(words: torch.Tensor, use_upper: bool = False,
                       prev: Optional[torch.Tensor] = None,
                       diff: bool = True):
    """The CUDA kernel of ``ops/blocks.quarter_cells``: [B, th, tw] int32
    words (tw even), an optional [th, tw] tail -> (glyph uint8, fg, bg
    int32 words, eq bool or None), each [B, ceil(th/2), tw/2]."""
    return _cells_cuda("timg_quarter_cells", "QUARTER_LAUNCHES", 2, words,
                       use_upper, prev, diff)


def half_cells_cuda(words: torch.Tensor, use_upper: bool = False,
                    prev: Optional[torch.Tensor] = None, diff: bool = True):
    """The CUDA kernel of ``ops/blocks.half_cells``: as
    ``quarter_cells_cuda`` with [B, ceil(th/2), tw] outputs."""
    return _cells_cuda("timg_half_cells", "HALF_LAUNCHES", 1, words,
                       use_upper, prev, diff)
