"""Wrapper of the CUDA block-cell kernels (csrc/block_cells.cu).

Replaces the device side of timg_tpu/ops/blocks.py ``quarter_blocks``
and ``half_blocks`` with timg_tpu/ops/diff.py ``window_cell_diff`` (XLA
in the reference, one fused pass; no Pallas kernel): one launch a window,
one thread a cell, reading the resized [B, th, tw] int32 RGBA words with
the odd-height blank row and the previous window's tail supplied by
indexing.  Its bound on the H100 is device-memory bytes (16 B in and 10 B
out a quarter cell); quarter cells run issue-bound by their correctly
rounded divisions and roots.  The plain versions are
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
    shape = (b, (th + 1) // 2, tw // cell_w)
    dev = words.device
    glyph = torch.empty(shape, dtype=torch.uint8, device=dev)
    fg = torch.empty(shape, dtype=torch.int32, device=dev)
    bg = torch.empty(shape, dtype=torch.int32, device=dev)
    eq = torch.empty(shape, dtype=torch.bool, device=dev) if diff else None
    if glyph.numel() == 0:
        return glyph, fg, bg, eq
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    _build.check(getattr(_lib(), entry)(
        ptr(words), ptr(prev), b, th, tw, int(bool(use_upper)), ptr(glyph),
        ptr(fg), ptr(bg), ptr(eq),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)), entry)
    globals()[counter] += 1
    return glyph, fg, bg, eq


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
