"""Wrapper of the CUDA video resize kernel (csrc/resize_words.cu).

Replaces the TPU kernels of timg_tpu/ops/resize_pallas.py:
``resize_video_words_pallas`` (K1) and ``resize_video_words_pallas_tiled``
(K2).  Two launches, one per separable pass, in the order
``ops/resize.vertical_first`` gives; the bf16 intermediate
[B, 3, H1, W1] is allocated here.  Bound by device-memory bytes on the
H100 (see the source's note).  The plain version is
``ops/resize.resize_video_words_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from timg_tpu_torch.ops import _build
from timg_tpu_torch.ops.resize import axis_taps, vertical_first

LAUNCHES = 0   # kernel launches (one per resize, both passes together)

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.timg_resize_words_to_mid, lib.timg_resize_mid_to_words):
            fn.argtypes = [p, i, i, i, p, p, i, i, i, p, p]
            fn.restype = ctypes.c_int
        _bound = lib
    return _bound


def _tables(in_size, out_size, horizontal, given, dev):
    starts, taps = given if given is not None else axis_taps(
        in_size, out_size, horizontal)
    starts = starts.to(dev, torch.int32).contiguous()
    taps = taps.to(dev, torch.bfloat16).contiguous()
    if starts.shape[0] != out_size or taps.shape[0] != out_size:
        raise ValueError("tap tables do not match the output size")
    return starts, taps


def resize_video_words_cuda(words: torch.Tensor, out_h: int, out_w: int,
                            taps_v=None, taps_h=None) -> torch.Tensor:
    """[B, H, W] int32 CUDA words -> [B, out_h, out_w] int32 words."""
    global LAUNCHES
    if not words.is_cuda or words.dtype != torch.int32 or words.dim() != 3:
        raise ValueError("resize_video_words_cuda takes [B, H, W] int32 "
                         "CUDA words")
    words = words.contiguous()
    b, in_h, in_w = words.shape
    dev = words.device
    sv, tv = _tables(in_h, out_h, False, taps_v, dev)
    sh, th = _tables(in_w, out_w, True, taps_h, dev)
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    if vertical_first(in_h, in_w, out_h, out_w):
        mid = torch.empty((b, 3, out_h, in_w), dtype=torch.bfloat16,
                          device=dev)
        first = (sv, tv, 1, out_h)
        second = (sh, th, 0, out_w)
    else:
        mid = torch.empty((b, 3, in_h, out_w), dtype=torch.bfloat16,
                          device=dev)
        first = (sh, th, 0, out_w)
        second = (sv, tv, 1, out_h)
    s, t, vert, n = first
    _build.check(lib.timg_resize_words_to_mid(
        ptr(words), b, in_h, in_w, ptr(s), ptr(t), t.shape[1], vert, n,
        ptr(mid), stream), "resize_words_to_mid")
    s, t, vert, n = second
    _build.check(lib.timg_resize_mid_to_words(
        ptr(mid), b, mid.shape[2], mid.shape[3], ptr(s), ptr(t),
        t.shape[1], vert, n, ptr(out), stream), "resize_mid_to_words")
    LAUNCHES += 1
    return out
