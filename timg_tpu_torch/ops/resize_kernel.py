"""Wrappers of the CUDA video resize kernels (csrc/resize_words.cu and
csrc/resize_passes.cu).

Replace the TPU kernels of timg_tpu/ops/resize_pallas.py:
``resize_video_words_pallas`` (K1) and ``resize_video_words_pallas_tiled``
(K2).  One launch a resize: both separable passes in one tile kernel
whose bf16-rounded intermediate stays in shared memory, tiled as
``ops/resize.plan_tiles`` says; only the output is allocated here.
Where no tile fits (``plan_tiles`` returns None, near a 90x downscale of
both axes), the two-pass kernels of csrc/resize_passes.cu run instead,
through a bf16 intermediate in device memory; their pass along rows
reads its taps laid out by thread (``resize.slot_taps``).  Both read the tap tables
that this module caches on the device per geometry; no caller passes
tables.  Bound by device-memory bytes on the H100 (see the sources'
notes).  The plain version is ``ops/resize.resize_video_words_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from timg_tpu_torch.ops import _build
from timg_tpu_torch.ops.resize import (axis_taps, order_blocks, plan_tiles,
                                       slot_taps, vertical_first)

LAUNCHES = 0        # fused tile kernel launches (one per resize)
PASS_LAUNCHES = 0   # two-pass route launches (both passes of one resize)

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.timg_resize_words.argtypes = [p, i, i, i, p, p, i, i, p, p, i,
                                          i, i, i, i, p, p, i, i, i, p, p]
        lib.timg_resize_words.restype = ctypes.c_int
        lib.timg_resize_words_to_mid.argtypes = [p, i, i, i, p, p, i, i, i,
                                                 p, p]
        lib.timg_resize_mid_to_words.argtypes = [p, i, i, i, p, p, i, i, i,
                                                 i, p, p]
        for fn in (lib.timg_resize_words_to_mid, lib.timg_resize_mid_to_words):
            fn.restype = ctypes.c_int
        lib.timg_resize_rows_to_mid.argtypes = [p, i, i, i, p, p, i, p, i, i,
                                                i, p, p]
        lib.timg_resize_rows_to_mid.restype = ctypes.c_int
        _bound = lib
    return _bound


@functools.lru_cache(maxsize=16)
def _device_taps(in_h, in_w, out_h, out_w, dev):
    """(starts_v, taps_v, starts_h, taps_h) on ``dev``, copied from the
    host once per geometry and device."""
    host = (*axis_taps(in_h, out_h, False), *axis_taps(in_w, out_w, True))
    return tuple(t.to(dev).contiguous() for t in host)


@functools.lru_cache(maxsize=16)
def _device_slot_taps(in_w, out_w, dev):
    """``slot_taps`` of the horizontal axis on ``dev``: (taps, dst,
    nb_max)."""
    taps, dst, nb_max = slot_taps(*axis_taps(in_w, out_w, True), in_w)
    return taps.to(dev).contiguous(), dst.to(dev).contiguous(), nb_max


@functools.lru_cache(maxsize=32)
def _blocks(in_size, out_size, horizontal):
    """The most order blocks one band of the axis touches."""
    starts, taps = axis_taps(in_size, out_size, horizontal)
    return order_blocks(starts, taps.shape[1])


@functools.lru_cache(maxsize=16)
def _device_windows(in_h, in_w, out_h, out_w, dev):
    """The tile plan's (windows_v, windows_h) on ``dev``."""
    plan = plan_tiles(in_h, in_w, out_h, out_w)
    return tuple(torch.from_numpy(w).to(dev).contiguous()
                 for w in (plan.windows_v, plan.windows_h))


def resize_video_words_cuda(words: torch.Tensor, out_h: int,
                            out_w: int) -> torch.Tensor:
    """[B, H, W] int32 CUDA words -> [B, out_h, out_w] int32 words."""
    global LAUNCHES
    if not words.is_cuda or words.dtype != torch.int32 or words.dim() != 3:
        raise ValueError("resize_video_words_cuda takes [B, H, W] int32 "
                         "CUDA words")
    words = words.contiguous()
    b, in_h, in_w = words.shape
    dev = words.device
    plan = plan_tiles(in_h, in_w, out_h, out_w)
    if plan is None:
        return _resize_passes(words, out_h, out_w)
    sv, tv, sh, th = _device_taps(in_h, in_w, out_h, out_w, dev)
    win_v, win_h = _device_windows(in_h, in_w, out_h, out_w, dev)
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    wide = in_w % 4 == 0 and words.data_ptr() % 16 == 0
    _build.check(_lib().timg_resize_words(
        ptr(words), b, in_h, in_w, ptr(sv), ptr(tv), plan.taps_v, out_h,
        ptr(sh), ptr(th), plan.taps_h, out_w, int(plan.vertical_first),
        plan.rows, plan.cols, ptr(win_v), ptr(win_h), plan.mid_n,
        plan.stage_n, int(wide), ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
        "resize_words")
    LAUNCHES += 1
    return out


def _resize_passes(words: torch.Tensor, out_h: int,
                   out_w: int) -> torch.Tensor:
    """The two-pass route (csrc/resize_passes.cu): one launch a pass, in
    the order ``vertical_first`` gives, through a bf16 [B, 3, H1, W1]
    intermediate allocated here.  Horizontal first (the geometries that
    reach this route), the first pass is the pass along rows."""
    global PASS_LAUNCHES
    b, in_h, in_w = words.shape
    dev = words.device
    sv, tv, sh, th = _device_taps(in_h, in_w, out_h, out_w, dev)
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    if vertical_first(in_h, in_w, out_h, out_w):
        mid = torch.empty((b, 3, out_h, in_w), dtype=torch.bfloat16,
                          device=dev)
        _build.check(lib.timg_resize_words_to_mid(
            ptr(words), b, in_h, in_w, ptr(sv), ptr(tv), tv.shape[1],
            _blocks(in_h, out_h, False), out_h, ptr(mid), stream),
            "resize_words_to_mid")
        _build.check(lib.timg_resize_mid_to_words(
            ptr(mid), b, out_h, in_w, ptr(sh), ptr(th), th.shape[1],
            _blocks(in_w, out_w, True), 0, out_w, ptr(out), stream),
            "resize_mid_to_words")
    else:
        taps16, dst, nb_max = _device_slot_taps(in_w, out_w, dev)
        mid = torch.empty((b, 3, in_h, out_w), dtype=torch.bfloat16,
                          device=dev)
        _build.check(lib.timg_resize_rows_to_mid(
            ptr(words), b, in_h, in_w, ptr(taps16), ptr(dst),
            taps16.shape[2], ptr(sh), th.shape[1], nb_max, out_w, ptr(mid),
            stream), "resize_rows_to_mid")
        _build.check(lib.timg_resize_mid_to_words(
            ptr(mid), b, in_h, out_w, ptr(sv), ptr(tv), tv.shape[1],
            _blocks(in_h, out_h, False), 1, out_h, ptr(out), stream),
            "resize_mid_to_words")
    PASS_LAUNCHES += 1
    return out
