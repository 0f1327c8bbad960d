"""Wrapper of the CUDA video resize kernel (csrc/resize_words.cu).

Replaces the TPU kernels of timg_tpu/ops/resize_pallas.py:
``resize_video_words_pallas`` (K1) and ``resize_video_words_pallas_tiled``
(K2).  One launch a resize: both separable passes in one tile kernel
whose bf16-rounded intermediate stays in shared memory, tiled as
``ops/resize.plan_tiles`` says; only the output is allocated here.
Bound by device-memory bytes on the H100 (see the source's note).  The
plain version is ``ops/resize.resize_video_words_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from timg_tpu_torch.ops import _build
from timg_tpu_torch.ops.resize import axis_taps, plan_tiles

LAUNCHES = 0   # kernel launches (one per resize)

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.timg_resize_words.argtypes = [p, i, i, i, p, p, i, i, p, p, i,
                                          i, i, i, i, p, p, i, i, i, p, p]
        lib.timg_resize_words.restype = ctypes.c_int
        _bound = lib
    return _bound


@functools.lru_cache(maxsize=16)
def _device_tables(in_h, in_w, out_h, out_w, dev):
    """(starts_v, taps_v, starts_h, taps_h, windows_v, windows_h) on
    ``dev``, copied from the host once per geometry and device."""
    plan = plan_tiles(in_h, in_w, out_h, out_w)
    host = (*axis_taps(in_h, out_h, False), *axis_taps(in_w, out_w, True),
            torch.from_numpy(plan.windows_v), torch.from_numpy(plan.windows_h))
    return tuple(t.to(dev).contiguous() for t in host)


def _given(table, out_size, taps, dev):
    starts, tap = table
    starts = starts.to(dev, torch.int32).contiguous()
    tap = tap.to(dev, torch.bfloat16).contiguous()
    if starts.shape != (out_size,) or tap.shape != (out_size, taps):
        raise ValueError("tap tables do not match the geometry's "
                         "axis_taps")
    return starts, tap


def resize_video_words_cuda(words: torch.Tensor, out_h: int, out_w: int,
                            taps_v=None, taps_h=None) -> torch.Tensor:
    """[B, H, W] int32 CUDA words -> [B, out_h, out_w] int32 words.

    ``taps_v``/``taps_h`` are the geometry's ``axis_taps`` already on the
    device (the video stage holds them as buffers); without them the
    wrapper's per-geometry device copies are used.  Only ``axis_taps``'
    own tables are accepted: the tiles' input windows are planned from
    them, and other starts would read outside a tile's staged window.
    Their shapes are checked, their values are not (that would wait on
    the device every call)."""
    global LAUNCHES
    if not words.is_cuda or words.dtype != torch.int32 or words.dim() != 3:
        raise ValueError("resize_video_words_cuda takes [B, H, W] int32 "
                         "CUDA words")
    words = words.contiguous()
    b, in_h, in_w = words.shape
    dev = words.device
    plan = plan_tiles(in_h, in_w, out_h, out_w)
    sv, tv, sh, th, win_v, win_h = _device_tables(in_h, in_w, out_h, out_w,
                                                  dev)
    if taps_v is not None:
        sv, tv = _given(taps_v, out_h, plan.taps_v, dev)
    if taps_h is not None:
        sh, th = _given(taps_h, out_w, plan.taps_h, dev)
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
