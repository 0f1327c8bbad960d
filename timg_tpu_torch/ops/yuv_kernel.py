"""Wrapper of the CUDA 4:2:0 -> RGBA convert (csrc/yuv420.cu).

Replaces the device side of timg_tpu/ops/yuv.py ``yuv420_to_rgba_words``
(XLA in the reference, fused with the resize in one jit; no Pallas
kernel): one launch a window, each thread making 8 words of a row from
its Y bytes and the chroma columns they share.  Bound by device-memory
bytes on the H100 (1.5 B in, 4 B out a pixel).  The plain version is
``ops/yuv.yuv420_to_rgba_words_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from timg_tpu_torch.ops import _build

LAUNCHES = 0   # yuv420 convert launches (one per call)

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.timg_yuv420_to_rgba_words.argtypes = [p, p, p, i, i, i, i, i, i,
                                                  p, p]
        lib.timg_yuv420_to_rgba_words.restype = ctypes.c_int
        _bound = lib
    return _bound


def yuv420_to_rgba_words_cuda(y: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor,
                              full_range: bool) -> torch.Tensor:
    """The CUDA kernel: [B, H, W] y and [B, CH, CW] u, v uint8 CUDA
    planes (2 CH >= H, 2 CW >= W; the chroma clamps at the planes' own
    edges) -> [B, H, W] int32 RGBA words."""
    global LAUNCHES
    planes = (y, u, v)
    if not all(t.is_cuda and t.dtype == torch.uint8 and t.dim() == 3
               and t.device == y.device for t in planes) \
            or u.shape != v.shape or u.shape[0] != y.shape[0]:
        raise ValueError("yuv420_to_rgba_words_cuda takes [B, H, W] y and "
                         "[B, CH, CW] u, v uint8 planes on one CUDA device")
    b, h, w = y.shape
    ch, cw = u.shape[1], u.shape[2]
    if 2 * ch < h or 2 * cw < w:
        raise ValueError(f"chroma planes {ch}x{cw} do not cover a {h}x{w} "
                         "frame at half resolution")
    y, u, v = (t.contiguous() for t in planes)
    out = torch.empty((b, h, w), dtype=torch.int32, device=y.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(y.device):    # the C launch's current device
        _build.check(_lib().timg_yuv420_to_rgba_words(
            ptr(y), ptr(u), ptr(v), b, h, w, ch, cw, int(bool(full_range)),
            ptr(out), ctypes.c_void_p(torch.cuda.current_stream(
                y.device).cuda_stream)), "yuv420_to_rgba_words")
    LAUNCHES += 1
    return out
