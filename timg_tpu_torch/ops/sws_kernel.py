"""Wrapper of the CUDA swscale-bitexact resize (csrc/sws_yuv420.cu).

Replaces the device side of timg_tpu/ops/sws_resize.py
``sws_yuv420_to_rgba_words`` (XLA in the reference, no Pallas kernel):
one launch a window.  A block makes one strip of output columns and one
chunk of output rows of a frame from the 4:2:0 planes, each source row's
horizontal pass once into shared memory, with the filters and the tiling
of the geometry's plan (``ops/sws_resize.Plan``, ``Tiling``) and
libswscale's int32 arithmetic; the equal-size converter, a thread a
pixel pair.  The plan's tables and tiling go to the device once a
geometry and device and stay cached here; no caller passes tables.  The
plain version is ``ops/sws_resize.sws_yuv420_to_rgba_words_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from timg_tpu_torch.ops import _build

LAUNCHES = 0   # sws resize launches (one per call)

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.timg_sws_yuv420_to_rgba_words.argtypes = [
            p, p, p, i, i, i, i, i, i, i, i, p, p, i, p, p, i, p, p, i, p, p,
            i, i, i, i, p, p, p, p, p, p, p, p]
        lib.timg_sws_yuv420_to_rgba_words.restype = ctypes.c_int
        _bound = lib
    return _bound


@functools.lru_cache(maxsize=16)
def _device_tables(plan, dev) -> tuple:
    """The plan's eight tables on ``dev``, int32 and contiguous: luma
    and chroma horizontal (first source column, coefficients), luma and
    chroma vertical (first source row, coefficients); then its tiling's
    strips, steps, chunk starts and output rows' ring slots.  Every tap
    must lie inside its plane, which the kernel does not check."""
    pairs = ((plan.h_lum_idx, plan.src_w), (plan.h_chr_idx, plan.chr_src_w),
             (plan.v_lum_idx, plan.src_h), (plan.v_chr_idx, plan.chr_src_h))
    for idx, size in pairs:
        if idx.min() < 0 or idx.max() >= size:
            raise ValueError("an sws filter tap lies outside its plane")
    tiling = plan.tiling
    host = (plan.h_lum_pos, plan.h_lum_coef, plan.h_chr_pos,
            plan.h_chr_coef, plan.v_lum_pos, plan.v_lum_coef,
            plan.v_chr_pos, plan.v_chr_coef, tiling.strips, tiling.steps,
            tiling.chunk_steps, tiling.slots)
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(dev)
                 for t in host)


def sws_yuv420_to_rgba_words_cuda(y: torch.Tensor, u: torch.Tensor,
                                  v: torch.Tensor, plan) -> torch.Tensor:
    """The CUDA kernel: [B, H, W] y and [B, CH, CW] u, v uint8 CUDA
    planes (CH >= ceil(H / 2), CW >= ceil(W / 2)) with the plan of
    their geometry (``ops/sws_resize.get_plan``) -> [B, dst_h, dst_w]
    int32 RGBA words."""
    global LAUNCHES
    planes = (y, u, v)
    if not all(t.is_cuda and t.dtype == torch.uint8 and t.dim() == 3
               and t.device == y.device for t in planes) \
            or u.shape != v.shape or u.shape[0] != y.shape[0]:
        raise ValueError("sws_yuv420_to_rgba_words_cuda takes [B, H, W] y "
                         "and [B, CH, CW] u, v uint8 planes on one CUDA "
                         "device")
    b, h, w = y.shape
    ch, cw = u.shape[1], u.shape[2]
    if (w, h) != (plan.src_w, plan.src_h) or ch < plan.chr_src_h \
            or cw < plan.chr_src_w:
        raise ValueError(f"planes {h}x{w} (chroma {ch}x{cw}) do not match "
                         f"the plan's {plan.src_h}x{plan.src_w}")
    y, u, v = (t.contiguous() for t in planes)
    out = torch.empty((b, plan.dst_h, plan.dst_w), dtype=torch.int32,
                      device=y.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    null = ctypes.c_void_p(0)
    tile = (ctypes.c_int * 16)()
    if plan.unscaled:
        tables = [null] * 12
    else:
        tables = [ptr(t) for t in _device_tables(plan, y.device)]
        tile[:] = plan.tiling.params()
    hp, hc, cp, cc, vp, vc, vcp, vcc, strips, steps, chunks, slots = tables
    consts = (ctypes.c_int * 6)(*plan.constants())
    fl, fc = plan.h_lum_coef.shape[1], plan.h_chr_coef.shape[1]
    with torch.cuda.device(y.device):    # the C launch's current device
        _build.check(_lib().timg_sws_yuv420_to_rgba_words(
            ptr(y), ptr(u), ptr(v), b, h, w, ch, cw, plan.dst_h, plan.dst_w,
            plan.chr_dst_w, hp, hc, fl, cp, cc, fc, vp, vc, plan.v_lum_size,
            vcp, vcc, plan.v_chr_size, plan.template, int(plan.full_chroma),
            int(plan.unscaled), consts, tile, strips, steps, chunks, slots,
            ptr(out), ctypes.c_void_p(
                torch.cuda.current_stream(y.device).cuda_stream)),
            "sws_yuv420_to_rgba_words")
    LAUNCHES += 1
    return out
