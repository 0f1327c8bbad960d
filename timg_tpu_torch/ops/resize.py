"""Lean video resize, word in / word out (counterpart of the
``resize_video_words`` path of timg_tpu/ops/resize.py).

The JAX package builds a dense [in, out] band matrix per axis from the
stb-exact packed taps (``_band_matrix_np``) and runs two bf16 einsums
with f32 accumulation.  The port carries that state across as compact
tap tables: ``band_taps`` turns each band matrix into ``starts [out]``
and ``taps [out, T]`` (bf16), so output o reads inputs
``starts[o] .. starts[o] + T - 1``.

Each product of two bf16 values is exact in f32, so only the order of
the f32 sums can make the bytes differ from the reference.  Both the
CUDA kernel (ops/resize_kernel.py) and the plain version below sum in
the order XLA:CPU's bf16 x bf16 -> f32 dot was measured to use, by
testing candidate orders against every f32 output of the dot: inputs
are cut into blocks of 32 by absolute index k; inside a block, even
and odd k go to two separate ascending sums; each block's
``even + odd`` is added to a running total.  Ascending order puts 1
word of 1080p -> 480x800 off by one.  The last row-and-column tile of
the dot's GEMM uses yet another order, so a sum there can still differ
in f32 (53 of 2,592,000 sums of the 1920 -> 800 pass at 3,240 rows);
that tile's rows move with the batch size, and at the shapes the tests
pin no such difference reaches the bytes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from timg_tpu.ops.resize_np import (STB_DOWNSAMPLE_FILTER,
                                    STB_UPSAMPLE_FILTER, packed_taps,
                                    plan_passes)

ORDER_BLOCK = 32   # inputs per block of the reference dot's sum order


@functools.lru_cache(maxsize=64)
def _band_matrix_np(in_size: int, out_size: int, horizontal: bool):
    """Dense [in, out] f32 tap matrix from the stb-exact packed taps
    (jax-free copy of timg_tpu/ops/resize.py:_band_matrix_np): taps that
    clamp onto the same edge input are summed here, before any bf16
    rounding."""
    up, down = STB_UPSAMPLE_FILTER, STB_DOWNSAMPLE_FILTER
    starts, coeffs = packed_taps(in_size, out_size, up, down, horizontal)
    m = np.zeros((in_size, out_size), np.float32)
    for o in range(out_size):
        for t in range(coeffs.shape[1]):
            c = coeffs[o, t]
            if c != 0.0:
                i = min(max(int(starts[o]) + t, 0), in_size - 1)
                m[i, o] += c
    return m


def band_taps(m_f32: np.ndarray):
    """[in, out] f32 band matrix -> (starts int32 [out], taps bf16
    [out, T]) with ``taps[o, t] == bf16(m[starts[o] + t, o])``.

    T is the widest nonzero band; a band narrower than T is padded with
    zero taps, and a start is moved left where needed so that
    ``starts[o] + T <= in`` (a zero product adds nothing to the sum)."""
    m_bf16 = torch.from_numpy(np.ascontiguousarray(m_f32.T)).to(
        torch.bfloat16)                                    # [out, in]
    nz = (m_bf16 != 0).numpy()
    in_size, out_size = m_f32.shape
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, in_size - 1 - nz[:, ::-1].argmax(axis=1), 0)
    T = max(1, int((last - first + 1).max()))
    starts = np.minimum(first, in_size - T).astype(np.int64)
    idx = torch.from_numpy(starts[:, None] + np.arange(T)[None, :])
    taps = torch.gather(m_bf16, 1, idx)
    return torch.from_numpy(starts.astype(np.int32)), taps


@functools.lru_cache(maxsize=64)
def axis_taps(in_size: int, out_size: int, horizontal: bool):
    """(starts, taps) on the CPU for one axis of the video resize."""
    return band_taps(_band_matrix_np(in_size, out_size, horizontal))


def vertical_first(in_h: int, in_w: int, out_h: int, out_w: int) -> bool:
    """Pass order, as the reference CPU path picks it (stb's cost table;
    timg_tpu/ops/resize.py:322-334)."""
    return plan_passes(in_h, in_w, out_h, out_w, STB_UPSAMPLE_FILTER,
                       STB_DOWNSAMPLE_FILTER, False)


def padded_plane_dims(out_h: int, out_w: int) -> tuple:
    """(oh_pad, ow_pad): rows to a 128 multiple, cols to a 256 multiple
    (the layout timg_tpu's Pallas resize emits for the fused dither)."""
    r = lambda x, m: (x + m - 1) // m * m
    return r(out_h, 128), r(out_w, 256)


def _apply_taps(x: torch.Tensor, dim: int, starts: torch.Tensor,
                taps: torch.Tensor) -> torch.Tensor:
    """Tap-major banded filter along ``dim`` of f32 ``x`` (values exact
    in bf16), summed in the reference dot's order (module docstring):
    per 32-input block, even and odd inputs in two ascending sums, the
    block's ``even + odd`` added to the running total."""
    tapf = taps.to(device=x.device, dtype=torch.float32)
    starts = starts.to(device=x.device, dtype=torch.int64)
    shape = [1] * x.dim()
    shape[dim] = -1
    total = even = odd = torch.zeros((), dtype=torch.float32,
                                     device=x.device)
    for t in range(tapf.shape[1]):
        k = starts + t
        if t:
            flush = (k % ORDER_BLOCK == 0).reshape(shape)
            total = torch.where(flush, total + (even + odd), total)
            even = torch.where(flush, 0.0, even)
            odd = torch.where(flush, 0.0, odd)
        term = x.index_select(dim, k) * tapf[:, t].reshape(shape)
        is_odd = (k % 2 == 1).reshape(shape)
        even = torch.where(is_odd, even, even + term)
        odd = torch.where(is_odd, odd + term, odd)
    return total + (even + odd)


def resize_video_words_plain(words: torch.Tensor, out_h: int, out_w: int,
                             taps_v=None, taps_h=None) -> torch.Tensor:
    """Plain PyTorch version: [B, H, W] int32 RGBA words ->
    [B, out_h, out_w] int32 words with alpha 255."""
    b, in_h, in_w = words.shape
    sv, tv = taps_v if taps_v is not None else axis_taps(in_h, out_h, False)
    sh, th = taps_h if taps_h is not None else axis_taps(in_w, out_w, True)
    planes = torch.stack([((words >> (8 * c)) & 0xFF).to(torch.float32)
                          for c in range(3)], dim=1)       # [B, 3, H, W]
    if vertical_first(in_h, in_w, out_h, out_w):
        x = _apply_taps(planes, 2, sv, tv)
        x = x.to(torch.bfloat16).to(torch.float32)
        x = _apply_taps(x, 3, sh, th)
    else:
        x = _apply_taps(planes, 3, sh, th)
        x = x.to(torch.bfloat16).to(torch.float32)
        x = _apply_taps(x, 2, sv, tv)
    v = torch.clamp(x + 0.5, 0.0, 255.0).to(torch.int32)
    return v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16) | -(1 << 24)


def resize_video_words(words: torch.Tensor, out_h: int, out_w: int,
                       taps_v=None, taps_h=None) -> torch.Tensor:
    """[B, H, W] int32 RGBA words -> [B, out_h, out_w] int32 words.

    A CUDA tensor goes through the hand-written kernel
    (ops/resize_kernel.py), a CPU tensor through the plain version.
    ``taps_v``/``taps_h`` are (starts, taps) tables already on the
    tensor's device (the video stage module holds them as buffers);
    they default to ``axis_taps`` for the geometry."""
    in_h, in_w = words.shape[1], words.shape[2]
    if (in_h, in_w) == (out_h, out_w):
        return words
    if words.is_cuda:
        from timg_tpu_torch.ops import resize_kernel
        return resize_kernel.resize_video_words_cuda(
            words, out_h, out_w, taps_v, taps_h)
    return resize_video_words_plain(words, out_h, out_w, taps_v, taps_h)
