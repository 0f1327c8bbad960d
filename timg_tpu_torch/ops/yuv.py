"""YUV 4:2:0 -> RGBA words (counterpart of timg_tpu/ops/yuv.py, whose
device version is plain XLA, not a kernel): a CUDA tensor goes through
the hand-written kernel (ops/yuv_kernel.py, csrc/yuv420.cu), a CPU
tensor through the plain version in torch integer ops below.

BT.601 in 16-bit fixed point with interstitial 2x chroma upsampling:

    out[2i]   = (3*c[i] + c[i-1] + 2) >> 2      (c[-1] edge-clamped)
    out[2i+1] = (3*c[i] + c[i+1] + 2) >> 2      (c[n]  edge-clamped)

All arithmetic is int32 and every value stays non-negative before the
``>>`` except ``x + half`` in ``fin``, where torch's arithmetic shift
matches jnp's, so the words are bit-identical on every device.
"""

from __future__ import annotations

import torch

from timg_tpu_torch.ops import yuv_kernel

# BT.601 coefficients in 16-bit fixed point (timg_tpu/ops/yuv.py:38-42).
_LIM = dict(cy=76309, crv=104597, cgu=25675, cgv=53279, cbu=132201)
_FULL = dict(cy=65536, crv=91881, cgu=22554, cgv=46802, cbu=116130)


def _upsample2(c: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    n = c.shape[dim]
    prev = torch.cat([c.narrow(dim, 0, 1), c.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([c.narrow(dim, 1, n - 1), c.narrow(dim, n - 1, 1)], dim)
    even = (3 * c + prev + 2) >> 2
    odd = (3 * c + nxt + 2) >> 2
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(c.shape)
    shape[dim] *= 2
    return out.reshape(shape).narrow(dim, 0, out_size)


def yuv420_to_rgba_words_plain(y: torch.Tensor, u: torch.Tensor,
                               v: torch.Tensor,
                               full_range: bool) -> torch.Tensor:
    """Plain PyTorch version: [B,H,W] y + [B,ceil(H/2),ceil(W/2)] u/v
    uint8 -> [B,H,W] int32 RGBA-packed words (alpha 255).  The chroma
    upsample clamps at the planes' own edges, then keeps H rows and W
    columns."""
    h, w = y.shape[-2], y.shape[-1]
    k = _FULL if full_range else _LIM
    nd = y.dim()
    uu = _upsample2(_upsample2(u.to(torch.int32), nd - 2, h), nd - 1, w)
    vv = _upsample2(_upsample2(v.to(torch.int32), nd - 2, h), nd - 1, w)
    yc = y.to(torch.int32) - (0 if full_range else 16)
    d = uu - 128
    e = vv - 128
    half = 1 << 15

    def fin(x):
        return torch.clamp((x + half) >> 16, 0, 255)

    r = fin(k["cy"] * yc + k["crv"] * e)
    g = fin(k["cy"] * yc - k["cgu"] * d - k["cgv"] * e)
    b = fin(k["cy"] * yc + k["cbu"] * d)
    return r | (g << 8) | (b << 16) | -(1 << 24)


def yuv420_to_rgba_words(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         full_range: bool) -> torch.Tensor:
    """[B,H,W] y + [B,ceil(H/2),ceil(W/2)] u/v uint8 -> [B,H,W] int32
    RGBA-packed words (alpha 255); the contract of
    timg_tpu/ops/yuv.py:yuv420_to_rgba_words.  A CUDA tensor launches the
    kernel, a CPU tensor runs the plain version."""
    if y.is_cuda:
        return yuv_kernel.yuv420_to_rgba_words_cuda(y, u, v, full_range)
    return yuv420_to_rgba_words_plain(y, u, v, full_range)
