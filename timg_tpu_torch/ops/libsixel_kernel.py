"""libsixel-mode dither: the bucket-table build and the integer FS
wavefront, each a CUDA kernel's wrapper beside its plain PyTorch version
(counterpart of the libsixel path of timg_tpu/ops/sixel_pallas3.py).

``build_bucket_tables`` replaces ``build_bucket_tables_device`` (XLA in
the reference, no Pallas kernel): per frame, the nearest palette index
of each 15-bit bucket's base color, first minimum winning
(csrc/bucket_tables.cu).  ``fs_dither_table_fused`` replaces
``fs_dither_table_fused`` (K8) with its layout kernels: libsixel's
integer error diffusion, the index looked up in the frame's table
(csrc/fs_dither_table.cu).  The numpy specification of both is
timg_tpu/ops/libsixel_quant.py (``build_bucket_table``,
``apply_palette_bucket_table``).

The TPU kernel took the tables as [64, B, 128] packed words
(``pack_libsixel_tables``), a layout for its lane gather; here they are
[B, 32768] uint8, palettes [B, 256] int32 ``0xRRGGBB`` words and
diffuse flags [B] int32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from timg_tpu_torch.ops import _build
from timg_tpu_torch.ops.sixel_kernel import (_as_words, _pitched_words,
                                             wavefront_plain, word_planes)

BUCKET_LAUNCHES = 0   # bucket_tables launches
TABLE_LAUNCHES = 0    # fs_dither_table launches

N_BUCKETS = 1 << 15
PALETTE_SIZE = 256
_KEY_CHUNK = 2048     # keys per [B, chunk, 256] distance block (plain)

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.timg_bucket_tables.argtypes = [p, i, p, p]
        lib.timg_bucket_tables.restype = ctypes.c_int
        lib.timg_fs_dither_table.argtypes = [p, i, i, i, i, i, p, p, p, p,
                                             i, p]
        lib.timg_fs_dither_table.restype = ctypes.c_int
        _bound = lib
    return _bound


def bucket_bases(device=None) -> torch.Tensor:
    """[32768, 3] int32: each 15-bit bucket's base color (bits << 3)."""
    k = torch.arange(N_BUCKETS, dtype=torch.int32, device=device)
    return torch.stack([((k >> 10) & 0x1F) << 3, ((k >> 5) & 0x1F) << 3,
                        (k & 0x1F) << 3], dim=1)


def palette_words(pals: torch.Tensor) -> torch.Tensor:
    """[B, 256, 3] int palettes -> [B, 256] int32 ``0xRRGGBB`` words."""
    p = pals.to(torch.int32)
    return (p[..., 0] << 16) | (p[..., 1] << 8) | p[..., 2]


def pad_palettes(pals: list) -> np.ndarray:
    """Per-frame [n <= 256, 3] uint8 palettes -> [B, 256, 3] int32, the
    tail repeating the first color (as timg_tpu's video window does, so
    the first-minimum argmin never picks a tail entry)."""
    return np.stack([
        np.vstack([p, np.repeat(p[:1], PALETTE_SIZE - len(p), 0)]).astype(
            np.int32) for p in pals])


def build_bucket_tables_plain(pals: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, 256, 3] int palettes -> [B, 32768] uint8.

    Integer squared distances in chunks of keys (the whole [B, 32768,
    256] block is gigabytes at B=32); ``torch.argmin`` returns the first
    minimal index, which is libsixel's strict-< rule."""
    pals = pals.to(torch.int32)
    out = torch.empty((pals.shape[0], N_BUCKETS), dtype=torch.uint8,
                      device=pals.device)
    bases = bucket_bases(pals.device)
    for k0 in range(0, N_BUCKETS, _KEY_CHUNK):
        d = bases[None, k0:k0 + _KEY_CHUNK, None, :] - pals[:, None, :, :]
        dist = (d * d).sum(dim=3)                          # [B, chunk, 256]
        out[:, k0:k0 + _KEY_CHUNK] = dist.argmin(dim=2).to(torch.uint8)
    return out


def build_bucket_tables_cuda(pals: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: [B, 256, 3] int32 CUDA palettes -> [B, 32768]
    uint8 tables."""
    global BUCKET_LAUNCHES
    if not pals.is_cuda or pals.dim() != 3 \
            or tuple(pals.shape[1:]) != (PALETTE_SIZE, 3):
        raise ValueError("build_bucket_tables_cuda takes [B, 256, 3] CUDA "
                         "palettes")
    pals = pals.to(torch.int32).contiguous()
    b = pals.shape[0]
    out = torch.empty((b, N_BUCKETS), dtype=torch.uint8, device=pals.device)
    stream = torch.cuda.current_stream(pals.device).cuda_stream
    _build.check(_lib().timg_bucket_tables(
        ctypes.c_void_p(pals.data_ptr()), b, ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(stream)), "bucket_tables")
    BUCKET_LAUNCHES += 1
    return out


def build_bucket_tables(pals: torch.Tensor) -> torch.Tensor:
    """[B, 256, 3] palettes -> [B, 32768] uint8 nearest-index tables; the
    contract of timg_tpu/ops/sixel_pallas3.py:build_bucket_tables_device.
    A CUDA tensor launches the kernel, a CPU tensor runs the plain
    version."""
    if pals.is_cuda:
        return build_bucket_tables_cuda(pals)
    return build_bucket_tables_plain(pals)


def _trunc16(off: torch.Tensor, num: int) -> torch.Tensor:
    """C's ``off * num / 16``: division truncating toward zero."""
    return torch.div(off * num, 16, rounding_mode="trunc")


def fs_dither_table_plain(frames: torch.Tensor, tables: torch.Tensor,
                          pal_words: torch.Tensor, diffuse: torch.Tensor,
                          h: int, w: int, out_u8: bool = True
                          ) -> torch.Tensor:
    """Plain PyTorch integer wavefront (libsixel_quant
    .apply_palette_bucket_table, all frames at once): [B, >=h, >=w] int32
    words -> [B, h, w] palette indices.

    The carries are raw int32 offsets (pixel - palette color) of the
    last three steps.  Row y at step t takes from row y-1 the offsets of
    steps t-3, t-2, t-1 (its pixels x-1, x, x+1) and its own of step t-1
    (x-1), added in source-raster order, each truncated and followed by
    a clamp to [0, 255]: 1/16, 5/16, 3/16, 7/16."""
    words = _as_words(frames)
    dev = words.device
    tables = tables.to(dev, torch.int64)
    pal_words = pal_words.to(dev, torch.int64)
    keep = (diffuse.to(dev) != 0).view(-1, 1, 1)

    def step(col, carry, lo, hi):
        o1, o2, o3 = carry
        v = col
        for off, num in ((o3, 1), (o2, 5), (o1, 3)):
            up = torch.zeros_like(off)
            up[:, :, 1:] = off[:, :, :-1]
            v = torch.clamp(v + _trunc16(up, num), 0, 255)
        v = torch.clamp(v + _trunc16(o1, 7), 0, 255)
        key = ((v[:, 0] >> 3) << 10) | ((v[:, 1] >> 3) << 5) | (v[:, 2] >> 3)
        idx = tables.gather(1, key.to(torch.int64))
        palw = pal_words.gather(1, idx)
        color = torch.stack([(palw >> s) & 0xFF for s in (16, 8, 0)], dim=1)
        off = torch.where(keep, v - color.to(torch.int32), 0)
        off[:, :, :lo] = 0
        off[:, :, hi:] = 0
        return idx.to(torch.int32), (off, o1, o2)

    return wavefront_plain(word_planes(words, h, w, torch.int32), step, 3,
                           out_u8)


def fs_dither_table_cuda(frames: torch.Tensor, tables: torch.Tensor,
                         pal_words: torch.Tensor, diffuse: torch.Tensor,
                         h: int, w: int, out_u8: bool = True
                         ) -> torch.Tensor:
    """The CUDA kernel: [B, >=h, >=w] int32 CUDA words, [B, 32768] uint8
    tables, [B, 256] int32 palette words, [B] diffuse flags -> [B, h, w]
    indices."""
    global TABLE_LAUNCHES
    words = _pitched_words(frames, h, w, "fs_dither_table_cuda")
    b, ph, pw = words.shape
    dev = words.device
    tables = tables.to(dev, torch.uint8).contiguous()
    pal_words = pal_words.to(dev, torch.int32).contiguous()
    diffuse = diffuse.to(dev, torch.int32).contiguous()
    if tuple(tables.shape) != (b, N_BUCKETS) \
            or tuple(pal_words.shape) != (b, PALETTE_SIZE) \
            or tuple(diffuse.shape) != (b,):
        raise ValueError("fs_dither_table_cuda: tables [B, 32768], palette "
                         "words [B, 256] and diffuse flags [B] must match "
                         "the batch")
    out = torch.empty((b, h, w), dtype=torch.uint8 if out_u8 else torch.int32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    _build.check(_lib().timg_fs_dither_table(
        ptr(words), b, h, w, ph, pw, ptr(tables), ptr(pal_words),
        ptr(diffuse), ptr(out), int(out_u8), ctypes.c_void_p(stream)),
        "fs_dither_table")
    TABLE_LAUNCHES += 1
    return out


def fs_dither_table_fused(frames: torch.Tensor, tables: torch.Tensor,
                          pal_words: torch.Tensor, diffuse: torch.Tensor,
                          h: int, w: int, out_u8: bool = True
                          ) -> torch.Tensor:
    """[B, H, W] int32 RGBA words, possibly padded beyond h x w, ->
    [B, h, w] libsixel-mode FS indices; the contract of
    timg_tpu/ops/sixel_pallas3.py:fs_dither_table_fused with unpacked
    tables.  A CUDA tensor launches the kernel, a CPU tensor runs the
    plain version."""
    if frames.is_cuda:
        return fs_dither_table_cuda(frames, tables, pal_words, diffuse, h, w,
                                    out_u8)
    return fs_dither_table_plain(frames, tables, pal_words, diffuse, h, w,
                                 out_u8)
