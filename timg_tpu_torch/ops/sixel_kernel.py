"""Floyd-Steinberg cube dither: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of timg_tpu/ops/sixel_pallas3.py's cube
path).

``fs_dither_cube_fused`` replaces the TPU kernels ``fs_dither_cube_fused``
(K6) with its layout kernels ``_skewT`` (K3), ``_transpose_bwd`` (K4)
and ``_unskewT`` (K5): one CUDA launch (csrc/fs_dither_cube.cu) walks the
wavefront x = t - 2y directly, one block per frame and one thread per
row, bound by the latency of its w + 2(h-1) serial steps.

``fs_dither_cube_plain`` is the same wavefront in torch ops, mirroring
timg_tpu/ops/sixel_np.py:_wavefront_np step by step; the skew is a
strided view, so it runs unchanged on the CPU and on the card.
"""

from __future__ import annotations

import ctypes

import torch

from timg_tpu_torch.ops import _build
from timg_tpu_torch.ops.sixel import _CUBE_LEVELS, INV_STEPS, STEPS

LAUNCHES = 0   # CUDA kernel launches

_C7, _C5, _C3, _C1 = 7.0 / 16.0, 5.0 / 16.0, 3.0 / 16.0, 1.0 / 16.0

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.timg_fs_dither_cube.argtypes = [p, i, i, i, i, i, p, i, p]
        lib.timg_fs_dither_cube.restype = ctypes.c_int
        lib.timg_fs_dither_cube_max_rows.argtypes = []
        lib.timg_fs_dither_cube_max_rows.restype = ctypes.c_int
        _bound = lib
    return _bound


def _as_words(frames: torch.Tensor) -> torch.Tensor:
    """[B, H, W] int32 words, or [B, H, W, 4] uint8 RGBA viewed as words."""
    if frames.dim() == 4:
        if frames.dtype != torch.uint8 or frames.shape[-1] != 4:
            raise ValueError("4-D input must be [B, H, W, 4] uint8")
        return frames.contiguous().view(torch.int32).squeeze(-1)
    if frames.dim() != 3 or frames.dtype != torch.int32:
        raise ValueError("input must be [B, H, W] int32 RGBA words")
    return frames


def _skew(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., h, w] -> strided view [..., h, w + 2(h-1)] with
    ``S[..., y, t] = x[..., y, t - 2y]`` (0 outside 0 <= t - 2y < w).

    Rows are padded right by 2h and flattened; row y's step t then sits
    at flat offset y*(w + 2h - 2) + t, where out-of-row reads land in
    zero padding (of row y itself, or of row y-1 for t < 2y)."""
    lead = x.shape[:-2]
    pad = torch.zeros(lead + (h, w + 2 * h), dtype=x.dtype, device=x.device)
    pad[..., :w] = x
    n_steps = w + 2 * (h - 1)
    stride = pad.stride()
    return pad.as_strided(lead + (h, n_steps),
                          stride[:-2] + (w + 2 * h - 2, 1))


def fs_dither_cube_plain(frames: torch.Tensor, h: int, w: int,
                         out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch wavefront: [B, >=h, >=w] int32 words (or [B,H,W,4]
    uint8) -> [B, h, w] cube indices (uint8, or int32)."""
    words = _as_words(frames)[:, :h, :w]
    b = words.shape[0]
    dev = words.device
    planes = torch.stack([((words >> (8 * c)) & 0xFF).to(torch.float32)
                          for c in range(3)], dim=1)        # [B, 3, h, w]
    cols = _skew(planes, h, w)                              # [B, 3, h, T]
    out_buf = torch.zeros((b, h, w + 2 * h), dtype=torch.int32, device=dev)
    out_steps = out_buf.as_strided(
        (b, h, w + 2 * (h - 1)),
        (out_buf.stride(0), w + 2 * h - 2, 1))
    step = torch.tensor(STEPS, dtype=torch.float32, device=dev).view(1, 3, 1)
    inv = torch.tensor(INV_STEPS, dtype=torch.float32,
                       device=dev).view(1, 3, 1)
    _, lg, lb = _CUBE_LEVELS
    e1 = torch.zeros((b, 3, h), dtype=torch.float32, device=dev)
    e2 = torch.zeros_like(e1)
    e3 = torch.zeros_like(e1)
    for t in range(w + 2 * (h - 1)):
        # rows with 0 <= t - 2y < w form the contiguous range [lo, hi)
        lo, hi = max(0, (t - w + 2) // 2), min(h, t // 2 + 1)
        mix = e1 * _C3 + e2 * _C5 + e3 * _C1
        incoming = e1 * _C7
        incoming[:, :, 1:] += mix[:, :, :-1]
        v = torch.clamp(cols[..., t] + incoming, 0.0, 255.0)
        q = torch.round(v * step)
        err = v - torch.round(q * inv)
        err[:, :, :lo] = 0.0
        err[:, :, hi:] = 0.0
        qi = q.to(torch.int32)
        out_steps[..., t] = (qi[:, 0] * lg + qi[:, 1]) * lb + qi[:, 2]
        e3, e2, e1 = e2, e1, err
    out = out_buf[:, :, :w]
    return out.to(torch.uint8) if out_u8 else out.contiguous()


def fs_dither_cube_cuda(frames: torch.Tensor, h: int, w: int,
                        out_u8: bool = True) -> torch.Tensor:
    """The CUDA kernel: [B, >=h, >=w] int32 CUDA words -> [B, h, w]."""
    global LAUNCHES
    words = _as_words(frames)
    if not words.is_cuda:
        raise ValueError("fs_dither_cube_cuda takes a CUDA tensor")
    if words.stride(2) != 1 or words.stride(1) != words.shape[2] \
            or words.stride(0) != words.shape[1] * words.shape[2]:
        words = words.contiguous()
    b, ph, pw = words.shape
    if ph < h or pw < w:
        raise ValueError(f"words {tuple(words.shape)} smaller than {h}x{w}")
    lib = _lib()
    if h > lib.timg_fs_dither_cube_max_rows():
        raise ValueError(f"fs_dither_cube_cuda: h={h} exceeds "
                         f"{lib.timg_fs_dither_cube_max_rows()} rows")
    out = torch.empty((b, h, w), dtype=torch.uint8 if out_u8 else torch.int32,
                      device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    _build.check(lib.timg_fs_dither_cube(
        ctypes.c_void_p(words.data_ptr()), b, h, w, ph, pw,
        ctypes.c_void_p(out.data_ptr()), int(out_u8),
        ctypes.c_void_p(stream)), "fs_dither_cube")
    LAUNCHES += 1
    return out


def fs_dither_cube_fused(frames: torch.Tensor, h: int, w: int,
                         out_u8: bool = True) -> torch.Tensor:
    """[B, H, W] int32 RGBA words (or [B, H, W, 4] uint8), possibly
    padded beyond h x w, -> [B, h, w] cube-palette FS indices (uint8
    with ``out_u8``, else int32); the contract of
    timg_tpu/ops/sixel_pallas3.py:fs_dither_cube_fused.  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version."""
    if frames.is_cuda:
        return fs_dither_cube_cuda(frames, h, w, out_u8)
    return fs_dither_cube_plain(frames, h, w, out_u8)
