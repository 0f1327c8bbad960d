"""Wrappers of the CUDA DCS kernels (csrc/sixel_dcs.cu).

Replace the device side of timg_tpu/ops/sixel_dcs.py ``plan_device``,
``layout_device`` and ``emit_device`` (XLA device ops in the reference,
under ``batch_band_lens`` and ``batch_encode``; no Pallas kernel): one
block a (frame, band) lists the band's colours from a 256-bit presence
set, builds their mask rows a tile of columns at a time, and one warp a
listed colour walks its row 32 columns a step (ballots, no block
barrier inside a walk) to count (``dcs_band_lens``) or write
(``dcs_emit``, which walks twice: sizes, then bytes) its DCS body bytes.
``dcs_emit`` writes every byte of the band buffers, zero tails included,
so they are allocated with ``torch.empty``.  The functions are bound by
integer operations on the H100: a pixel's presence and mask bits, then a
listed colour and column's start compare and byte count.  Shared memory
does not grow with w, so the kernels take every w < 32768.  The plain
versions are in ops/sixel_dcs.py.
"""

from __future__ import annotations

import ctypes

import torch

from timg_tpu_torch.ops import _build, sixel_runs_kernel

LENS_LAUNCHES = 0   # dcs_band_lens launches
EMIT_LAUNCHES = 0   # dcs_emit launches

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.timg_dcs_band_lens.argtypes = [p, i, i, i, ll, ll, p, p, p]
        lib.timg_dcs_band_lens.restype = ctypes.c_int
        lib.timg_dcs_emit.argtypes = [p, i, i, i, ll, ll, i, p, p, p]
        lib.timg_dcs_emit.restype = ctypes.c_int
        _bound = lib
    return _bound


def _planes(planes: torch.Tensor, h: int, w: int, color_cap: int,
            what: str) -> torch.Tensor:
    planes = sixel_runs_kernel.check_planes(planes, h, w, what)
    if color_cap != 64:
        raise ValueError(f"{what}: the kernel lists 64 colours a band")
    return planes


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dcs_band_lens_cuda(planes: torch.Tensor, h: int, w: int,
                       color_cap: int = 64):
    """The kernel: [B, >=h, >=w] uint8 CUDA planes -> (band_lens,
    colour counts), each [B, nb] int32."""
    global LENS_LAUNCHES
    planes = _planes(planes, h, w, color_cap, "dcs_band_lens_cuda")
    b, nb = planes.shape[0], (h + 5) // 6
    lens = torch.empty((b, nb), dtype=torch.int32, device=planes.device)
    counts = torch.empty_like(lens)
    if b:
        with torch.cuda.device(planes.device):
            _build.check(_lib().timg_dcs_band_lens(
                _ptr(planes), b, h, w, planes.stride(0), planes.stride(1),
                _ptr(lens), _ptr(counts), _stream(planes)), "dcs_band_lens")
        LENS_LAUNCHES += 1
    return lens, counts


def dcs_emit_cuda(planes: torch.Tensor, h: int, w: int, color_cap: int,
                  cap: int):
    """The kernel: (bands [B, nb, cap] uint8, zero past each band's
    length, every byte written by the kernel; band_lens [B, nb] int32)."""
    global EMIT_LAUNCHES
    planes = _planes(planes, h, w, color_cap, "dcs_emit_cuda")
    b, nb = planes.shape[0], (h + 5) // 6
    bands = torch.empty((b, nb, cap), dtype=torch.uint8,
                        device=planes.device)
    lens = torch.empty((b, nb), dtype=torch.int32, device=planes.device)
    if b:
        with torch.cuda.device(planes.device):
            _build.check(_lib().timg_dcs_emit(
                _ptr(planes), b, h, w, planes.stride(0), planes.stride(1),
                cap, _ptr(bands), _ptr(lens), _stream(planes)), "dcs_emit")
        EMIT_LAUNCHES += 1
    return bands, lens
