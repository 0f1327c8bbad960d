"""Wrappers of the CUDA run-record kernels (csrc/sixel_runs.cu).

Replace the device side of timg_tpu/ops/sixel_runs.py ``run_counts`` and
``compact_runs`` (XLA device ops in the reference; no Pallas kernel):
``band_run_counts`` writes the column-run count of each (frame, band),
``compact_runs`` the records at each band's scanned offset, in the
order of the reference's sort without a sort, and zeros to the end of
the output, so the records are allocated uninitialised.  Bound by
device-memory bytes on the H100.  The plain versions are in
ops/sixel_runs.py.
"""

from __future__ import annotations

import ctypes

import torch

from timg_tpu_torch.ops import _build

COUNT_LAUNCHES = 0     # band_run_counts launches
COMPACT_LAUNCHES = 0   # compact_runs launches

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.timg_band_run_counts.argtypes = [p, i, i, i, ll, ll, p, p]
        lib.timg_band_run_counts.restype = ctypes.c_int
        lib.timg_compact_runs.argtypes = [p, i, i, i, ll, ll, p, i, p, p]
        lib.timg_compact_runs.restype = ctypes.c_int
        _bound = lib
    return _bound


def check_planes(planes: torch.Tensor, h: int, w: int,
                 what: str) -> torch.Tensor:
    """Check [B, >=h, >=w] uint8 CUDA planes (w < 32768, as the records'
    x field needs; the DCS kernels take the same widths); rows made
    contiguous."""
    if not (planes.is_cuda and planes.dtype == torch.uint8
            and planes.dim() == 3 and planes.shape[1] >= h >= 1
            and planes.shape[2] >= w >= 1):
        raise ValueError(f"{what} takes [B, >=h, >=w] uint8 CUDA planes "
                         f"(h={h}, w={w}), got {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}")
    if w >= 1 << 15:
        raise ValueError(f"{what}: the transports require w < 32768")
    return planes if planes.stride(2) == 1 else planes.contiguous()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def band_run_counts_cuda(planes: torch.Tensor, h: int, w: int):
    """The kernel: [B, >=h, >=w] uint8 CUDA planes -> run counts a band,
    [B, nb] int32."""
    global COUNT_LAUNCHES
    planes = check_planes(planes, h, w, "band_run_counts_cuda")
    b = planes.shape[0]
    counts = torch.empty((b, (h + 5) // 6), dtype=torch.int32,
                         device=planes.device)
    if b:
        with torch.cuda.device(planes.device):
            _build.check(_lib().timg_band_run_counts(
                _ptr(planes), b, h, w, planes.stride(0), planes.stride(1),
                _ptr(counts), _stream(planes)), "band_run_counts")
        COUNT_LAUNCHES += 1
    return counts


def compact_records_cuda(planes: torch.Tensor, h: int, w: int,
                         counts: torch.Tensor, n: int) -> torch.Tensor:
    """The compaction kernel alone, given the planes' band counts (from
    ``band_run_counts_cuda``): records [B, n, 2] int32, zero past a
    frame's count, records at or past n dropped."""
    global COMPACT_LAUNCHES
    planes = check_planes(planes, h, w, "compact_records_cuda")
    b, nb = planes.shape[0], (h + 5) // 6
    if not (counts.is_cuda and counts.dtype == torch.int32
            and counts.shape == (b, nb) and counts.is_contiguous()):
        raise ValueError(f"compact_records_cuda takes [{b}, {nb}] int32 "
                         "CUDA band counts")
    if n < 0:
        raise ValueError(f"compact_records_cuda: n = {n} < 0")
    records = torch.empty((b, n, 2), dtype=torch.int32, device=planes.device)
    if b and n:
        with torch.cuda.device(planes.device):
            _build.check(_lib().timg_compact_runs(
                _ptr(planes), b, h, w, planes.stride(0), planes.stride(1),
                _ptr(counts), n, _ptr(records), _stream(planes)),
                "compact_runs")
        COMPACT_LAUNCHES += 1
    return records


def compact_runs_cuda(planes: torch.Tensor, h: int, w: int, cap: int):
    """The two kernels: (records [B, min(cap, nb * w), 2] int32, zero past
    a frame's count; band_counts [B, nb] int32)."""
    counts = band_run_counts_cuda(planes, h, w)
    n = min(cap, (h + 5) // 6 * w)
    return compact_records_cuda(planes, h, w, counts, n), counts
