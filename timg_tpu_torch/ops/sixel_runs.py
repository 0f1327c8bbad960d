"""Device->host transport of dither planes (counterpart of
timg_tpu/ops/sixel_runs.py).

The sixel video path dithers index planes on the device.  Per window the
transport ships one of three things, whichever costs least (the JAX
package's rules, op for op):
- run records: per sixel band (6 rows), adjacent equal columns collapse
  into one 8-byte record, 17-120x fewer bytes than the plane on flat, UI
  and film content; the C assembler (timg_sixel_encode_runs) writes the
  stream from them;
- device-emitted DCS bytes (ops/sixel_dcs.py): the host only splices the
  band slices, with no assembly leg;
- the plane, [h, w] uint8, the fallback.
``TIMG_TPU_SIXEL_TRANSPORT`` = auto (default) | plane | runs | dcs picks
one.  The transport never changes the stream's bytes.

Record layout (2 x int32 little-endian words per run):
  word0 = c0 | c1<<8 | c2<<16 | c3<<24     (band rows 0-3 palette idx)
  word1 = c4 | c5<<8 | x<<16               (rows 4-5, start column)
Rows past the image height (h % 6 pad of the last band) are zeroed.
Records are ordered band-major then by x; per-band counts ship
alongside ([nb] int32 per frame), so run lengths are next.x - x (the
band's last run extends to w).  Records past a frame's run count are 0.

A CUDA tensor goes to the hand kernels (ops/sixel_runs_kernel.py,
csrc/sixel_runs.cu), a CPU tensor to the plain PyTorch versions below.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from timg_tpu_torch import tracing
from timg_tpu_torch.ops import sixel_dcs, sixel_runs_kernel

_BIG = 2 ** 30


class SixelRuns(NamedTuple):
    """Host-side compact representation of one frame's index plane."""
    records: np.ndarray      # [n, 2] int32 (only the first sum(counts) used)
    band_counts: np.ndarray  # [nb] int32
    h: int
    w: int


def _column_words(planes: torch.Tensor, h: int, w: int):
    """[B, >=h, >=w] u8 planes -> per-band column words [B, nb, w] i32
    (built in int64 and wrapped, as the JAX package's int32 shifts wrap
    ``c3 << 24``)."""
    nb = (h + 5) // 6
    x = planes[:, :h, :w].to(torch.int64)
    pad = nb * 6 - h
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    r = x.reshape(x.shape[0], nb, 6, w)
    w0 = (r[:, :, 0] | (r[:, :, 1] << 8) | (r[:, :, 2] << 16)
          | (r[:, :, 3] << 24))
    w1 = r[:, :, 4] | (r[:, :, 5] << 8)
    return w0.to(torch.int32), w1.to(torch.int32)


def _start_mask(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    change = (w0[:, :, 1:] != w0[:, :, :-1]) | (w1[:, :, 1:] != w1[:, :, :-1])
    ones = torch.ones(w0.shape[:2] + (1,), dtype=torch.bool,
                      device=w0.device)
    return torch.cat([ones, change], dim=2)          # [B, nb, w]


def band_run_counts_plain(planes: torch.Tensor, h: int, w: int):
    """Plain version: column-run count per band, [B, nb] int32."""
    w0, w1 = _column_words(planes, h, w)
    return _start_mask(w0, w1).sum(dim=2, dtype=torch.int32)


def compact_runs_plain(planes: torch.Tensor, h: int, w: int, cap: int):
    """Plain version of ``compact_runs``: the JAX package's sort keyed on
    the flat position (stable here), records past the count zeroed."""
    if w >= (1 << 15):
        raise ValueError("run transport requires w < 32768")
    w0, w1 = _column_words(planes, h, w)
    b = w0.shape[0]
    start = _start_mask(w0, w1)
    flat = start.reshape(b, -1)
    pos = torch.arange(flat.shape[1], dtype=torch.int32, device=flat.device)
    key = torch.where(flat, pos, _BIG)
    xcoord = torch.arange(w, dtype=torch.int32, device=flat.device)
    rec1 = (w1 | (xcoord << 16)).reshape(b, -1)
    order = torch.sort(key, dim=1, stable=True).indices[:, :cap]
    records = torch.stack([torch.gather(w0.reshape(b, -1), 1, order),
                           torch.gather(rec1, 1, order)], dim=-1)
    band_counts = start.sum(dim=2, dtype=torch.int32)
    n = band_counts.sum(dim=1)
    keep = torch.arange(records.shape[1], device=n.device)[None] < n[:, None]
    return torch.where(keep[..., None], records, 0), band_counts


def compact_records_plain(planes: torch.Tensor, h: int, w: int, n: int):
    """Plain version of ``compact_records``: ``compact_runs_plain``'s
    records cut or zero-padded to [B, n, 2]."""
    records = compact_runs_plain(planes, h, w, n)[0]
    return torch.nn.functional.pad(records, (0, 0, 0, n - records.shape[1]))


def band_run_counts(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Column-run count per band, [B, nb] int32, on the planes' device
    (the kernel on CUDA)."""
    if planes.is_cuda:
        return sixel_runs_kernel.band_run_counts_cuda(planes, h, w)
    return band_run_counts_plain(planes, h, w)


def run_counts(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Total column-run count per frame, [B] int32: the cheap dense pass
    of the transport decision (timg_tpu/ops/sixel_runs.py:77)."""
    return band_run_counts(planes, h, w).sum(dim=1, dtype=torch.int32)


def compact_runs(planes: torch.Tensor, h: int, w: int, cap: int):
    """Compact column runs of [B, >=h, >=w] u8 planes: (records [B,
    min(cap, nb * w), 2] int32, band_counts [B, nb] int32).  A frame with
    more than ``cap`` runs is truncated; callers check the counts first
    (timg_tpu/ops/sixel_runs.py:86)."""
    if planes.is_cuda:
        return sixel_runs_kernel.compact_runs_cuda(planes, h, w, cap)
    return compact_runs_plain(planes, h, w, cap)


def compact_records(planes: torch.Tensor, h: int, w: int,
                    counts: torch.Tensor, n: int) -> torch.Tensor:
    """The compaction given the planes' band counts (``band_run_counts``
    on the same planes, on their device): records [B, n, 2] int32, zero
    past a frame's count, records at or past n dropped.  The
    transport's second step: it reuses the decision's counts."""
    if planes.is_cuda:
        return sixel_runs_kernel.compact_records_cuda(planes, h, w, counts, n)
    return compact_records_plain(planes, h, w, n)


def default_cap(h: int, w: int) -> int:
    """Record capacity bounding the transport at half the plane bytes
    (8 B/record), padded to the lane width for clean slicing."""
    cap = max((h * w) // 16, 256)
    return (cap + 127) // 128 * 128


def _bucket(n: int, cap: int) -> int:
    """Round a record count up to a power-of-two slice length (the JAX
    package's D2H slice shapes; kept so the bytes shipped are its)."""
    b = 128
    while b < n:
        b *= 2
    return min(b, cap)


# Transport accounting of the process (frames moved, bytes shipped vs the
# plane-equivalent bytes), read by the CLI's --verbose report (the JAX
# package's counters, same keys).
STATS = {"frames_runs": 0, "frames_plane": 0, "frames_dcs": 0,
         "bytes_shipped": 0, "bytes_plane_equiv": 0}

# Session-sticky DCS verdict (as the JAX package's): None = not yet
# timed; True/False after the first qualifying window in auto mode races
# the DCS emit, fetch and splice against the plane fetch and assembly.
_DCS_FASTER = None


def _host(t: torch.Tensor) -> np.ndarray:
    with tracing.span("window.fetch", t.nbytes):
        return t.cpu().numpy()


def fetch_planes_or_runs(planes_dev: torch.Tensor, n_frames: int, h: int,
                         w: int) -> list:
    """Transport decision for device-resident dither planes
    (timg_tpu/ops/sixel_runs.py:168): a list of n_frames host [h, w]
    uint8 planes, SixelRuns or SixelDcs, with the JAX package's rules and
    STATS accounting."""
    global _DCS_FASTER
    mode = os.environ.get("TIMG_TPU_SIXEL_TRANSPORT", "auto")
    if mode not in ("auto", "plane", "runs", "dcs"):
        mode = "auto"
    nb = (h + 5) // 6
    planes_dev = planes_dev[:n_frames]
    if mode in ("auto", "runs") and w < (1 << 15):
        # one counts launch a window: the decision's band counts also
        # place the records, and ship beside them
        band_counts_dev = band_run_counts(planes_dev, h, w)
        band_counts = _host(band_counts_dev)
        counts = band_counts.sum(axis=1)
        cap = default_cap(h, w)
        rec_bytes = 8 * int(counts.sum()) + 4 * nb * n_frames
        use_runs = (int(counts.max()) <= cap
                    and (mode == "runs"
                         or 2 * rec_bytes <= h * w * n_frames))
        if use_runs:
            # the JAX package's slice, [:, :keep] of [B, min(cap, nb w)]
            keep = min(_bucket(int(counts.max()), cap), nb * w)
            records = _host(compact_records(planes_dev, h, w,
                                            band_counts_dev, keep))
            STATS["frames_runs"] += n_frames
            STATS["bytes_shipped"] += records.nbytes + band_counts.nbytes
            STATS["bytes_plane_equiv"] += h * w * n_frames
            return [SixelRuns(records[i, :counts[i]], band_counts[i], h, w)
                    for i in range(n_frames)]
    if mode in ("auto", "dcs") and (_DCS_FASTER is not False
                                    or mode == "dcs"):
        lens, ccounts = sixel_dcs.batch_band_lens(planes_dev, n_frames, h, w)
        lens, ccounts = _host(lens), _host(ccounts)
        cap = sixel_dcs.bucket_cap(int(lens.max()) if lens.size else 1)
        ship = nb * cap * n_frames
        use_dcs = (int(ccounts.max()) <= sixel_dcs.COLOR_CAP
                   and (mode == "dcs" or ship <= h * w * n_frames))
        if use_dcs:
            bands, lens_d = sixel_dcs.batch_encode(planes_dev, n_frames, h,
                                                   w, cap)
            bands, lens_d = _host(bands), _host(lens_d)
            if mode == "auto" and _DCS_FASTER is None:
                _DCS_FASTER = _dcs_race(planes_dev, n_frames, h, w, cap)
                use_dcs = _DCS_FASTER
            if use_dcs:
                STATS["frames_dcs"] += n_frames
                STATS["bytes_shipped"] += bands.nbytes + lens_d.nbytes
                STATS["bytes_plane_equiv"] += h * w * n_frames
                return [sixel_dcs.SixelDcs(bands[i], lens_d[i], h, w)
                        for i in range(n_frames)]
    full = _host(planes_dev[:, :h, :w])
    STATS["frames_plane"] += n_frames
    STATS["bytes_shipped"] += h * w * n_frames
    STATS["bytes_plane_equiv"] += h * w * n_frames
    return [np.ascontiguousarray(full[i]) for i in range(n_frames)]


def _dcs_race(planes_dev: torch.Tensor, n_frames: int, h: int, w: int,
              cap: int) -> bool:
    """The first qualifying auto window (timg_tpu/ops/sixel_runs.py:
    230-264): a warm DCS emit and fetch plus the band splice of frame 0
    scaled to the window, against the plane fetch plus the C assembly of
    frame 0 scaled to the window (a dummy palette: its values only change
    the header).  True when DCS is no slower."""
    from timg_tpu_torch.render.sixel_render import encode_sixel_stream

    pal_dummy = np.zeros((256, 3), np.uint8)
    t0 = time.perf_counter()
    b2, l2 = sixel_dcs.batch_encode(planes_dev, n_frames, h, w, cap)
    b2h, l2h = _host(b2), _host(l2)
    t_fetch = time.perf_counter() - t0
    t0 = time.perf_counter()
    sixel_dcs.splice_host(b2h[0], l2h[0], h, w, pal_dummy)
    t_dcs = t_fetch + (time.perf_counter() - t0) * n_frames
    t0 = time.perf_counter()
    planes_h = _host(planes_dev)
    t_fetch = time.perf_counter() - t0
    t0 = time.perf_counter()
    encode_sixel_stream(planes_h[0, :h, :w], pal_dummy)
    t_plane = t_fetch + (time.perf_counter() - t0) * n_frames
    return t_dcs <= t_plane


# ---------------------------------------------------------------------------
# numpy mirrors (the JAX package's, copied: test oracles, and the host
# fallback of the records assembler)
# ---------------------------------------------------------------------------

def column_words_np(plane: np.ndarray, h: int, w: int):
    nb = (h + 5) // 6
    x = np.zeros((nb * 6, w), np.uint32)
    x[:h] = plane[:h, :w]
    r = x.reshape(nb, 6, w)
    w0 = r[:, 0] | (r[:, 1] << 8) | (r[:, 2] << 16) | (r[:, 3] << 24)
    w1 = r[:, 4] | (r[:, 5] << 8)
    return w0.view(np.int32), w1.view(np.int32)


def compact_runs_np(plane: np.ndarray, h: int, w: int) -> SixelRuns:
    """Reference compaction of one [>=h, >=w] u8 plane."""
    w0, w1 = column_words_np(plane, h, w)
    change = (w0[:, 1:] != w0[:, :-1]) | (w1[:, 1:] != w1[:, :-1])
    start = np.concatenate(
        [np.ones((w0.shape[0], 1), bool), change], axis=1)
    band_counts = start.sum(axis=1).astype(np.int32)
    xcoord = np.broadcast_to(np.arange(w, dtype=np.int32), start.shape)
    rec1 = (w1.view(np.uint32)
            | (xcoord.astype(np.uint32) << 16)).view(np.int32)
    records = np.stack([w0[start], rec1[start]], axis=-1)
    return SixelRuns(records.astype(np.int32), band_counts, h, w)


def expand_runs_np(runs: SixelRuns) -> np.ndarray:
    """Inverse of compact_runs_np: records -> [h, w] u8 plane (pad rows
    of the last partial band are reconstructed as 0)."""
    h, w = runs.h, runs.w
    nb = (h + 5) // 6
    plane = np.zeros((nb * 6, w), np.uint8)
    rec = runs.records.view(np.uint32).reshape(-1, 2)
    k = 0
    for band in range(nb):
        n = int(runs.band_counts[band])
        xs = [int(rec[k + i, 1] >> 16) for i in range(n)] + [w]
        for i in range(n):
            r0, r1 = int(rec[k + i, 0]), int(rec[k + i, 1])
            col = [(r0 >> (8 * j)) & 0xFF for j in range(4)] + \
                  [r1 & 0xFF, (r1 >> 8) & 0xFF]
            for j in range(6):
                plane[band * 6 + j, xs[i]:xs[i + 1]] = col[j]
        k += n
    return plane[:h]
