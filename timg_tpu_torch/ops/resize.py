"""Resizes in torch ops (counterpart of timg_tpu/ops/resize.py): the lean
video resize, word in / word out, and the stb-exact RGBA resize of the
library API and the stills (``resize_batch``, near the end of this
module), and the nearest-neighbour sampling of ``-a``
(``resize_nearest``, last).

Lean video resize (``resize_video_words``):

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

import dataclasses
import functools

import numpy as np
import torch

from timg_tpu_torch.ops.resize_np import (_SMALL_FLOAT,
                                          STB_DOWNSAMPLE_FILTER,
                                          STB_UPSAMPLE_FILTER,
                                          nearest_indices, packed_taps,
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


def order_blocks(starts: torch.Tensor, width: int) -> int:
    """The most order blocks (of ORDER_BLOCK inputs, aligned on the input
    index) that one band of ``width`` taps from ``starts`` touches."""
    s = starts.numpy().astype(np.int64)
    return int(((s + width - 1) // ORDER_BLOCK - s // ORDER_BLOCK).max()) + 1


def slot_taps(starts: torch.Tensor, taps: torch.Tensor, in_size: int):
    """The taps of the two-pass route's pass along rows
    (csrc/resize_passes.cu ``resize_rows_to_mid``), laid out for the
    thread of order block j and parity p: ``(taps [nb, 2, slots, 16] f32,
    dst [nb, slots] int32, nb_max)``, nb = ceil(in / 32).  Slot m of block
    j is the m-th output o whose band covers block j; ``taps[j, p, m, i]``
    is its tap of input
    ``32 j + p + 2i``, +0 outside the band (or where no output is in the
    slot), so the thread's sum over i equals the reference's sum that
    skips those inputs (``ORDER_BLOCK``'s split; csrc/resize_passes.cu
    says why a +0 product changes no bit).  ``dst[j, m]`` is the index of
    the slot's (E, O) pair of channel 0 in a row's block sums
    ``[out, 3, nb_max, 2]`` (``2 (3 nb_max o + j - starts[o] // 32)``),
    -1 for an empty slot; ``nb_max`` is ``order_blocks``."""
    s = starts.numpy().astype(np.int64)
    t = taps.to(torch.float32).numpy()
    out_n, width = t.shape
    jfirst = s // ORDER_BLOCK
    jlast = (s + width - 1) // ORDER_BLOCK
    nb_max = order_blocks(starts, width)
    nb = -(-in_size // ORDER_BLOCK)
    cover = [[o for o in range(out_n) if jfirst[o] <= j <= jlast[o]]
             for j in range(nb)]
    slots = max(1, max(len(c) for c in cover))
    taps16 = np.zeros((nb, 2, slots, ORDER_BLOCK // 2), np.float32)
    dst = np.full((nb, slots), -1, np.int32)
    i2 = 2 * np.arange(ORDER_BLOCK // 2)
    for j, outs in enumerate(cover):
        for m, o in enumerate(outs):
            dst[j, m] = 2 * (3 * nb_max * o + j - jfirst[o])
            for p in (0, 1):
                rel = ORDER_BLOCK * j + p + i2 - s[o]
                inside = (rel >= 0) & (rel < width)
                taps16[j, p, m, inside] = t[o, rel[inside]]
    return torch.from_numpy(taps16), torch.from_numpy(dst), nb_max


def first_flush(start: int) -> int:
    """The tap index t at which the reference order first adds a block's
    ``even + odd`` to the running total, for an output whose taps start
    at input ``start``: the first t > 0 with (start + t) % 32 == 0.  The
    later flushes follow every 32 taps.  The CUDA kernel computes this
    once per output instead of testing every tap's input index."""
    return ORDER_BLOCK - start % ORDER_BLOCK


# --------------------------------------------------------------------------
# Tiles of the fused CUDA resize (csrc/resize_words.cu)
#
# A block owns rows x cols output words of one frame.  Its first pass
# fills a mid tile in shared memory: for vertical-first, its `rows`
# output rows over a window of input columns (the span its columns' taps
# touch); for horizontal-first, a window of input rows (the span its rows'
# taps touch) over its `cols` output columns.  The second pass reads only
# that tile.  The planner sizes the tile under the shared-memory budget.
# --------------------------------------------------------------------------

TILE_THREADS = 256            # threads a block; a tile's cols divide it
TILE_ROWS = (16, 8, 4, 2, 1)
TILE_COLS = (128, 64, 32)
SMEM_PREFERRED = 75 * 1024    # keeps 3 blocks of 256 threads on an SM
SMEM_MAX = 232448             # the most a Hopper block can opt in to


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One geometry's tiling.  ``windows_v[i] = (lo, hi)``: the input
    rows [lo, hi) that the vertical taps of tile row i read;
    ``windows_h[j]`` the input columns of tile column j.  ``mid_n`` is
    the mid tile's extent on the first pass's other axis (the widest
    ``windows_h`` span if vertical-first, else the tallest
    ``windows_v``); ``stage_n``, vertical-first only, the tallest
    ``windows_v`` span: the input rows staged in shared memory."""
    vertical_first: bool
    rows: int
    cols: int
    taps_v: int
    taps_h: int
    mid_n: int
    stage_n: int
    windows_v: np.ndarray     # int32 [tile rows, 2]
    windows_h: np.ndarray     # int32 [tile columns, 2]
    smem_bytes: int


def _windows(starts: np.ndarray, taps: int, tile: int) -> np.ndarray:
    n = starts.shape[0]
    return np.array([(starts[i:i + tile].min(),
                      starts[i:i + tile].max() + taps)
                     for i in range(0, n, tile)], np.int32).reshape(-1, 2)


def tile_smem_regions(vfirst: bool, rows: int, cols: int, mid_n: int,
                      stage_n: int, taps_v: int, taps_h: int) -> tuple:
    """(alignment, bytes) of each region of one block's shared memory, in
    the order the kernel carves it: the staged input words
    (vertical-first, rows padded to 32 words; filled by 16-byte copies),
    the tile's taps (two f32 each) of both axes, their int32 starts, then
    the 3-channel f32 mid tile."""
    m = rows * mid_n if vfirst else mid_n * cols
    pitch = -(-(mid_n + 3) // 32) * 32
    return ((16, 4 * stage_n * pitch), (8, 8 * rows * taps_v),
            (8, 8 * cols * taps_h), (4, 4 * (rows + cols)), (4, 12 * m))


def tile_smem_bytes(*args) -> int:
    """Shared memory of one block (``tile_smem_regions``' arguments);
    raises ``AssertionError`` if a region would start misaligned."""
    offset = 0
    for align, size in tile_smem_regions(*args):
        assert offset % align == 0, (args, offset, align)
        offset += size
    return offset


@functools.lru_cache(maxsize=64)
def plan_tiles(in_h: int, in_w: int, out_h: int,
               out_w: int) -> "TilePlan | None":
    """Tile size and first-pass windows of the fused resize, or None
    where no tile fits (the geometry then takes the two-pass kernels of
    csrc/resize_passes.cu).

    Among the tiles whose shared memory fits ``SMEM_PREFERRED``, the one
    with the fewest first-pass points and staged words per output word
    (least halo), the larger on a tie; where none fits, the smallest
    tile if it fits ``SMEM_MAX``; None where even a 1 x 32 tile does
    not.  The band spans about 4 inputs per output
    step, so a 1 x 32 tile holds 33 bands of taps (8 bytes each) and a
    mid tile of one band by 32 columns (horizontal-first) or 31 steps
    plus a band (vertical-first), 4 bytes a channel: it stops fitting
    near a 90x downscale of both axes (2160x3840 -> 16x28, 135x, and
    1080x1920 -> 12x20: None; 1080x1920 -> 16x28, 68x, fits)."""
    vfirst = vertical_first(in_h, in_w, out_h, out_w)
    sv, tv = axis_taps(in_h, out_h, False)
    sh, th = axis_taps(in_w, out_w, True)
    taps_v, taps_h = tv.shape[1], th.shape[1]
    widest = max(32, 1 << (out_w - 1).bit_length())
    best = smallest = None
    for cols in (c for c in TILE_COLS if c <= widest):
        for rows in TILE_ROWS:
            win_v = _windows(sv.numpy(), taps_v, rows)
            win_h = _windows(sh.numpy(), taps_h, cols)
            span_v = int((win_v[:, 1] - win_v[:, 0]).max())
            span_h = int((win_h[:, 1] - win_h[:, 0]).max())
            mid_n, stage_n = (span_h, span_v) if vfirst else (span_v, 0)
            smem = tile_smem_bytes(vfirst, rows, cols, mid_n, stage_n,
                                   taps_v, taps_h)
            plan = TilePlan(vfirst, rows, cols, taps_v, taps_h, mid_n,
                            stage_n, win_v, win_h, smem)
            points = (rows + stage_n) * mid_n if vfirst else mid_n * cols
            cost = (points / (rows * cols), -rows * cols)
            if smem <= SMEM_PREFERRED and (best is None or cost < best[0]):
                best = (cost, plan)
            if smallest is None or smem < smallest.smem_bytes:
                smallest = plan
    if best is not None:
        return best[1]
    return smallest if smallest.smem_bytes <= SMEM_MAX else None


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


def resize_video_words_plain(words: torch.Tensor, out_h: int,
                             out_w: int) -> torch.Tensor:
    """Plain PyTorch version: [B, H, W] int32 RGBA words ->
    [B, out_h, out_w] int32 words with alpha 255."""
    b, in_h, in_w = words.shape
    sv, tv = axis_taps(in_h, out_h, False)
    sh, th = axis_taps(in_w, out_w, True)
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


def resize_video_words(words: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """[B, H, W] int32 RGBA words -> [B, out_h, out_w] int32 words.

    A CUDA tensor goes through the hand-written kernels
    (ops/resize_kernel.py), a CPU tensor through the plain version; both
    take the geometry's ``axis_taps``."""
    in_h, in_w = words.shape[1], words.shape[2]
    if (in_h, in_w) == (out_h, out_w):
        return words
    if words.is_cuda:
        from timg_tpu_torch.ops import resize_kernel
        return resize_kernel.resize_video_words_cuda(words, out_h, out_w)
    return resize_video_words_plain(words, out_h, out_w)


# --------------------------------------------------------------------------
# stb-exact RGBA resize (timg_tpu/ops/resize.py:resize_batch)
#
# Every f32 rounding of stb_image_resize2 as the reference configures it
# (timg_tpu/ops/resize.py's module docstring): u8 * f32(1/255) decode,
# "fancy alpha" 7-channel filtering of the plain and premultiplied
# streams, reciprocal un-weighting, * 255 + 0.5 truncating encode; the
# taps and the pass order come from ops/resize_np.py.  Each product and
# each sum is its own torch op on f32 tensors (the scalars are f32
# tensors too), so nothing is contracted into an FMA or reordered.  The
# JAX package's ``_phase_plan`` (polyphase strided slices, a TPU layout
# trick) has no twin: every pass gathers with ``index_select``.
# --------------------------------------------------------------------------


def _accumulate(taps, widest: int, horizontal: bool):
    """stb accumulation structure over ``taps(t)`` values: vertical =
    single ascending madd chain (stb:10036+); horizontal with >= 4 taps
    = dual even/odd accumulators combined at the end (SSE 7ch gather
    kernels); 1-3 taps = single ascending chain."""
    if horizontal and widest >= 4:
        even = taps(0)
        odd = taps(1)
        for t in range(2, widest):
            if t % 2 == 0:
                even = even + taps(t)
            else:
                odd = odd + taps(t)
        return even + odd
    acc = taps(0)
    for t in range(1, widest):
        acc = acc + taps(t)
    return acc


def _apply_axis(x: torch.Tensor, axis: int, starts: np.ndarray,
                coeffs: np.ndarray, horizontal: bool, n: int = 0,
                offset: int = 0) -> torch.Tensor:
    """1-D filter along ``axis``: output o sums
    ``x[starts[o] + t] * coeffs[o, t]`` in stb's order, the index
    clamped to the axis' ``n`` inputs (default: all of ``x``'s), of
    which ``x`` holds those from ``offset`` on."""
    n = n or x.shape[axis]
    idx = torch.from_numpy(starts.astype(np.int64)).to(x.device)
    cf = torch.from_numpy(np.ascontiguousarray(coeffs)).to(x.device)
    shape = [1] * x.dim()
    shape[axis] = -1
    return _accumulate(
        lambda t: x.index_select(axis, torch.clamp(idx + t, 0, n - 1)
                                 - offset)
        * cf[:, t].reshape(shape),
        coeffs.shape[1], horizontal)


def _resize_impl(frames: torch.Tensor, taps_h, taps_w, vertical_first: bool,
                 alpha_weighted: bool, in_h: int = 0,
                 row0: int = 0) -> torch.Tensor:
    dev = frames.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    x = frames.to(torch.float32) * f32(np.float32(1.0 / 255.0))
    if alpha_weighted:
        a = x[..., 3:4]
        x = torch.cat([x, x[..., :3] * a], dim=-1)          # [B,H,W,7]

    if vertical_first:
        x = _apply_axis(x, 1, *taps_h, horizontal=False, n=in_h,
                        offset=row0)
        x = _apply_axis(x, 2, *taps_w, horizontal=True)
    else:
        x = _apply_axis(x, 2, *taps_w, horizontal=True)
        x = _apply_axis(x, 1, *taps_h, horizontal=False, n=in_h,
                        offset=row0)

    if alpha_weighted:
        alpha = x[..., 3:4]
        unweighted = x[..., :3]
        premult = x[..., 4:7]
        # un-weight by the f32 reciprocal (stb:4275-4288)
        small = f32(_SMALL_FLOAT)
        ialpha = f32(1.0) / torch.maximum(alpha, small)
        rgb = torch.where(alpha < small, unweighted, premult * ialpha)
        x = torch.cat([rgb, alpha], dim=-1)

    # encode: (v * 255) + 0.5, clamped, truncated (stb encode_uint8 coders)
    out = torch.clamp(x * f32(255.0) + f32(0.5), 0.0, 255.0)
    return out.to(torch.uint8)


def resize_batch(
    frames: torch.Tensor,
    out_h: int,
    out_w: int,
    *,
    upsample_filter: str = STB_UPSAMPLE_FILTER,
    downsample_filter: str = STB_DOWNSAMPLE_FILTER,
    alpha_weighted: bool = True,
) -> torch.Tensor:
    """Resize a uint8 RGBA batch [B, H, W, 4] to [B, out_h, out_w, 4] on
    the tensor's device, byte-exact with ops/resize_np.resize_batch_np."""
    _, in_h, in_w, _ = frames.shape
    if (in_h, in_w) == (out_h, out_w):
        return frames
    taps_h = packed_taps(in_h, out_h, upsample_filter, downsample_filter,
                         False)
    taps_w = packed_taps(in_w, out_w, upsample_filter, downsample_filter,
                         True)
    vertical_first = plan_passes(in_h, in_w, out_h, out_w, upsample_filter,
                                 downsample_filter, alpha_weighted)
    return _resize_impl(frames, taps_h, taps_w, vertical_first,
                        alpha_weighted)


def input_rows(in_h: int, out_h: int, o0: int, o1: int) -> tuple:
    """The input rows ``(i0, i1)`` that output rows ``o0 .. o1`` of
    ``resize_batch`` read (their vertical taps, clamped at the edges)."""
    starts, coeffs = packed_taps(in_h, out_h, STB_UPSAMPLE_FILTER,
                                 STB_DOWNSAMPLE_FILTER, False)
    first = int(starts[o0:o1].min())
    last = int(starts[o0:o1].max()) + coeffs.shape[1] - 1
    return (min(max(first, 0), in_h - 1), min(max(last, 0), in_h - 1) + 1)


def resize_batch_rows(band: torch.Tensor, in_h: int, out_h: int, out_w: int,
                      row0: int, o0: int, o1: int) -> torch.Tensor:
    """Output rows ``o0 .. o1`` of ``resize_batch`` of [B, in_h, W, 4]
    frames to out_h x out_w, from ``band``, the frames' rows ``row0 ..``
    holding every row ``input_rows(in_h, out_h, o0, o1)`` names.  Each
    output row is its own taps' elementwise sums in the whole frame's
    order, so a band writes the whole frame's bytes (the spatial route
    of parallel/auto.py)."""
    in_w = band.shape[2]
    up, down = STB_UPSAMPLE_FILTER, STB_DOWNSAMPLE_FILTER
    starts, coeffs = packed_taps(in_h, out_h, up, down, False)
    taps_w = packed_taps(in_w, out_w, up, down, True)
    vertical_first = plan_passes(in_h, in_w, out_h, out_w, up, down, True)
    return _resize_impl(band, (starts[o0:o1], coeffs[o0:o1]), taps_w,
                        vertical_first, True, in_h=in_h, row0=row0)


def resize_nearest(frames: torch.Tensor, out_h: int,
                   out_w: int) -> torch.Tensor:
    """Nearest-neighbour resample (no antialias, ``-a``) of [B, H, W, C]
    on the tensor's device: GM SampleImage source indexing
    (``resize_np.nearest_indices``), two integer gathers, so every
    device writes the same bytes."""
    ys = torch.from_numpy(nearest_indices(frames.shape[1], out_h))
    xs = torch.from_numpy(nearest_indices(frames.shape[2], out_w))
    return frames.index_select(1, ys.to(frames.device)).index_select(
        2, xs.to(frames.device))
