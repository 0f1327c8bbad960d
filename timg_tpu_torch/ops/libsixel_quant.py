"""Faithful reimplementation of libsixel's quantizer (quant.c).

The reference's sixel canvas delegates palette construction and dithering
to libsixel with exactly these settings, per frame (ref
src/sixel-canvas.cc:134-148)::

    sixel_dither_new(&dither, 256, nullptr);
    sixel_dither_initialize(dither, rgba, w, h, SIXEL_PIXELFORMAT_RGBA8888,
                            SIXEL_LARGE_LUM, SIXEL_REP_AVERAGE_COLORS,
                            SIXEL_QUALITY_AUTO);
    sixel_encode(rgba, w, h, 0, dither, out);

libsixel is not present in this environment, so this module reimplements
the algorithm of its ``src/quant.c`` (itself derived from netpbm's
``pnmcolormap.c`` median cut) from the published source, pinned to the
code paths those settings select.  This file is the *scalar oracle*: the
semantics spec that the fast C implementation in
``timg_tpu/native/timg_native.cc`` (production `--dither=libsixel` path)
is byte-tested against, the same way the stb resize oracle pins
``ops/resize.py``.

Pinned semantics (libsixel quant.c, settings from sixel-canvas.cc):

* **Histogram** (``computeHistogram``): pixels are bucketed to 5 bits per
  channel — bucket = (R>>3)<<10 | (G>>3)<<5 | (B>>3) — and *sampled*:
  SIXEL_QUALITY_AUTO resolves to LOW for reqcolors > 8, and LOW/HIGH use
  max_sample = 18383 with a byte step of ``length/3/max_sample*3``;
  inputs smaller than max_sample pixels use a fixed step of 6 pixels
  (libsixel subsamples small images too); a non-positive step becomes 1
  pixel.  Bucket counts saturate at 65535 (unsigned short).  The color
  table lists buckets in *first-seen* order with each channel value
  reconstructed as ``bucket_bits << 3``.

* **Palette** (``mediancut``): if distinct buckets <= 256 the palette is
  the bucket colors themselves, in first-seen order, and dithering is
  disabled entirely (sixel_dither_initialize sets DIFFUSE_NONE when
  origcolors <= reqcolors).  Otherwise: start from one box holding every
  color; repeatedly take the first box (in a box list kept sorted by
  pixel-sum, descending) with >= 2 colors; split axis = largest
  luminosity-weighted spread (SIXEL_LARGE_LUM, weights .2989/.5866/.1145,
  strict > with first-axis-wins ties); sort the box's table segment by
  that component (stable, matching glibc qsort's mergesort); split at the
  frequency median (``lowersum < sum/2`` loop bounded to [1, n-1]); the
  box list is then re-sorted by sum, descending, stable.  Representative
  color = *unweighted* average of the box's distinct colors, floor
  division (SIXEL_REP_AVERAGE_COLORS; note: floor, not round).

* **Dither** (``sixel_quant_apply_palette`` with foptimize=1,
  optimize_palette=0, complexion=1): raster scan; per pixel the palette
  index comes from ``lookup_fast`` — a 32768-entry cache keyed by the
  pixel's 5-bit bucket; on miss, exact argmin of squared RGB distance
  (strict <, lowest index wins) which is then cached, so *every later
  pixel in the same bucket reuses the first pixel's answer*.  Error
  diffusion is Floyd-Steinberg in uint8 integer arithmetic: per channel,
  offset = pixel - palette, each neighbor receives
  ``offset * num / 16`` with C truncation-toward-zero division, clamped
  to [0,255] immediately per write (data is unsigned char), neighbors
  right 7/16, left-below 3/16, below 5/16, right-below 1/16, writes
  guarded to the frame interior.  (Early libsixel versions lacked some
  guards — CVE-era out-of-bounds writes; the guarded form of maintained
  releases is implemented here.)

The alpha channel of RGBA input is dropped (RGBA8888 -> RGB888
normalization), matching sixel_encode's pixelformat handling; the
reference alpha-composes before encoding so alpha is always 255 there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

QUALITY_AUTO = "auto"
QUALITY_LOW = "low"
QUALITY_HIGH = "high"
QUALITY_FULL = "full"

_LUM = (0.2989, 0.5866, 0.1145)  # largestByLuminosity factors


# ---------------------------------------------------------------------------
# Histogram (computeHistogram)
# ---------------------------------------------------------------------------

def sample_stride(n_pixels: int, reqcolors: int = 256,
                  quality: str = QUALITY_AUTO) -> int:
    """quant.c computeHistogram's pixel sampling stride: the histogram
    reads every stride-th pixel in raster order.  Exposed so device
    pipelines can ship exactly these samples instead of whole frames
    (the palette then comes out byte-identical)."""
    length = n_pixels * 3
    if quality == QUALITY_AUTO:
        quality = QUALITY_HIGH if reqcolors <= 8 else QUALITY_LOW
    max_sample = 4003079 if quality == QUALITY_FULL else 18383
    step = length // 3 // max_sample * 3
    if length < max_sample * 3:
        step = 6 * 3
    if step <= 0:
        step = 3
    return step // 3


def compute_histogram(rgb: np.ndarray, reqcolors: int = 256,
                      quality: str = QUALITY_AUTO
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """5-bit-bucket sampled histogram.

    rgb: [..., 3] uint8.  Returns (colors [K,3] int32 — multiples of 8 in
    first-seen order, counts [K] int64 saturated at 65535).
    """
    flat = np.ascontiguousarray(rgb).reshape(-1, 3)
    stride = sample_stride(flat.shape[0], reqcolors, quality)
    return histogram_from_samples(flat[::stride])


def histogram_from_samples(sampled: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Histogram tail over pre-sampled pixels [K, 3] (the sequence
    sample_stride produces; device pipelines fetch only these)."""
    sampled = sampled.astype(np.int32)
    buckets = ((sampled[:, 0] >> 3) << 10 | (sampled[:, 1] >> 3) << 5
               | (sampled[:, 2] >> 3))
    uniq, first, counts = np.unique(buckets, return_index=True,
                                    return_counts=True)
    order = np.argsort(first, kind="stable")  # first-seen order
    uniq = uniq[order]
    counts = np.minimum(counts[order], 65535).astype(np.int64)
    colors = np.stack([(uniq >> 10 & 0x1F) << 3, (uniq >> 5 & 0x1F) << 3,
                       (uniq & 0x1F) << 3], axis=1).astype(np.int32)
    return colors, counts


# ---------------------------------------------------------------------------
# Median cut (mediancut / splitBox / colormapFromBv)
# ---------------------------------------------------------------------------

def median_cut(colors: np.ndarray, counts: np.ndarray,
               reqcolors: int) -> np.ndarray:
    """libsixel mediancut over a first-seen-order color table.

    Returns [reqcolors, 3] uint8 (trailing entries stay black if boxes
    run out, matching newColorMap's zero-fill).
    """
    tbl_c = colors.astype(np.int64).copy()
    tbl_n = counts.astype(np.int64).copy()
    k = len(tbl_c)
    # box: [ind, n_colors, pixel_sum]
    boxes = [[0, k, int(tbl_n.sum())]]

    while len(boxes) < reqcolors:
        bi = next((i for i, b in enumerate(boxes) if b[1] >= 2), None)
        if bi is None:
            break
        ind, n, sm = boxes[bi]
        seg_c = tbl_c[ind:ind + n]
        seg_n = tbl_n[ind:ind + n]

        # largestByLuminosity: strict >, first axis wins, init 0.0/axis 0
        minv = seg_c.min(axis=0)
        maxv = seg_c.max(axis=0)
        best = 0.0
        dim = 0
        for plane in range(3):
            spread = _LUM[plane] * float(maxv[plane] - minv[plane])
            if spread > best:
                best = spread
                dim = plane
        srt = np.argsort(seg_c[:, dim], kind="stable")
        tbl_c[ind:ind + n] = seg_c[srt]
        tbl_n[ind:ind + n] = seg_n[srt]

        # frequency median: lowersum < sm/2 (integer), i in [1, n-1]
        lowersum = int(tbl_n[ind])
        i = 1
        while i < n - 1 and lowersum < sm // 2:
            lowersum += int(tbl_n[ind + i])
            i += 1
        boxes[bi] = [ind, i, lowersum]
        boxes.append([ind + i, n - i, sm - lowersum])
        # sumcompare: sort boxes by sum descending (stable = glibc qsort)
        boxes.sort(key=lambda b: -b[2])

    palette = np.zeros((reqcolors, 3), dtype=np.uint8)
    for i, (ind, n, _) in enumerate(boxes):
        # averageColors: unweighted mean of distinct colors, floor div
        palette[i] = tbl_c[ind:ind + n].sum(axis=0) // n
    return palette


def make_palette(rgb: np.ndarray, reqcolors: int = 256,
                 quality: str = QUALITY_AUTO) -> Tuple[np.ndarray, bool]:
    """sixel_quant_make_palette + the dither-disable rule.

    rgb: [..., 3] uint8.  Returns (palette [ncolors, 3] uint8, diffuse) —
    diffuse is False when distinct bucket colors <= reqcolors, in which
    case the palette is the bucket colors themselves (first-seen order).
    """
    colors, counts = compute_histogram(rgb, reqcolors, quality)
    if len(colors) <= reqcolors:
        return colors.astype(np.uint8), False
    return median_cut(colors, counts, reqcolors), True


def make_palette_from_samples(sampled: np.ndarray, reqcolors: int = 256
                              ) -> Tuple[np.ndarray, bool]:
    """make_palette over pre-sampled pixels (see sample_stride):
    byte-identical to make_palette(full_frame) when the sample sequence
    matches."""
    colors, counts = histogram_from_samples(sampled)
    if len(colors) <= reqcolors:
        return colors.astype(np.uint8), False
    return median_cut(colors, counts, reqcolors), True


# ---------------------------------------------------------------------------
# Apply palette: cached nearest lookup + integer FS diffusion
# ---------------------------------------------------------------------------

def _trunc_div(a: int, num: int, den: int) -> int:
    """C integer division semantics: truncation toward zero."""
    prod = a * num
    q = abs(prod) // den
    return q if prod >= 0 else -q


def apply_palette_reference(rgb: np.ndarray, palette: np.ndarray,
                            diffuse: bool = True,
                            use_cache: bool = True) -> np.ndarray:
    """Scalar oracle of sixel_quant_apply_palette (FS + lookup_fast).

    rgb: [H, W, 3] uint8; palette [N, 3] uint8.  Returns [H, W] int32
    indices.  ``use_cache=False`` disables the 15-bit first-touch cache
    (exact nearest-neighbor per pixel) — used by tests to quantify the
    cache's effect; libsixel always caches on this path.
    """
    h, w, _ = rgb.shape
    data = rgb[..., :3].astype(np.int32).copy()
    pal = palette.astype(np.int32)
    ncolors = len(pal)
    cache = np.zeros(1 << 15, dtype=np.int32)
    out = np.zeros((h, w), dtype=np.int32)

    for y in range(h):
        for x in range(w):
            p = data[y, x]
            hashv = (int(p[0]) >> 3) << 10 | (int(p[1]) >> 3) << 5 \
                | (int(p[2]) >> 3)
            if use_cache and cache[hashv]:
                idx = int(cache[hashv]) - 1
            else:
                d = pal - p
                dist = (d * d).sum(axis=1)
                idx = int(np.argmin(dist))  # strict <: lowest index wins
                cache[hashv] = idx + 1
            out[y, x] = idx
            if not diffuse:
                continue
            for n in range(3):
                off = int(data[y, x, n]) - int(pal[idx, n])
                if off == 0:
                    continue
                if x < w - 1:
                    _diffuse_to(data, y, x + 1, n, _trunc_div(off, 7, 16))
                if x > 0 and y < h - 1:
                    _diffuse_to(data, y + 1, x - 1, n,
                                _trunc_div(off, 3, 16))
                if y < h - 1:
                    _diffuse_to(data, y + 1, x, n, _trunc_div(off, 5, 16))
                if x < w - 1 and y < h - 1:
                    _diffuse_to(data, y + 1, x + 1, n,
                                _trunc_div(off, 1, 16))
    return out


def _diffuse_to(data: np.ndarray, y: int, x: int, n: int, delta: int):
    """error_diffuse: add + clamp to [0,255] immediately (uint8 store)."""
    v = int(data[y, x, n]) + delta
    data[y, x, n] = 0 if v < 0 else (255 if v > 255 else v)


# ---------------------------------------------------------------------------
# Bucket-table variant: the device path's semantics
# ---------------------------------------------------------------------------
#
# quant.c's lookup_fast cache is filled by the *first pixel in raster
# order* that lands in each 15-bit bucket, with that pixel's exact
# post-diffusion color — so the cache contents (and every later pixel's
# index) depend on the full raster history.  That makes the cached
# semantics inherently sequential: pixel (y, 0) needs the completed
# cache state of every pixel in rows 0..y-1, which defeats both the
# wavefront schedule and any multi-chip sharding (a measured sequential
# TPU scan lands near ~500 fps vs the 5000 fps target; a per-pixel
# 256-way exact argmin at target rate would need ~3.5 peta-ops/s).
#
# The production device path therefore uses the *prefilled* variant
# below: the cache is built once per frame with each bucket's BASE
# color (bits << 3 — the same reconstruction libsixel's histogram color
# table uses), making the lookup order-independent and wavefront/
# shard-compatible.  It deviates from libsixel only in which color
# fills each cache slot (bucket base vs first-touching pixel); the
# still-image CLI path keeps the exact cached semantics via
# timg_libsixel_quant.  apply_palette_bucket_table below is the scalar
# oracle for the device kernel and its C mirror.

def build_bucket_table(palette: np.ndarray) -> np.ndarray:
    """[32768] uint8: nearest palette index per bucket base color
    (strict <, lowest index wins — argmin semantics of lookup_fast)."""
    pal = palette.astype(np.int64)
    b = np.arange(1 << 15)
    base = np.stack([(b >> 10 & 0x1F) << 3, (b >> 5 & 0x1F) << 3,
                     (b & 0x1F) << 3], axis=1).astype(np.int64)
    d = base[:, None, :] - pal[None, :, :]
    dist = (d * d).sum(axis=2)
    return dist.argmin(axis=1).astype(np.uint8)


def apply_palette_bucket_table(rgb: np.ndarray, table: np.ndarray,
                               palette: np.ndarray,
                               diffuse: bool = True) -> np.ndarray:
    """Scalar oracle of the bucket-table FS apply (device semantics):
    identical integer FS to apply_palette_reference, index from the
    prefilled table."""
    h, w, _ = rgb.shape
    data = rgb[..., :3].astype(np.int32).copy()
    pal = palette.astype(np.int32)
    out = np.zeros((h, w), dtype=np.int32)
    for y in range(h):
        for x in range(w):
            p = data[y, x]
            hashv = (int(p[0]) >> 3) << 10 | (int(p[1]) >> 3) << 5 \
                | (int(p[2]) >> 3)
            idx = int(table[hashv])
            out[y, x] = idx
            if not diffuse:
                continue
            for n in range(3):
                off = int(data[y, x, n]) - int(pal[idx, n])
                if off == 0:
                    continue
                if x < w - 1:
                    _diffuse_to(data, y, x + 1, n, _trunc_div(off, 7, 16))
                if x > 0 and y < h - 1:
                    _diffuse_to(data, y + 1, x - 1, n,
                                _trunc_div(off, 3, 16))
                if y < h - 1:
                    _diffuse_to(data, y + 1, x, n, _trunc_div(off, 5, 16))
                if x < w - 1 and y < h - 1:
                    _diffuse_to(data, y + 1, x + 1, n,
                                _trunc_div(off, 1, 16))
    return out


def quantize_reference(rgba: np.ndarray, reqcolors: int = 256,
                       use_cache: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Full per-frame pipeline as the reference drives libsixel:
    palette from the frame + cached FS apply.  rgba: [H, W, 3|4] uint8.
    Returns (indices [H, W] int32, palette [ncolors, 3] uint8)."""
    rgb = np.ascontiguousarray(rgba[..., :3])
    palette, diffuse = make_palette(rgb, reqcolors)
    indices = apply_palette_reference(rgb, palette, diffuse, use_cache)
    return indices, palette
