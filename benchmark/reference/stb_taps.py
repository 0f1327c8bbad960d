"""stb_image_resize2's taps, as the reference viewer configures its
scaler: a frozen copy of the port's numpy tap construction
(timg_tpu_torch/ops/_resize_weights.py and the tap half of
ops/resize_np.py), kept here so that later changes to the program
cannot move the yardstick.  Pure numpy; imports nothing of the program.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Tuple

import numpy as np

_SMALL_FLOAT = float(np.float32(1.0) / (1 << 20) ** 6)  # stbir__small_float


def double_to_rational(f: float, limit: int, limit_denom: bool):
    """stbir__double_to_rational (stb:7473-7549): continued-fraction
    approximation with < 1 float-bit error. Returns (ok, numer, denom)."""
    top = int(f * (1 << 25))
    bot = 1 << 25
    numer_last, denom_last = 0, 1
    numer_est, denom_est = 1, 0
    while True:
        if (denom_est if limit_denom else numer_est) >= limit:
            break
        if denom_est:
            err = abs(numer_est / denom_est - f)
            if err < 1.0 / (1 << 24):
                return True, numer_est, denom_est
        if bot == 0:
            break
        est, temp = divmod(top, bot)
        top, bot = bot, temp
        denom_est, denom_last = est * denom_est + denom_last, denom_est
        numer_est, numer_last = est * numer_est + numer_last, numer_est
    if limit_denom:
        numer_est = int(f * limit + 0.5)
        denom_est = limit
    else:
        numer_est = limit
        denom_est = int(limit / f + 0.5)
    err = abs(numer_est / denom_est - f) if denom_est else 1.0
    return err < 1.0 / (1 << 24), numer_est, denom_est


def build_weights(
    in_size: int,
    out_size: int,
    kernel: Callable,
    support_fn: Callable,
) -> np.ndarray:
    """Dense [out_size, in_size] float32 tap matrix."""
    # stb computes the scale ratio in double, stores float (stb:7566-7577).
    scale_double = float(out_size) / float(in_size)
    scale = np.float32(scale_double)
    inv_scale = np.float32(1.0 / scale_double)
    upsample = float(scale) >= (1.0 - _SMALL_FLOAT)

    # Rational-scale polyphase (stb:7592, 3274, 3391, 3521-3536): taps are
    # computed for the first `numerator` output pixels only and replicated
    # with the input index shifted by `denominator`.
    is_rational, numerator, denominator = double_to_rational(
        scale_double,
        out_size if scale_double <= 1.0 else in_size,
        limit_denom=(scale_double >= 1.0),
    )
    polyphase = is_rational and numerator < out_size
    phase_count = numerator if polyphase else out_size

    # taps[o]: ordered list of (input_index, float32 coeff), unclamped.
    taps: Dict[int, List[Tuple[int, np.float32]]] = {o: [] for o in range(out_size)}
    out_centers = np.arange(out_size, dtype=np.float32) + np.float32(0.5)

    if upsample:
        # Gather (stb:3267-3327); out_pixels_radius = support(inv)*scale.
        support = np.float32(support_fn(float(inv_scale)))
        out_radius = support * scale
        for o in range(phase_count):
            oc = out_centers[o]
            in_center_of_out = oc * inv_scale
            lo = int(math.floor(float((oc - out_radius) * inv_scale) + 0.5))
            hi = int(math.floor(float((oc + out_radius) * inv_scale) - 0.5))
            hi = max(hi, lo)
            leading = True
            for i in range(lo, hi + 1):
                x = np.float32(in_center_of_out) - (np.float32(i) + np.float32(0.5))
                c = np.float32(kernel(np.float32(x), inv_scale))
                if abs(c) < _SMALL_FLOAT:
                    if leading:
                        continue  # eat leading zeros (stb:3303-3309)
                    c = np.float32(0.0)
                else:
                    leading = False
                taps[o].append((i, c))
            # kill trailing zeros (stb:3318)
            while taps[o] and taps[o][-1][1] == 0.0:
                taps[o].pop()
    else:
        # Scatter (stb:3382-3463): iterate input pixels incl. margin.
        support = np.float32(support_fn(float(scale)))
        in_radius = support * inv_scale
        margin = int(math.ceil(float(support) * 2.0 / float(scale)))
        for i in range(-margin, in_size + margin):
            ic = np.float32(i) + np.float32(0.5)
            out_center_of_in = ic * scale
            out_first = int(math.floor(float((ic - in_radius) * scale) + 0.5))
            out_last = int(math.floor(float((ic + in_radius) * scale) - 0.5))
            out_first = max(out_first, 0)
            out_last = min(out_last, out_size - 1)
            if polyphase:  # stb:3408-3417
                if out_first >= numerator:
                    break
                out_last = min(out_last, numerator - 1)
            for o in range(out_first, out_last + 1):
                x = out_centers[o] - out_center_of_in
                c = np.float32(kernel(np.float32(x), scale)) * scale
                if abs(c) < _SMALL_FLOAT:
                    c = np.float32(0.0)
                taps[o].append((i, c))

    # Renormalize each row to total 1: double accumulation over the f32
    # coeffs, multiply by the double reciprocal, store f32 (stb:3487-3516).
    for o in range(phase_count):
        total = np.float64(0.0)
        for _, c in taps[o]:
            total = total + np.float64(c)
        if abs(total) < _SMALL_FLOAT:
            taps[o] = []
        elif total < (1.0 - _SMALL_FLOAT) or total > (1.0 + _SMALL_FLOAT):
            inv_total = np.float64(1.0) / total
            taps[o] = [(i, np.float32(np.float64(c) * inv_total))
                       for i, c in taps[o]]

    if polyphase:  # replicate phases with shifted indices (stb:3521-3536)
        for o in range(numerator, out_size):
            taps[o] = [(i + denominator, c) for i, c in taps[o - numerator]]

    # EDGE_CLAMP fold: out-of-range taps are *float32-added* onto the
    # clamped edge pixel after renormalization (stb:3569-3603), right side
    # ascending first, then left side.
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        in_range = [(i, c) for i, c in taps[o] if 0 <= i < in_size]
        right = [(i, c) for i, c in taps[o] if i >= in_size]
        left = [(i, c) for i, c in taps[o] if i < 0]
        for i, c in in_range:
            w[o, i] = c
        for i, c in sorted(right, key=lambda t: t[0]):
            w[o, in_size - 1] = np.float32(w[o, in_size - 1] + c)
        # left: stb inserts i=-1 down to n0+1 first, then n0 last --
        # all with float32 adds at index 0.
        left_sorted = sorted(left, key=lambda t: -t[0])
        for i, c in left_sorted:
            w[o, 0] = np.float32(w[o, 0] + c)
    return w


def _filter_box(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """stbir__filter_trapezoid (STBIR_FILTER_BOX); needs scale <= 1."""
    x = np.abs(x)
    halfscale = scale / 2
    t = np.float32(0.5) + halfscale
    r = np.float32(0.5) - halfscale
    out = np.where(x >= t, np.float32(0), (t - x) / scale)
    return np.where(x <= r, np.float32(1), out).astype(np.float32)


def _filter_triangle(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x <= 1.0, np.float32(1) - x, np.float32(0)).astype(np.float32)


def _filter_mitchell(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    x = np.abs(x).astype(np.float32)
    near = (np.float32(16) + x * x * (np.float32(21) * x - np.float32(36))) / np.float32(18)
    far = (np.float32(32) + x * (np.float32(-60) + x * (np.float32(36) - np.float32(7) * x))) / np.float32(18)
    out = np.where(x < 1.0, near, np.where(x < 2.0, far, np.float32(0)))
    return out.astype(np.float32)


def _filter_catmullrom(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    x = np.abs(x).astype(np.float32)
    near = np.float32(1) - x * x * (np.float32(2.5) - np.float32(1.5) * x)
    far = np.float32(2) - x * (np.float32(4) + x * (np.float32(0.5) * x - np.float32(2.5)))
    out = np.where(x < 1.0, near, np.where(x < 2.0, far, np.float32(0)))
    return out.astype(np.float32)


FILTERS: dict[str, Tuple[Callable, Callable]] = {
    # name -> (kernel(x, scale), support(scale))
    "box": (_filter_box, lambda s: 0.5 + s / 2.0),
    "triangle": (_filter_triangle, lambda s: 1.0),
    "mitchell": (_filter_mitchell, lambda s: 2.0),
    "catmull-rom": (_filter_catmullrom, lambda s: 2.0),
}

# The reference's STB scaler configuration (image-scaler.cc:29-33).
STB_UPSAMPLE_FILTER = "box"
STB_DOWNSAMPLE_FILTER = "mitchell"


@functools.lru_cache(maxsize=256)
def resample_weights(
    in_size: int,
    out_size: int,
    upsample_filter: str = STB_UPSAMPLE_FILTER,
    downsample_filter: str = STB_DOWNSAMPLE_FILTER,
) -> np.ndarray:
    """Dense [out_size, in_size] float32 tap matrix (see _resize_weights)."""

    scale = np.float32(out_size) / np.float32(in_size)
    upsample = float(scale) >= (1.0 - _SMALL_FLOAT)
    kernel, support_fn = FILTERS[upsample_filter if upsample
                                 else downsample_filter]
    return build_weights(in_size, out_size, kernel, support_fn)


def filter_pixel_width(support_fn: Callable, in_size: int,
                       out_size: int) -> int:
    """stbir__get_filter_pixel_width (stb:2962-2970)."""
    scale = float(np.float32(out_size) / np.float32(in_size))
    if scale >= 1.0 - _SMALL_FLOAT:
        return int(math.ceil(support_fn(1.0 / scale) * 2.0))
    return int(math.ceil(support_fn(scale) * 2.0 / scale))


# stbir__compute_weights trained cost tables (stb:6770-6818), indexed by
# [channel_table][classification][4]. Only the tables the viewer can hit:
# 4-channel (index 3) and 7-channel RGBA-premult (index 4).
COST_WEIGHTS = {
    4: [
        [0.00000, 0.50000, 0.00000, 0.71875],
        [0.06250, 0.84375, 0.00000, 0.87500],
        [1.00000, 0.50000, 0.50000, 0.96875],
        [1.00000, 0.09375, 0.31250, 0.50000],
        [1.00000, 1.00000, 1.00000, 1.00000],
        [1.00000, 0.03125, 0.03125, 0.53125],
        [0.18750, 0.12500, 0.00000, 1.00000],
        [0.00000, 1.00000, 0.03125, 0.18750],
    ],
    7: [
        [0.00000, 0.59375, 0.00000, 0.96875],
        [0.06250, 0.81250, 0.06250, 0.59375],
        [0.75000, 0.43750, 0.12500, 0.96875],
        [0.87500, 0.06250, 0.18750, 0.43750],
        [1.00000, 1.00000, 1.00000, 1.00000],
        [0.15625, 0.12500, 1.00000, 1.00000],
        [0.06250, 0.12500, 0.00000, 1.00000],
        [0.00000, 1.00000, 0.03125, 0.34375],
    ],
}

# when downsampling and <= 32 scanlines of buffering, vertical uses gather
FORCE_GATHER_SCANLINES = 32  # stb:1201


def should_do_vertical_first(
    channels: int,
    h_fpw: int, h_scale: float, h_out: int,
    v_fpw: int, v_scale: float, v_out: int,
    v_is_gather: bool,
) -> bool:
    """stbir__should_do_vertical_first (stb:6859-6905)."""
    if v_out <= 4 or h_out <= 4:
        classification = 6 if v_out < h_out else 7
    elif v_scale <= 1.0:
        classification = 1 if v_is_gather else 0
    elif v_scale <= 2.0:
        classification = 2
    elif v_scale <= 3.0:
        classification = 3
    elif v_scale <= 4.0:
        classification = 5
    else:
        classification = 6
    w = [np.float32(x) for x in COST_WEIGHTS[channels][classification]]
    h_cost = np.float32(h_fpw) * w[0] + np.float32(h_scale) * np.float32(v_fpw) * w[1]
    v_cost = np.float32(v_fpw) * w[2] + np.float32(v_scale) * np.float32(h_fpw) * w[3]
    return bool(v_cost <= h_cost)


@functools.lru_cache(maxsize=256)
def packed_taps(in_size: int, out_size: int, upsample_filter: str,
                downsample_filter: str, horizontal: bool):
    """Banded taps: (starts[out] int32, coeffs[out, widest] f32).

    For horizontal use the right-edge repack of stbir__pack_coefficients
    (stb:3794-3866) is applied: rows whose reads would pass the scanline
    end are shifted back with leading zeros.
    """
    w = resample_weights(in_size, out_size, upsample_filter,
                         downsample_filter)
    n0s = np.zeros(out_size, dtype=np.int64)
    n1s = np.zeros(out_size, dtype=np.int64)
    for o in range(out_size):
        nz = np.nonzero(w[o])[0]
        if len(nz):
            n0s[o], n1s[o] = nz[0], nz[-1]
    widest = max(1, int((n1s - n0s + 1).max()))

    if horizontal:
        mod = widest & 3
        for o in range(out_size):
            count = int(n1s[o] - n0s[o] + 1)
            if widest > 12:
                stop_range = ((count - mod + 3) & ~3) + mod
                if stop_range < 8 + mod:
                    stop_range = 8 + mod
            else:
                stop_range = widest
            if n0s[o] + stop_range > in_size:
                n0s[o] = max(0, in_size - stop_range)

    starts = np.minimum(n0s, max(0, in_size - widest)).astype(np.int32)
    coeffs = np.zeros((out_size, widest), dtype=np.float32)
    for o in range(out_size):
        s = int(starts[o])
        span = w[o, s:s + widest]
        coeffs[o, :len(span)] = span
    return starts, coeffs


def plan_passes(in_h: int, in_w: int, out_h: int, out_w: int,
                upsample_filter: str, downsample_filter: str,
                alpha_weighted: bool) -> bool:
    """Return vertical_first for this geometry (stb heuristic)."""
    def fpw(in_size, out_size):
        scale = float(np.float32(out_size) / np.float32(in_size))
        name = (upsample_filter if scale >= 1.0 - _SMALL_FLOAT
                else downsample_filter)
        return filter_pixel_width(FILTERS[name][1], in_size, out_size)

    h_scale = float(np.float32(out_w) / np.float32(in_w))
    v_scale = float(np.float32(out_h) / np.float32(in_h))
    v_fpw = fpw(in_h, out_h)
    v_is_gather = (v_scale >= 1.0 - _SMALL_FLOAT
                   or v_fpw <= FORCE_GATHER_SCANLINES)
    return should_do_vertical_first(
        7 if alpha_weighted else 4,
        fpw(in_w, out_w), h_scale, out_w,
        v_fpw, v_scale, out_h, v_is_gather)


