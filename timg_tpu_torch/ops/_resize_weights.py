"""Tap-weight matrix construction reproducing stb_image_resize2 exactly.

Split from resize.py for clarity: this is pure host numpy, executed once
per (in_size, out_size, filter) and cached. Float32/float64 operation
order mirrors stb so the weights are bit-identical to the reference
scaler's (see timg_tpu/ops/resize.py module docstring for the spec).
"""

from __future__ import annotations

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
