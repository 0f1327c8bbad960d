"""Pixels before the cells: the stb-exact resize and the alpha compose,
in NumPy.

The arithmetic is the reference viewer's as the port states it (its
module docstrings name the rounding of each step); this file computes it
again from the decoded frames, one frame at a time.
"""

from __future__ import annotations

import numpy as np

from reference.precision import F32, Precision
from reference.stb_taps import (_SMALL_FLOAT, STB_DOWNSAMPLE_FILTER,
                                STB_UPSAMPLE_FILTER, packed_taps,
                                plan_passes)

# --------------------------------------------------------------------------
# The stb-exact RGBA resize (stb_image_resize2 as the reference viewer
# configures it: u8 * f32(1/255) decode, "fancy alpha" filtering of the
# plain and the premultiplied channels, the f32 reciprocal un-weighting,
# v * 255 + 0.5 truncated).
# --------------------------------------------------------------------------

def _stb_axis(x: np.ndarray, axis: int, starts: np.ndarray,
              coeffs: np.ndarray, horizontal: bool,
              prec: Precision) -> np.ndarray:
    """Output o sums x[starts[o] + t] * coeffs[o, t] (index clamped) in
    stb's order: one ascending chain, or with >= 4 horizontal taps two
    chains of the even and the odd taps added at the end."""
    r = prec.r
    widest = coeffs.shape[1]
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = -1

    def tap(t):
        idx = np.clip(starts.astype(np.int64) + t, 0, n - 1)
        return r(np.take(x, idx, axis=axis) * coeffs[:, t].reshape(shape))

    if horizontal and widest >= 4:
        even, odd = tap(0), tap(1)
        for t in range(2, widest):
            if t % 2 == 0:
                even = r(even + tap(t))
            else:
                odd = r(odd + tap(t))
        return r(even + odd)
    acc = tap(0)
    for t in range(1, widest):
        acc = r(acc + tap(t))
    return acc


def stb_resize(frame: np.ndarray, out_h: int, out_w: int,
               prec: Precision = F32) -> np.ndarray:
    """[H, W, 4] uint8 RGBA -> [out_h, out_w, 4] uint8, alpha-weighted."""
    in_h, in_w, _ = frame.shape
    if (in_h, in_w) == (out_h, out_w):
        return frame
    r = prec.r
    up, down = STB_UPSAMPLE_FILTER, STB_DOWNSAMPLE_FILTER
    taps_h = packed_taps(in_h, out_h, up, down, False)
    taps_w = packed_taps(in_w, out_w, up, down, True)
    x = r(frame.astype(np.float32) * np.float32(1.0 / 255.0))
    x = np.concatenate([x, r(x[..., :3] * x[..., 3:4])], axis=-1)
    if plan_passes(in_h, in_w, out_h, out_w, up, down, True):
        x = _stb_axis(x, 0, *taps_h, False, prec)
        x = _stb_axis(x, 1, *taps_w, True, prec)
    else:
        x = _stb_axis(x, 1, *taps_w, True, prec)
        x = _stb_axis(x, 0, *taps_h, False, prec)
    alpha, plain, premult = x[..., 3:4], x[..., :3], x[..., 4:7]
    small = np.float32(_SMALL_FLOAT)
    ialpha = r(np.float32(1.0) / np.maximum(alpha, small))
    rgb = np.where(alpha < small, plain, r(premult * ialpha))
    x = np.concatenate([rgb, alpha], axis=-1)
    out = np.clip(r(r(x * np.float32(255.0)) + np.float32(0.5)), 0.0, 255.0)
    return out.astype(np.uint8)


def floor_sqrt(v: np.ndarray) -> np.ndarray:
    """floor(sqrt(v)) of float32 0 <= v < 65536, by bisection on exact
    squares: the reference viewer's truncated ``sqrtf`` on every value
    its repacks are fed."""
    r = np.zeros_like(v, dtype=np.float32)
    for bit in (128.0, 64.0, 32.0, 16.0, 8.0, 4.0, 2.0, 1.0):
        c = r + np.float32(bit)
        r = np.where(c * c <= v, c, r)
    return r


def compose_background(frame: np.ndarray, bg: tuple,
                       prec: Precision = F32) -> np.ndarray:
    """[H, W, 4] uint8 over an opaque ``bg`` (r, g, b, a) in the
    viewer's linear space (c -> c * c): pixels with alpha 255 stay,
    the others become sqrt((c^2 a + bg^2 (255 - a)) / 255) truncated,
    alpha 255."""
    r = prec.r
    a = frame[..., 3:4].astype(np.float32)
    src = frame[..., :3].astype(np.float32)
    bg_lin = np.asarray(bg[:3], np.float32)
    bg_lin = bg_lin * bg_lin
    blended = r(r(r(r(src * src) * a) + r(bg_lin * r(np.float32(255.0) - a)))
                / np.float32(255.0))
    blend = frame[..., 3:4] != 255
    rgb = np.where(blend, floor_sqrt(blended).astype(np.uint8), frame[..., :3])
    alpha = np.where(blend[..., 0], np.uint8(255), frame[..., 3])
    return np.concatenate([rgb, alpha[..., None]], axis=-1)
