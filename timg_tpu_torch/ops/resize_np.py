"""jax-free half of the resize op: filter kernels, tap construction,
pass-order heuristic, and the strict numpy executor.

Shared by ops/resize.py (which adds the jitted device executor). Kept
free of jax imports so the one-shot CPU CLI path never pays the jax
import. See ops/resize.py for the bit-exactness spec and citations.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import numpy as np

_SMALL_FLOAT = float(np.float32(1.0) / (1 << 20) ** 6)  # stbir__small_float


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
    from timg_tpu_torch.ops._resize_weights import build_weights

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


def apply_axis_np(x: np.ndarray, axis: int, starts: np.ndarray,
                  coeffs: np.ndarray, horizontal: bool) -> np.ndarray:
    widest = coeffs.shape[1]
    x_m = np.moveaxis(x, axis, 0)
    cshape = (-1,) + (1,) * (x_m.ndim - 1)

    def tap(t):
        return x_m[np.clip(starts + t, 0, x_m.shape[0] - 1)] * \
            coeffs[:, t].reshape(cshape)

    if horizontal and widest >= 4:
        even = tap(0)
        odd = tap(1)
        for t in range(2, widest):
            if t % 2 == 0:
                even = even + tap(t)
            else:
                odd = odd + tap(t)
        acc = even + odd
    else:
        acc = tap(0)
        for t in range(1, widest):
            acc = acc + tap(t)
    return np.moveaxis(acc, 0, axis)


def resize_batch_np(
    frames: np.ndarray,
    out_h: int,
    out_w: int,
    upsample_filter: str = STB_UPSAMPLE_FILTER,
    downsample_filter: str = STB_DOWNSAMPLE_FILTER,
    alpha_weighted: bool = True,
) -> np.ndarray:
    """Strict numpy resize, bit-exact with the device op / stb."""
    _, in_h, in_w, _ = frames.shape
    if (in_h, in_w) == (out_h, out_w):
        return np.asarray(frames)
    th = packed_taps(in_h, out_h, upsample_filter, downsample_filter, False)
    tw = packed_taps(in_w, out_w, upsample_filter, downsample_filter, True)
    vertical_first = plan_passes(in_h, in_w, out_h, out_w, upsample_filter,
                                 downsample_filter, alpha_weighted)

    # The native C executor runs the identical tap schedule with the
    # identical f32 op order (timg_native.cc:timg_resize_polyphase) at
    # ~30x the numpy speed — it is what keeps the one-shot CLI in the
    # reference's latency class (SURVEY §7 interactive constraint).
    from timg_tpu_torch.native import runtime
    native = runtime.resize_polyphase(
        frames, out_h, out_w, th[0], th[1], tw[0], tw[1],
        vertical_first, alpha_weighted)
    if native is not None:
        return native

    x = frames.astype(np.float32) * np.float32(1.0 / 255.0)
    if alpha_weighted:
        a = x[..., 3:4]
        x = np.concatenate([x, x[..., :3] * a], axis=-1)
    if vertical_first:
        x = apply_axis_np(x, 1, th[0], th[1], horizontal=False)
        x = apply_axis_np(x, 2, tw[0], tw[1], horizontal=True)
    else:
        x = apply_axis_np(x, 2, tw[0], tw[1], horizontal=True)
        x = apply_axis_np(x, 1, th[0], th[1], horizontal=False)
    if alpha_weighted:
        alpha = x[..., 3:4]
        unweighted = x[..., :3]
        premult = x[..., 4:7]
        ialpha = np.float32(1.0) / np.maximum(alpha, np.float32(_SMALL_FLOAT))
        rgb = np.where(alpha < _SMALL_FLOAT, unweighted,
                       (premult * ialpha).astype(np.float32))
        x = np.concatenate([rgb, alpha], axis=-1)
    out = np.clip(x * np.float32(255.0) + np.float32(0.5), 0.0, 255.0)
    return out.astype(np.uint8)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """GraphicsMagick SampleImage pixel mapping (the reference's
    no-antialias path, ref graphics-magick-source.cc:248-254 ->
    Magick::Image::sample): source index floor((i + 0.5) * in / out),
    clamped."""
    idx = ((np.arange(out_size) + 0.5) * in_size / out_size).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest_np(frames: np.ndarray, out_h: int,
                      out_w: int) -> np.ndarray:
    """[B, H, W, C] nearest-neighbor resample (no antialias; exact
    integer indexing, identical on every backend)."""
    ys = nearest_indices(frames.shape[1], out_h)
    xs = nearest_indices(frames.shape[2], out_w)
    return frames[:, ys][:, :, xs]
