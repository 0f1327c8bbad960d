"""Fast PNG writer of the port (counterpart of timg_tpu/render/png.py):
fixed Sub filter + zlib via libdeflate.

Behavioral spec: ref src/timg-png.cc. Minimal writer: IHDR (8-bit,
color type 2/6), one IDAT compressed with libdeflate at the configured
level, filter type 1 (Sub) on every row with the first pixel raw.
libdeflate is loaded via ctypes (render/png_core.py), so the deflate
byte stream matches the reference's at equal levels; python zlib is the
fallback.  The filter and the deflate run on the host, as in the JAX
package: a kitty or iTerm2 frame's RGBA comes off the card once and is
encoded in the canvas's compression pool.
"""

from __future__ import annotations

import ctypes

import numpy as np

from timg_tpu_torch.native import runtime
from timg_tpu_torch.render.png_core import encode_png_from_filtered


def sub_filter_rows(frame: np.ndarray, with_alpha: bool) -> bytes:
    """Per-row: filter byte 1, first pixel raw, then cur-prev deltas
    (ref timg-png.cc:124-134). Note the reference copies 4 bytes for the
    first pixel but only advances 3 in RGB mode, so the alpha of pixel 0
    is overwritten by the next delta -- i.e. plain RGB of pixel 0.
    4-channel frames go through the native helper's
    ``timg_png_sub_filter`` where it builds; the numpy form is the
    fallback and serves other channel counts."""
    h, w = frame.shape[:2]
    channels = 4 if with_alpha else 3
    lib = runtime.load()
    if lib is not None and frame.shape[2] == 4:
        src = np.ascontiguousarray(frame)
        out = ctypes.create_string_buffer(h * (1 + w * channels))
        lib.timg_png_sub_filter(src.ctypes.data, h, w, channels, out)
        return out.raw
    px = frame[..., :channels].astype(np.uint8)
    delta = px.copy()
    delta[:, 1:] = px[:, 1:] - px[:, :-1]  # uint8 wraparound == C behavior
    rows = np.concatenate(
        [np.full((h, 1), 1, dtype=np.uint8),
         delta.reshape(h, w * channels)], axis=1)
    return rows.tobytes()


def encode_png(frame: np.ndarray, compression_level: int = 1,
               with_alpha: bool = False) -> bytes:
    """frame: [H, W, 4] uint8 (or anything numpy can read as one, such
    as a DeviceFrame, fetched here) -> PNG bytes (ref
    timg-png.cc:90-152)."""
    h, w = frame.shape[:2]
    raw = sub_filter_rows(np.ascontiguousarray(frame), with_alpha)
    return encode_png_from_filtered(raw, w, h, compression_level,
                                    with_alpha)
