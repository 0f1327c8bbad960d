"""Auto-crop: uniform-border detection on the device (counterpart of
timg_tpu/ops/autocrop.py).

Behavioral spec: the reference delegates to GraphicsMagick's
``Magick::Image::trim()`` (ref graphics-magick-source.cc:231-241): rows
and columns equal to the corner color are removed from the edges.  Here
it is a pair of row/column uniformity reductions in torch ops on the
frame's device; only the four bounds come back to the host, which slices
(the result's shape depends on the data).  There is no host route for
small frames: every frame is reduced on ``backend.device()``.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from timg_tpu_torch.ops import backend


def _trim_bounds(frame: torch.Tensor) -> torch.Tensor:
    """[H, W, 4] uint8 -> int64[4] (y0, y1, x0, x1) exclusive bounds,
    on the frame's device.  Keeps everything when no row or no column
    differs from the corner."""
    h, w = frame.shape[:2]
    same = (frame == frame[0, 0]).all(dim=-1)          # [H, W]
    row_keep = ~same.all(dim=1)                        # [H]
    col_keep = ~same.all(dim=0)                        # [W]
    ys = torch.arange(h, device=frame.device)
    xs = torch.arange(w, device=frame.device)
    any_row = row_keep.any()
    any_col = col_keep.any()
    y0 = torch.where(any_row, torch.where(row_keep, ys, h).min(), 0)
    y1 = torch.where(any_row, torch.where(row_keep, ys, -1).max() + 1, h)
    x0 = torch.where(any_col, torch.where(col_keep, xs, w).min(), 0)
    x1 = torch.where(any_col, torch.where(col_keep, xs, -1).max() + 1, w)
    return torch.stack([y0, y1, x0, x1])


def trim_rect(frame: np.ndarray) -> Tuple[int, int, int, int]:
    """Crop rectangle (y0, y1, x0, x1) of the non-uniform-border content
    of an [H, W, 4] uint8 frame, found on ``backend.device()``."""
    with warnings.catch_warnings():      # a decoder's read-only buffer:
        warnings.simplefilter("ignore")  # the reduction only reads it
        t = torch.as_tensor(frame)
    y0, y1, x0, x1 = (int(v) for v in
                      _trim_bounds(t.to(backend.device())).cpu())
    return y0, y1, x0, x1


def auto_crop(frame: np.ndarray, crop_border: int = 0) -> np.ndarray:
    """Optional pre-crop of crop_border pixels, then trim
    (ref display-options.h:62-64, timg.cc:652-657)."""
    h, w = frame.shape[:2]
    if crop_border > 0 and h > 2 * crop_border and w > 2 * crop_border:
        frame = frame[crop_border:h - crop_border,
                      crop_border:w - crop_border]
    y0, y1, x0, x1 = trim_rect(frame)
    return frame[y0:y1, x0:x1]
