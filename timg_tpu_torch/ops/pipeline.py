"""Device pipelines of the protocols (counterpart of
timg_tpu/ops/pipeline.py).

``quarter_pipeline`` and ``half_pipeline`` are the block models': the
stb-exact resize, the alpha compose when the background is not
transparent, then the block cells (the CUDA kernel on the card).
``resize_compose`` is the front half the library API's sixel model runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from timg_tpu_torch.ops import blocks as blocks_op
from timg_tpu_torch.ops import compose as compose_op
from timg_tpu_torch.ops import resize as resize_op

RGBA = Optional[Sequence[int]]


def _resized(frames: torch.Tensor, out_h: int, out_w: int, bg_color: RGBA,
             pattern_color: RGBA, pattern_w: int,
             pattern_h: int) -> torch.Tensor:
    x = resize_op.resize_batch(frames, out_h, out_w)
    if bg_color is not None and bg_color[3] != 0:
        x = compose_op.alpha_compose_background(
            x, bg_color, pattern_color or (0, 0, 0, 0),
            pattern_w=pattern_w, pattern_h=pattern_h)
    return x


def quarter_pipeline(frames: torch.Tensor, out_h: int, out_w: int,
                     bg_color: RGBA = None, pattern_color: RGBA = None,
                     pattern_w: int = 2, pattern_h: int = 1,
                     use_upper_half_block: bool = False):
    """[B, H, W, 4] uint8 -> resize -> compose -> 2x2 glyph argmin:
    (glyph int32, fg, bg uint8) planes on the frames' device.  out_h and
    out_w must be even."""
    x = _resized(frames, out_h, out_w, bg_color, pattern_color, pattern_w,
                 pattern_h)
    return blocks_op.quarter_blocks(
        x, use_upper_half_block=use_upper_half_block)


def half_pipeline(frames: torch.Tensor, out_h: int, out_w: int,
                  bg_color: RGBA = None, pattern_color: RGBA = None,
                  pattern_w: int = 1, pattern_h: int = 1,
                  use_upper_half_block: bool = False):
    """As ``quarter_pipeline`` with 1x2 cells (out_h even)."""
    x = _resized(frames, out_h, out_w, bg_color, pattern_color, pattern_w,
                 pattern_h)
    return blocks_op.half_blocks(
        x, use_upper_half_block=use_upper_half_block)


def resize_compose(frames: torch.Tensor, out_h: int, out_w: int,
                   bg_color: Sequence[int],
                   pattern_color: Sequence[int]) -> torch.Tensor:
    """[B, H, W, 4] uint8 -> [B, out_h, out_w, 4] uint8, resized and
    composed on the frames' device."""
    x = resize_op.resize_batch(frames, out_h, out_w)
    return compose_op.alpha_compose_background(x, bg_color, pattern_color)
