"""Device pipelines of the pixel-direct protocols (counterpart of
timg_tpu/ops/pipeline.py).

``resize_compose`` is the front half the library API's sixel model runs:
the stb-exact resize, then the alpha compose against the background.
The block pipelines (``quarter_pipeline``, ``half_pipeline``) come with
the block-path slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from timg_tpu_torch.ops import compose as compose_op
from timg_tpu_torch.ops import resize as resize_op


def resize_compose(frames: torch.Tensor, out_h: int, out_w: int,
                   bg_color: Sequence[int],
                   pattern_color: Sequence[int]) -> torch.Tensor:
    """[B, H, W, 4] uint8 -> [B, out_h, out_w, 4] uint8, resized and
    composed on the frames' device."""
    x = resize_op.resize_batch(frames, out_h, out_w)
    return compose_op.alpha_compose_background(x, bg_color, pattern_color)
