"""Scroll animation: wraparound pan over a scaled image (counterpart of
timg_tpu/sources/scroll.py).

Behavioral spec: ref src/graphics-magick-source.cc:326-399 (Scroll):
cycle length is the LCM of per-axis step counts; each step shows the
display-window crop at offset (x_init + dx*k, y_init + dy*k) with
wraparound; negative directions start right/bottom aligned.

The reference copies W*H pixels per step on the host (:384-389); here
each window of scroll steps is made on the device as rolls of the image
(pure data movement), sliced to the display size, and primed there.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from timg_tpu_torch.ops import backend
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.render.sequencer import SeqType
from timg_tpu_torch.sources.base import FrameSink

_WINDOW = 16  # scroll steps per device dispatch


def _steps_for_axis(size: int, delta: int) -> int:
    if delta == 0:
        return 1
    return size // abs(delta) if size % abs(delta) == 0 else size


def scroll_frames(img, display_w: int, display_h: int, dx: int, dy: int,
                  start: int, count: int) -> torch.Tensor:
    """Crop windows [count, display_h, display_w, 4] for scroll steps
    start..start+count-1 of ``img`` ([H, W, 4] uint8, numpy or a tensor),
    on ``backend.device()``."""
    img_h, img_w = img.shape[:2]
    x_steps = _steps_for_axis(img_w, dx)
    y_steps = _steps_for_axis(img_h, dy)
    cycle = x_steps * y_steps // math.gcd(x_steps, y_steps)
    x_init = (img_w - display_w - dx * cycle) if dx < 0 else 0
    y_init = (img_h - display_h - dy * cycle) if dy < 0 else 0

    x_img = torch.as_tensor(img).to(backend.device())
    return torch.stack([
        torch.roll(x_img, shifts=(-(y_init + dy * k), -(x_init + dx * k)),
                   dims=(0, 1))[:display_h, :display_w]
        for k in range(start, start + count)])


def send_scroll_frames(
    img: np.ndarray,
    options: DisplayOptions,
    duration_ms: float,
    loops: int,
    interrupt: Callable[[], bool],
    sink: FrameSink,
) -> None:
    """ref graphics-magick-source.cc:328-399."""
    img = torch.as_tensor(img).to(backend.device())   # one upload
    img_h, img_w = img.shape[:2]
    display_w = min(options.width, img_w)
    display_h = min(options.height, img_h)
    dx, dy = options.scroll_dx, options.scroll_dy

    x_steps = _steps_for_axis(img_w, dx)
    y_steps = _steps_for_axis(img_h, dy)
    cycle = x_steps * y_steps // math.gcd(x_steps, y_steps)

    time_ms = 0.0
    is_first = True
    k = 0
    sixel_state: dict = {}  # adaptive palette persists across windows
    while (loops < 0 or k < loops) and not interrupt() \
            and time_ms < duration_ms:
        pos = 0
        while pos <= cycle:
            if interrupt() or time_ms > duration_ms:
                break
            count = min(_WINDOW, cycle + 1 - pos)
            batch = scroll_frames(img, display_w, display_h, dx, dy, pos,
                                  count)
            window = list(batch.cpu().numpy())
            from timg_tpu_torch.render.plane_cache import (
                prime_block_planes, prime_sixel_planes)
            # sustained: a libsixel window is primed even when it holds
            # one step
            prime_block_planes(window, options, batch=batch)
            prime_sixel_planes(window, options, sixel_state, sustained=True,
                               batch=batch)
            for frame in window:
                if interrupt() or time_ms > duration_ms:
                    break
                time_ms += options.scroll_delay_ms
                sink(0, 0 if is_first else -display_h, frame,
                     SeqType.START_OF_ANIMATION if is_first
                     else SeqType.ANIMATION_FRAME, time_ms)
                is_first = False
            pos += count
        k += 1
