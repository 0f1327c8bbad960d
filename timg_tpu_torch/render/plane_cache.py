"""Device-resident sixel video window (counterpart of the cube branch of
timg_tpu/render/plane_cache.py:prime_sixel_video_device).

One window of 4:2:0 frames goes host->device once as Y/U/V planes
(1.5 B/px); conversion, resize, sixel-band padding and the FS cube
dither run on the device; only the uint8 index planes come back.  The
frames handed to the sink are DeviceFrame placeholders: the canvas needs
only their shape and the primed plane, so the RGBA words stay on the
device unless someone converts a frame to an array.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from timg_tpu.render.plane_cache import PlaneCache
from timg_tpu_torch.ops import backend
from timg_tpu_torch.ops.resize import axis_taps, resize_video_words
from timg_tpu_torch.ops.sixel_kernel import fs_dither_cube_fused
from timg_tpu_torch.ops.sixel_runs import fetch_planes_or_runs
from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words

# The port's own cache: the JAX package's SIXEL_PLANES is a different
# object, so the two never serve each other's planes.
SIXEL_PLANES = PlaneCache()


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to timg_tpu_torch")


class DeviceFrame:
    """Placeholder for one frame of a device-resident window: a shape
    for the sink contract, and the pixels on demand (one device->host
    copy of that frame only)."""

    __slots__ = ("_words", "_i", "_th", "shape", "_cache")

    def __init__(self, words_dev: torch.Tensor, i: int, th: int, tw: int):
        self._words = words_dev      # [B, >=th, tw] int32 on the device
        self._i = i
        self._th = th
        self.shape = (th, tw, 4)
        self._cache = None

    def __array__(self, dtype=None, copy=None):
        if self._cache is None:
            w = self._words[self._i, :self._th].cpu().numpy()
            self._cache = w.view(np.uint8).reshape(self.shape)
        a = self._cache
        if dtype is not None and np.dtype(dtype) != a.dtype:
            a = a.astype(dtype)
        return a


class VideoStage(nn.Module):
    """Convert + resize + band padding for one window geometry.

    Holds the resize tap tables as buffers on the device (the JAX
    package compiled one jit per geometry; here the state that jit
    closed over lives in the module)."""

    def __init__(self, in_h: int, in_w: int, th: int, tw: int,
                 full_range: bool, padded_h: int, bg_word: int,
                 device: torch.device):
        super().__init__()
        self.th, self.tw = th, tw
        self.full_range = full_range
        self.padded_h = padded_h
        self.bg_word = bg_word
        sv, tv = axis_taps(in_h, th, False)
        sh, thp = axis_taps(in_w, tw, True)
        self.register_buffer("starts_v", sv.to(device))
        self.register_buffer("taps_v", tv.to(device))
        self.register_buffer("starts_h", sh.to(device))
        self.register_buffer("taps_h", thp.to(device))

    def forward(self, y: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        words = yuv420_to_rgba_words(y, u, v, self.full_range)
        words = resize_video_words(words, self.th, self.tw,
                                   (self.starts_v, self.taps_v),
                                   (self.starts_h, self.taps_h))
        if self.padded_h > self.th:
            pad = torch.full((words.shape[0], self.padded_h - self.th,
                              self.tw), self.bg_word, dtype=torch.int32,
                             device=words.device)
            words = torch.cat([words, pad], dim=1)
        return words


def prime_sixel_video_device(ys, us, vs, th: int, tw: int,
                             full_range: bool, options, state: dict,
                             resample: str = "lean"):
    """Fused device window for opaque 4:2:0 video in sixel cube sessions.

    ys/us/vs: [B, H, W] / [B, ceil(H/2), ceil(W/2)] uint8 numpy planes.
    Returns B DeviceFrame placeholders and parks each frame's index
    plane in SIXEL_PLANES for the canvas.  ``state`` (owned by the
    source) keeps the VideoStage of the current geometry."""
    mode = getattr(options, "sixel_batch_dither", None)
    if mode != "cube":
        raise not_ported(f"--dither={mode}")
    if resample != "lean":
        raise not_ported("--resample=sws-bitexact")
    dev = backend.device()
    b = ys.shape[0]
    padded_h = th + 5 - (th + 5) % 6
    bg = options.bgcolor_getter() if options.bgcolor_getter else None
    bg_word = 0
    if padded_h > th and bg is not None and bg[3] != 0:
        bg_word = (int(bg[0]) | (int(bg[1]) << 8) | (int(bg[2]) << 16)
                   | (255 << 24))
        if bg_word >= 1 << 31:     # RGBA word with alpha set: wrap to
            bg_word -= 1 << 32     # the signed int32 the planes carry
    key = (ys.shape[1], ys.shape[2], th, tw, full_range, padded_h, bg_word,
           dev)
    stage = state.get("video_stage")
    if stage is None or stage[0] != key:
        stage = (key, VideoStage(ys.shape[1], ys.shape[2], th, tw,
                                 full_range, padded_h, bg_word, dev))
        state["video_stage"] = stage
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
              for p in (ys, us, vs)]
    words = stage[1](*planes)
    indices = fs_dither_cube_fused(words, padded_h, tw, out_u8=True)
    entries = fetch_planes_or_runs(indices, b, padded_h, tw)
    frames = [DeviceFrame(words, i, th, tw) for i in range(b)]
    for i, frame in enumerate(frames):
        SIXEL_PLANES.put(frame, (entries[i], None, None))
    return frames
