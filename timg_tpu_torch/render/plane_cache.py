"""Device-resident video windows (counterpart of
timg_tpu/render/plane_cache.py: prime_sixel_video_device and
prime_block_video_device).

One window of 4:2:0 frames goes host->device once as Y/U/V planes
(1.5 B/px); conversion, resize and sixel-band padding run on the device,
then the dither of the session's mode:
- ``cube``: the FS cube kernel;
- ``libsixel``: per-frame palettes from the histogram samples (fetched
  from the device, palettes built on the host), bucket tables and the
  integer table kernel on the device;
- ``adaptive``: one median-cut tree per video, built on the host from the
  window's first frame, and the tree kernel.
Only the uint8 index planes come back.

The block window (``-p quarter`` / ``-p half``) runs the same convert and
resize, then the block cells of every frame (ops/blocks.py; the CUDA
kernel on the card) with the window diff, frame 0 against the previous
window's last frame; only the glyph, fg, bg and eq planes come back.

The frames handed to the sink are DeviceFrame placeholders: the canvas
needs only their shape and the primed planes, so the RGBA words stay on
the device unless someone converts a frame to an array.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from timg_tpu_torch.ops import backend
from timg_tpu_torch.ops import blocks as blocks_op
from timg_tpu_torch.ops import libsixel_quant as lsq
from timg_tpu_torch.ops.libsixel_kernel import (build_bucket_tables,
                                                fs_dither_table_fused,
                                                pad_palettes, palette_words)
from timg_tpu_torch.ops.resize import resize_video_words
from timg_tpu_torch.ops.sixel_kernel import (fs_dither_cube_fused,
                                             fs_dither_tree_fused)
from timg_tpu_torch.ops.sixel_np import median_cut_tree
from timg_tpu_torch.ops.sixel_runs import fetch_planes_or_runs
from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words
from timg_tpu_torch.utils import get_bool_env

_MAX = 64


class PlaneCache:
    """Bounded cache carrying device-computed planes from sources to
    canvases (timg_tpu/render/plane_cache.py:PlaneCache): the source
    primes it per frame object, the canvas pops.  Strong references to
    the key objects keep ids stable; FIFO bounded."""

    def __init__(self) -> None:
        self._entries: OrderedDict[int, tuple] = OrderedDict()

    def put(self, frame: np.ndarray, value: Any) -> None:
        self._entries[id(frame)] = (frame, value)
        while len(self._entries) > _MAX:
            self._entries.popitem(last=False)

    def pop(self, frame: np.ndarray) -> Optional[Any]:
        # get-semantics: animations loop over the same frame objects
        entry = self._entries.get(id(frame))
        if entry is None:
            return None
        # The id-keying is sound only because entries hold a strong ref
        # to the key array (an id cannot be reused *while cached*).
        # Enforce that invariant instead of trusting it: an identity
        # mismatch means an id was reused after an eviction freed the
        # original -- treat as a miss rather than serving stale planes.
        if entry[0] is not frame:
            del self._entries[id(frame)]
            return None
        return entry[1]


BLOCK_PLANES = PlaneCache()
SIXEL_PLANES = PlaneCache()


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to timg_tpu_torch")


class DeviceFrame:
    """Placeholder for one frame of a device-resident window: a shape
    for the sink contract, and the pixels on demand (one device->host
    copy of that frame only).  It shows rows ``y0 .. y0 + h`` of frame
    ``i`` of the words; a row outside the words (the block window's
    odd-height pad row) reads as blank, all zero."""

    __slots__ = ("_words", "_i", "_h", "_y0", "shape", "_cache")

    def __init__(self, words_dev: torch.Tensor, i: int, h: int, tw: int,
                 y0: int = 0):
        self._words = words_dev      # [B, rows, tw] int32 on the device
        self._i = i
        self._h = h
        self._y0 = y0                # first row (-1: a blank row on top)
        self.shape = (h, tw, 4)
        self._cache = None

    def __array__(self, dtype=None, copy=None):
        if self._cache is None:
            rows = self._words.shape[1]
            lo, hi = max(self._y0, 0), min(self._y0 + self._h, rows)
            w = np.zeros(self.shape[:2], np.int32)
            w[lo - self._y0:hi - self._y0] = \
                self._words[self._i, lo:hi].cpu().numpy()
            self._cache = w.view(np.uint8).reshape(self.shape)
        a = self._cache
        if dtype is not None and np.dtype(dtype) != a.dtype:
            a = a.astype(dtype)
        return a

    def reshape(self, *shape):
        # the block canvas diffs against the previous frame on the host
        # when no device mask applies
        return self.__array__().reshape(*shape)


class VideoStage(nn.Module):
    """Convert + resize + band padding for one window geometry (the JAX
    package compiled one jit per geometry).  The resize's tap tables are
    the resize's own, cached per geometry (ops/resize_kernel.py)."""

    def __init__(self, th: int, tw: int, full_range: bool, padded_h: int,
                 bg_word: int):
        super().__init__()
        self.th, self.tw = th, tw
        self.full_range = full_range
        self.padded_h = padded_h
        self.bg_word = bg_word

    def forward(self, y: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        words = yuv420_to_rgba_words(y, u, v, self.full_range)
        words = resize_video_words(words, self.th, self.tw)
        if self.padded_h > self.th:
            pad = torch.full((words.shape[0], self.padded_h - self.th,
                              self.tw), self.bg_word, dtype=torch.int32,
                             device=words.device)
            words = torch.cat([words, pad], dim=1)
        return words


def prime_sixel_video_device(ys, us, vs, th: int, tw: int,
                             full_range: bool, options, state: dict,
                             resample: str = "lean"):
    """Fused device window for opaque 4:2:0 video in sixel sessions
    (``cube``, ``libsixel`` or ``adaptive``).

    ys/us/vs: [B, H, W] / [B, ceil(H/2), ceil(W/2)] uint8 numpy planes.
    Returns B DeviceFrame placeholders and parks each frame's
    (index plane, palette, quantizer) in SIXEL_PLANES for the canvas.
    ``state`` (owned by the source) keeps the VideoStage of the current
    geometry and, for ``adaptive``, the tree of the video."""
    mode = getattr(options, "sixel_batch_dither", None)
    if mode not in ("cube", "libsixel", "adaptive"):
        raise not_ported(f"--dither={mode}")
    if resample != "lean":
        raise not_ported("--resample=sws-bitexact")
    b = ys.shape[0]
    padded_h = th + 5 - (th + 5) % 6
    bg = options.bgcolor_getter() if options.bgcolor_getter else None
    bg_word = 0
    if padded_h > th and bg is not None and bg[3] != 0:
        bg_word = (int(bg[0]) | (int(bg[1]) << 8) | (int(bg[2]) << 16)
                   | (255 << 24))
        if bg_word >= 1 << 31:     # RGBA word with alpha set: wrap to
            bg_word -= 1 << 32     # the signed int32 the planes carry
    words = stage_window(state, ys, us, vs, th, tw, full_range, padded_h,
                         bg_word)                # [B, padded_h, tw]
    if mode == "cube":
        indices = fs_dither_cube_fused(words, padded_h, tw, out_u8=True)
        palettes, quantizer = [None] * b, None
    elif mode == "libsixel":
        indices, palettes = _dither_libsixel(words, padded_h, tw)
        quantizer = None
    else:
        quantizer = state.get("quantizer")
        if quantizer is None:
            # one tree per video, from the full first frame
            first = words[0].cpu().numpy()
            quantizer = median_cut_tree(
                first.view(np.uint8).reshape(padded_h, tw, 4)[..., :3])
            state["quantizer"] = quantizer
        palette, levels, leaves = quantizer
        indices = fs_dither_tree_fused(words, torch.from_numpy(levels),
                                       torch.from_numpy(leaves), padded_h,
                                       tw, out_u8=True)
        palettes = [palette] * b
    entries = fetch_planes_or_runs(indices, b, padded_h, tw)
    frames = [DeviceFrame(words, i, th, tw) for i in range(b)]
    for i, frame in enumerate(frames):
        SIXEL_PLANES.put(frame, (entries[i], palettes[i], quantizer))
    return frames


def stage_window(state: dict, ys, us, vs, th: int, tw: int,
                 full_range: bool, padded_h: int,
                 bg_word: int) -> torch.Tensor:
    """The window's planes to the device, through the VideoStage of this
    geometry (kept in ``state``): [B, padded_h, tw] int32 words."""
    dev = backend.device()
    key = (ys.shape[1], ys.shape[2], th, tw, full_range, padded_h, bg_word,
           dev)
    stage = state.get("video_stage")
    if stage is None or stage[0] != key:
        stage = (key, VideoStage(th, tw, full_range, padded_h, bg_word))
        state["video_stage"] = stage
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
              for p in (ys, us, vs)]
    return stage[1](*planes)


def prime_block_video_device(ys, us, vs, th: int, tw: int,
                             full_range: bool, options, state: dict,
                             resample: str = "lean"):
    """Fused device window for opaque 4:2:0 video in block sessions
    (``-p quarter`` / ``-p half``; timg_tpu/render/plane_cache.py:
    prime_block_video_device): convert + resize, then the block cells
    and the window diff of every frame on the device, fetching only the
    glyph, fg, bg and eq planes, in one copy.  The previous window's
    last frame rides along in ``state`` so the window-boundary diff is
    the device's too.

    Returns B DeviceFrame placeholders and parks each frame's planes in
    BLOCK_PLANES, or None for odd-width quarter frames, which the canvas
    renders one by one (widened as the reference reads them)."""
    if options.cell_x_px > 2 or options.cell_y_px != 2:
        return None
    quarter = options.cell_x_px == 2
    if quarter and tw % 2:
        return None
    if resample != "lean":
        raise not_ported("--resample=sws-bitexact")
    b = ys.shape[0]
    use_upper = get_bool_env("TIMG_USE_UPPER_BLOCK")
    ph = th + th % 2
    top = 1 if (th % 2 and not use_upper) else 0   # blank row on top

    words = stage_window(state, ys, us, vs, th, tw, full_range, th, 0)
    tail = state.get("block_tail")
    cells = blocks_op.quarter_cells if quarter else blocks_op.half_cells
    # one fetch of the window's cells; eq[i]: frame i vs frame i-1 or the
    # tail
    glyph, fg, bg, eq = blocks_op.cells_to_host(
        cells(words, use_upper, tail[0] if tail else None))

    frames = [DeviceFrame(words, i, th, tw) for i in range(b)]
    # One object per padded frame, shared between frame i's "padded" slot
    # and frame i+1's "prev" slot: the canvas takes the device's diff mask
    # only when ``cached_prev is self._prev_padded`` (render/ansi.py).
    padded = [DeviceFrame(words, i, ph, tw, -top) for i in range(b)]
    prevs = [tail[1] if tail else None] + padded[:-1]
    eqs = [eq[0] if tail else None] + list(eq[1:])
    for i, frame in enumerate(frames):
        BLOCK_PLANES.put(frame, (padded[i], glyph[i], fg[i], bg[i],
                                 prevs[i], eqs[i]))
    state["block_tail"] = (words[-1], padded[-1])
    return frames


def _dither_libsixel(words: torch.Tensor, padded_h: int, tw: int):
    """libsixel mode on a [B, padded_h, tw] window: quant.c's histogram
    samples of each padded frame (every ``sample_stride``-th pixel)
    cross to the host, which builds each frame's palette and diffuse
    flag (ops/libsixel_quant.py); the bucket tables and the dither
    run on the device.  Returns (indices, per-frame palettes)."""
    b = words.shape[0]
    stride = lsq.sample_stride(padded_h * tw)
    samples = words.reshape(b, -1)[:, ::stride].cpu().numpy()
    rgb = np.stack([samples & 0xFF, (samples >> 8) & 0xFF,
                    (samples >> 16) & 0xFF], axis=-1).astype(np.uint8)
    pals, diffs = [], []
    for i in range(b):
        pal, diffuse = lsq.make_palette_from_samples(rgb[i])
        pals.append(pal)
        diffs.append(bool(diffuse))
    # uint8 palettes: channels in [0, 255], as the bucket kernel needs
    pals_dev = torch.from_numpy(pad_palettes(pals)).to(words.device)
    diffs_dev = torch.tensor(diffs, dtype=torch.int32, device=words.device)
    tables = build_bucket_tables(pals_dev)
    indices = fs_dither_table_fused(words, tables, palette_words(pals_dev),
                                    diffs_dev, padded_h, tw, out_u8=True)
    return indices, pals
