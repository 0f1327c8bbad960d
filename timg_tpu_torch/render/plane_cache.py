"""Device-resident windows (counterpart of timg_tpu/render/
plane_cache.py: prime_sixel_video_device, prime_block_video_device,
prime_sixel_planes and prime_block_planes).

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

The pixel window (kitty and iTerm2 sessions) runs the same convert and
resize and nothing else: the PNG encode stays on the host, as in the
JAX package, and each frame's words cross to the host lazily, when the
canvas's compression-pool worker encodes it.

With ``resample="sws"`` (``--resample=sws-bitexact``) every video
window makes its words with the swscale-exact kernel
(ops/sws_resize.py) instead of the convert and the resize.

The frames handed to the sink are DeviceFrame placeholders: the canvas
needs only their shape and the primed planes, so the RGBA words stay on
the device unless someone converts a frame to an array.

The RGBA windows (stills, animations, scroll windows; the JAX module's
``prime_sixel_planes`` and ``prime_block_planes``) take frames that are
already resized and composed, stacked on the device: the sixel window
pads them to a multiple of 6 rows with background rows and runs the
session's dither (cube, the tree built from the first frame, or each
frame's libsixel palette with the bucket tables and the table kernel),
then the transport; the block window runs the block cells with the
window diff.  There is no host route for small windows: every window
runs on ``backend.device()``.  A one-shot libsixel still is the
exception the JAX package makes too: the canvas quantizes it with
libsixel's own C quantizer, as the reference does.

With more than one card (``--devices``, parallel/auto.py) the video
device windows step aside, as the JAX package's do: the video source
then converts and resizes each window sharded over the cards, fetches
the frames, and the RGBA window primers run the dither or the block
cells of each shard of frames on its own card; each shard's index planes
go through the transport on that card.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from timg_tpu_torch import tracing
from timg_tpu_torch.native import runtime as native_runtime
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
from timg_tpu_torch.ops.sws_resize import sws_yuv420_to_rgba_words
from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words
from timg_tpu_torch.parallel import auto
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

    def clear(self) -> None:
        """Drop every entry (the resident server's end of a request)."""
        self._entries.clear()


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
    the resize's own, cached per geometry (ops/resize_kernel.py); with
    ``resample="sws"`` the swscale-exact kernel makes the words in one
    step, its plan's tables cached per geometry (ops/sws_kernel.py)."""

    def __init__(self, th: int, tw: int, full_range: bool, padded_h: int,
                 bg_word: int, resample: str = "lean"):
        super().__init__()
        self.th, self.tw = th, tw
        self.full_range = full_range
        self.padded_h = padded_h
        self.bg_word = bg_word
        self.resample = resample

    def forward(self, y: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        if self.resample == "sws":
            words = sws_yuv420_to_rgba_words(y, u, v, self.th, self.tw,
                                             self.full_range)
        else:
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
    (index plane, palette, quantizer) in SIXEL_PLANES for the canvas, or
    None in a session sharded over cards.
    ``state`` (owned by the source) keeps the VideoStage of the current
    geometry and, for ``adaptive``, the tree of the video."""
    mode = getattr(options, "sixel_batch_dither", None)
    if mode not in ("cube", "libsixel", "adaptive"):
        raise not_ported(f"--dither={mode}")
    if auto.data_devices() is not None:
        return None       # sharded sessions take the RGBA window primers
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
                         bg_word, resample)      # [B, padded_h, tw]
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
                 full_range: bool, padded_h: int, bg_word: int,
                 resample: str = "lean") -> torch.Tensor:
    """The window's planes to the device (numpy planes; tensors stay on
    their own device, as a shard on its card), through the VideoStage of
    this geometry (kept in ``state``): [B, padded_h, tw] int32 words."""
    dev = backend.device()
    key = (ys.shape[1], ys.shape[2], th, tw, full_range, padded_h, bg_word,
           resample, dev)
    stage = state.get("video_stage")
    if stage is None or stage[0] != key:
        stage = (key, VideoStage(th, tw, full_range, padded_h, bg_word,
                                 resample))
        state["video_stage"] = stage
    with tracing.span("window.stage") as s:
        planes = [p if isinstance(p, torch.Tensor) else
                  torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in (ys, us, vs)]
        s.count = sum(p.nbytes for p in (ys, us, vs)
                      if not isinstance(p, torch.Tensor))
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
    renders one by one (widened as the reference reads them), and in a
    session sharded over cards."""
    if options.cell_x_px > 2 or options.cell_y_px != 2:
        return None
    quarter = options.cell_x_px == 2
    if quarter and tw % 2:
        return None
    if auto.data_devices() is not None:
        return None
    b = ys.shape[0]
    use_upper = get_bool_env("TIMG_USE_UPPER_BLOCK")
    ph = th + th % 2
    top = 1 if (th % 2 and not use_upper) else 0   # blank row on top

    words = stage_window(state, ys, us, vs, th, tw, full_range, th, 0,
                         resample)
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


def prime_pixel_video_device(ys, us, vs, th: int, tw: int,
                             full_range: bool, options, state: dict,
                             resample: str = "lean"):
    """Device window for opaque 4:2:0 video in pixel-direct (kitty and
    iTerm2) sessions (timg_tpu/render/plane_cache.py:
    prime_pixel_video_device): convert + resize (or the sws kernel) into
    [B, th, tw] words on the device, returned as B DeviceFrame
    placeholders.  The PNG encode stays on the host, as the reference
    runs it (ref kitty-canvas.cc:126-236): each frame's words cross to
    the host lazily, when the canvas's encode-pool worker reads the
    placeholder, so one frame's copy overlaps the other workers'
    deflate.

    Returns None where the window does not apply, as the JAX package
    does: sixel and block sessions (their own windows), sessions sharded
    over cards, and TIMG_TPU_VIDEO_DEVICE_WINDOW=0.  The port has no
    host or numpy mode: every window runs on ``backend.device()``."""
    if getattr(options, "sixel_batch_dither", None) is not None \
            or options.cell_y_px == 2:
        return None
    if os.environ.get("TIMG_TPU_VIDEO_DEVICE_WINDOW", "1") == "0" \
            or auto.data_devices() is not None:
        return None
    words = stage_window(state, ys, us, vs, th, tw, full_range, th, 0,
                         resample)
    return [DeviceFrame(words, i, th, tw) for i in range(ys.shape[0])]


def _dither_libsixel(words: torch.Tensor, padded_h: int, tw: int):
    """libsixel mode on a [B, padded_h, tw] window: quant.c's histogram
    samples of each padded frame (every ``sample_stride``-th pixel)
    cross to the host, which builds each frame's palette and diffuse
    flag (ops/libsixel_quant.py); the bucket tables and the dither
    run on the device.  Returns (indices, per-frame palettes)."""
    b = words.shape[0]
    stride = lsq.sample_stride(padded_h * tw)
    with tracing.span("window.fetch") as s:
        samples = words.reshape(b, -1)[:, ::stride].cpu().numpy()
        s.count = samples.nbytes
    rgb = np.stack([samples & 0xFF, (samples >> 8) & 0xFF,
                    (samples >> 16) & 0xFF], axis=-1).astype(np.uint8)
    pals, diffs = [], []
    for i in range(b):
        pal, diffuse = lsq.make_palette_from_samples(rgb[i])
        pals.append(pal)
        diffs.append(bool(diffuse))
    return table_dither(words, pals, diffs, padded_h, tw), pals


def table_dither(words: torch.Tensor, pals: list, diffs: list, h: int,
                 w: int) -> torch.Tensor:
    """libsixel's integer FS of a [B, >=h, >=w] words window on its
    device, each frame with its own palette and diffuse flag: the bucket
    tables, then the table dither -> [B, h, w] uint8 indices."""
    return _table_dither(words, torch.from_numpy(pad_palettes(pals)),
                         torch.tensor(diffs, dtype=torch.int32), h, w)


def _table_dither(words: torch.Tensor, pals: torch.Tensor,
                  diffs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``table_dither`` with the padded palettes [B, 256, 3] (channels
    in [0, 255], as the bucket kernel needs) and the int32 diffuse flags
    [B] as tensors, on any device."""
    pals_dev = pals.to(words.device)
    tables = build_bucket_tables(pals_dev)
    return fs_dither_table_fused(words, tables, palette_words(pals_dev),
                                 diffs.to(words.device), h, w, out_u8=True)


def _entries(key: tuple, fn, words: torch.Tensor, h: int, w: int,
             batch_args: tuple = (), rep_args: tuple = ()) -> list:
    """The transport's entries of ``fn(words, *batch_args, *rep_args)``,
    [B, h, w] uint8 index planes: on ``words``' device, or, in a session
    sharded over cards, each shard's planes on its card, each shard
    through the transport there."""
    b = words.shape[0]
    shards = auto.shard_batch_call(key, fn, [words, *batch_args], rep_args,
                                   fetch=False)
    if shards is None:
        return fetch_planes_or_runs(fn(words, *batch_args, *rep_args), b, h,
                                    w)
    return [e for planes in shards
            for e in fetch_planes_or_runs(planes, planes.shape[0], h, w)]


def frame_palette(frame: np.ndarray):
    """One padded [h, w, 4] frame's libsixel palette and diffuse flag:
    the native histogram and median cut over the whole frame, as the
    reference builds it per frame (ref sixel-canvas.cc:134-148), or the
    Python oracle where the native helper does not build."""
    res = native_runtime.libsixel_palette(frame)
    if res is None:
        res = lsq.make_palette(frame[..., :3])
    return res[0], bool(res[1])


def _stacked(frames: list, batch: Optional[torch.Tensor]) -> torch.Tensor:
    """The window's frames stacked on the device: ``batch`` when the
    caller has them there already, else one upload of the host frames."""
    if batch is not None:
        return batch
    with tracing.span("window.stack") as s:
        host = np.stack(frames)
        s.count = host.nbytes
    with tracing.span("window.stage", host.nbytes):
        return torch.from_numpy(host).to(backend.device())


def prime_block_planes(frames: list, options,
                       batch: Optional[torch.Tensor] = None) -> None:
    """In block sessions (cell geometry 1x2 / 2x2), the block cells of a
    window of [H, W, 4] uint8 frames (stills, animations, scroll
    windows) in one launch on the device, parked in BLOCK_PLANES for
    the canvas (timg_tpu/render/plane_cache.py:prime_block_planes).
    ``batch``: the same frames stacked on the device, if the caller has
    them there.  The cells kernel takes words, and [B, H, W, 4] uint8 is
    the same memory; the diff of each frame against the one before comes
    from the same launch."""
    if not frames or options.cell_x_px > 2 or options.cell_y_px != 2:
        return
    quarter = options.cell_x_px == 2
    if quarter and frames[0].shape[1] % 2:
        return  # odd width: the canvas widens and renders frame by frame
    use_upper = get_bool_env("TIMG_USE_UPPER_BLOCK")
    x = _stacked(frames, batch)
    b, th, tw = x.shape[:3]
    ph = th + th % 2
    top = 1 if (th % 2 and not use_upper) else 0   # blank row on top
    words = x.contiguous().view(torch.int32)[..., 0]
    cells = blocks_op.quarter_cells if quarter else blocks_op.half_cells

    def window_cells(words_):
        # the cells read an odd height's blank row by index (the
        # reference's odd-height empty-line shift, ref
        # unicode-block-canvas.cc:356-365)
        return cells(words_, use_upper, None, diff=words_.shape[0] > 1)

    shards = auto.shard_batch_call(("blocks", quarter, use_upper),
                                   window_cells, [words], fetch=False)
    if shards is None:
        shards = [window_cells(words)]
    # eq[0] of each shard compares with a blank frame and is not used:
    # the canvas diffs a shard's first frame on the host
    glyph, fg, bg, eqs = [], [], [], []
    for part in map(blocks_op.cells_to_host, shards):
        glyph.extend(part[0])
        fg.extend(part[1])
        bg.extend(part[2])
        eqs += [None] + (list(part[3][1:]) if part[3] is not None else [])
    # One padded view per frame, shared between frame i's "padded" slot
    # and frame i+1's "prev" slot: the canvas takes the device's diff
    # mask only when ``cached_prev is self._prev_padded`` (render/
    # ansi.py).
    views = [DeviceFrame(words, i, ph, tw, -top) for i in range(b)]
    prevs = [None] + views[:-1]
    for i, frame in enumerate(frames):
        BLOCK_PLANES.put(frame, (views[i], glyph[i], fg[i], bg[i], prevs[i],
                                 eqs[i]))


def prime_sixel_planes(frames: list, options, state: dict,
                       sustained: bool = False,
                       batch: Optional[torch.Tensor] = None) -> None:
    """In sixel sessions, the index planes of a window of [H, W, 4] uint8
    frames in one dispatch on the device, parked in SIXEL_PLANES for the
    canvas (timg_tpu/render/plane_cache.py:prime_sixel_planes, its
    device branch): the same strip padding and palette rules as the
    canvas's single-frame route, so the same bytes.  ``state`` is owned
    by the source and carries the adaptive tree across windows and loops
    (built once, from the first frame).  ``batch``: the same frames
    stacked on the device, if the caller has them there."""
    mode = getattr(options, "sixel_batch_dither", None)
    if not frames or mode not in ("cube", "adaptive", "libsixel"):
        return
    if mode == "libsixel" and len(frames) == 1 and not sustained:
        # a one-shot still keeps libsixel's own quantizer, run by the
        # canvas in its compression pool (sixel_render._enqueue_libsixel)
        return
    h, w = frames[0].shape[:2]
    padded_h = h + 5 - (h + 5) % 6                 # round up to sixel 6
    x = _stacked(frames, batch)
    if padded_h > h:
        pad = torch.zeros((x.shape[0], padded_h - h, w, 4), dtype=torch.uint8,
                          device=x.device)
        bg = options.bgcolor_getter() if options.bgcolor_getter else None
        if bg is not None and bg[3] != 0:
            pad[..., :3] = torch.tensor(list(bg[:3]), dtype=torch.uint8,
                                        device=x.device)
            pad[..., 3] = 255
        x = torch.cat([x, pad], dim=1)
    words = x.contiguous().view(torch.int32)[..., 0]   # [B, padded_h, w]
    b = len(frames)
    if mode == "libsixel":
        with tracing.span("window.fetch", x.nbytes):
            host = x.cpu().numpy()
        pals, diffs = zip(*(frame_palette(f) for f in host))
        entries = _entries(
            ("libsixel_table",),
            lambda words_, pals_, diffs_: _table_dither(
                words_, pals_, diffs_, padded_h, w),
            words, padded_h, w,
            batch_args=(torch.from_numpy(pad_palettes(pals)),
                        torch.tensor(diffs, dtype=torch.int32)))
        palettes, quantizer = list(pals), None
    elif mode == "cube":
        entries = _entries(
            ("sixel_cube",),
            lambda words_: fs_dither_cube_fused(words_, padded_h, w,
                                                out_u8=True),
            words, padded_h, w)
        palettes, quantizer = [None] * b, None
    else:
        quantizer = state.get("quantizer")
        if quantizer is None:
            quantizer = median_cut_tree(x[0, ..., :3].cpu().numpy())
            state["quantizer"] = quantizer
        palette, levels, leaves = quantizer
        entries = _entries(
            ("sixel_tree",),
            lambda words_, levels_, leaves_: fs_dither_tree_fused(
                words_, levels_, leaves_, padded_h, w, out_u8=True),
            words, padded_h, w,
            rep_args=(torch.from_numpy(levels), torch.from_numpy(leaves)))
        palettes = [palette] * b
    for i, frame in enumerate(frames):
        SIXEL_PLANES.put(frame, (entries[i], palettes[i], quantizer))
