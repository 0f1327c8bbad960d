"""Pillow-backed generalist image decoder (counterpart of
timg_tpu/sources/pil_source.py).

Covers the decode roles of the reference's stb / turbojpeg /
GraphicsMagick image sources (ref src/stb-image-source.cc,
src/jpeg-source.cc, src/graphics-magick-source.cc): decode to RGBA on
the host, EXIF-orient, crop, then hand the whole frame stack to the
device (resize + alpha-compose batched over animation frames, then the
session's planes).  Everything after decode runs on
``backend.device()``: the JAX package's routing of small one-shot work
to its numpy mirrors (``prefer_host``) has no counterpart here.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.ops import backend
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import ImageSource, PreprocessedFrame


def _to_rgba(img) -> np.ndarray:
    """PIL image -> RGBA uint8 array.

    High-bit-depth grayscale needs care: PIL loads 16-bit gray PNGs as
    mode "I"/"I;16" and its convert() CLIPS the 16-bit values at 255
    (the image comes out white).  The reference's stb reduces 16->8 by
    taking the high byte (stb_image stbi__convert_16_to_8, v >> 8) --
    do the same.

    32-bit BI_RGB BMPs: stb reads the 4th byte as alpha and falls back
    to opaque only when the whole alpha plane is zero; PIL drops the
    byte entirely (raw mode BGRX).  Re-wire the raw decoder to BGRA
    before the lazy load so the golden BMP-with-alpha case matches the
    reference byte-for-byte."""
    if getattr(img, "format", None) == "BMP" and img.mode == "RGB" \
            and getattr(img, "tile", None):
        # The rewire mutates img.tile and the Pillow-internal _mode
        # before the lazy load; roll both back on any failure so the
        # convert() fallback below never re-loads a poisoned tile
        # (Pillow releases where mode is not backed by _mode would
        # otherwise raise outside this try).
        orig_tile = list(img.tile)
        had_mode_attr = "_mode" in vars(img)
        orig_mode_attr = getattr(img, "_mode", None)
        try:
            decoder, extents, offset, args = img.tile[0]
            if decoder == "raw" and args and args[0] == "BGRX":
                img.tile = [(decoder, extents, offset,
                             ("BGRA",) + tuple(args[1:]))]
                img._mode = "RGBA"
                arr = np.asarray(img).copy()
                if not arr[..., 3].any():
                    arr[..., 3] = 255    # stb: all-zero alpha -> opaque
                return arr
        except Exception:  # pragma: no cover - fall back to convert()
            img.tile = orig_tile
            if had_mode_attr:
                img._mode = orig_mode_attr
            elif "_mode" in vars(img):
                del img._mode
    if img.mode in ("I", "I;16", "I;16L", "I;16B", "I;16N"):
        arr = np.asarray(img, dtype=np.int64)
        # I;16* is always 16-bit; bare "I" is a 32-bit container that
        # PNG 16-bit grayscale loads into.  Decide by mode/format, not
        # by the data (stb shifts even an all-dark 16-bit image).
        if img.mode != "I" or img.format == "PNG":
            arr = arr >> 8
        g = np.clip(arr, 0, 255).astype(np.uint8)
        a = np.full_like(g, 255)
        return np.dstack([g, g, g, a])
    return np.asarray(img.convert("RGBA"))


def _ico_contained_images(img) -> list:
    """All images inside a .ico container, in file order.

    The reference's GM build reads an .ico as multiple independent
    images and shows every one (graphics-magick-source.cc:193-200
    blacklists .ico from animation treatment, so each renders as its
    own immediate frame).  Pillow sorts its entry table by size, so
    container order is recovered through the stored entry offsets."""
    ico = getattr(img, "ico", None)
    if ico is None:
        return []
    try:
        entries = ico.entry

        def offset(e):
            return e.offset if hasattr(e, "offset") else e["offset"]

        order = sorted(range(len(entries)), key=lambda i: offset(entries[i]))
        return [ico.frame(i) for i in order]
    except Exception:
        return []


def _coalesce_frames(raw_frames: List[np.ndarray]) -> List[np.ndarray]:
    """GM coalesceImages for mixed-size frame stacks: a first-frame-
    sized canvas, each frame alpha-over-composited at (0, 0) onto the
    previous coalesced result (Magick Over operator; TIFF pages are
    normally opaque, where Over degenerates to a paste)."""
    canvas_h, canvas_w = raw_frames[0].shape[:2]
    prev = np.zeros((canvas_h, canvas_w, 4), dtype=np.uint8)
    out: List[np.ndarray] = []
    for f in raw_frames:
        cur = prev.copy()
        h = min(canvas_h, f.shape[0])
        w = min(canvas_w, f.shape[1])
        src = f[:h, :w].astype(np.float32)
        dst = cur[:h, :w].astype(np.float32)
        sa = src[..., 3:4] / 255.0
        da = dst[..., 3:4] / 255.0
        oa = sa + da * (1.0 - sa)
        rgb = src[..., :3] * sa + dst[..., :3] * da * (1.0 - sa)
        with np.errstate(invalid="ignore"):
            rgb = np.where(oa > 0, rgb / np.where(oa > 0, oa, 1.0), 0.0)
        cur[:h, :w, :3] = np.clip(rgb + 0.5, 0, 255).astype(np.uint8)
        cur[:h, :w, 3] = np.clip(oa[..., 0] * 255.0 + 0.5,
                                 0, 255).astype(np.uint8)
        out.append(cur)
        prev = cur
    return out


class PILSource(ImageSource):
    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "pil"

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        from PIL import Image, ImageOps, ImageSequence

        # APNG reroute: animated PNGs go to the video decoder, which
        # owns the "APNG loops forever" default (ref
        # graphics-magick-source.cc:160-164, image-source.cc:297-326,
        # video-source.cc:277-285).  Only bail when the video decoder is
        # actually available (the port's native helper builds it apart
        # from the assembler: load_video, not load), else show it as a
        # still like a video-less reference build.
        if self.filename != "-":
            from timg_tpu_torch.sources.base import looks_like_apng
            if looks_like_apng(self.filename):
                from timg_tpu_torch.native import runtime
                if runtime.load_video() is not None:
                    return False

        if self.filename == "-":
            import io
            img = Image.open(io.BytesIO(sys.stdin.buffer.read()))
        else:
            img = Image.open(self.filename)

        if img.format == "ICO":
            contained = _ico_contained_images(img)
            if len(contained) > 1:
                return self._load_multi_images(
                    contained, options, frame_offset, frame_count)

        raw_frames: List[np.ndarray] = []
        delays: List[float] = []
        try:
            n_frames = getattr(img, "n_frames", 1)
        except OSError:  # truncated container: frame count unseekable
            n_frames = 1
        is_animation = n_frames > 1
        if is_animation:
            try:
                for frame in ImageSequence.Iterator(img):
                    delay = float(frame.info.get("duration", 0))
                    if delay < 10.0:
                        # browsers & the reference's generalist treat a
                        # sub-centisecond delay as 100 ms
                        # (ref graphics-magick-source.cc:79-82)
                        delay = 100.0
                    delays.append(delay)
                    if options.exif_rotate:
                        # the reference applies the EXIF op per frame
                        # (ref graphics-magick-source.cc:225-227)
                        frame = ImageOps.exif_transpose(frame)
                    raw_frames.append(_to_rgba(frame))
            except OSError:
                # Truncated mid-animation: salvage the frames decoded
                # so far, like the reference's stb GIF loop, which
                # stops at the first failed stbi__gif_load_next
                # (ref stb-image-source.cc:119-139) instead of
                # discarding the whole file.
                if not raw_frames:
                    raise
                delays = delays[:len(raw_frames)]
                is_animation = len(raw_frames) > 1
        else:
            true_size = img.size
            orientation = 1
            if options.exif_rotate:
                try:
                    orientation = int(img.getexif().get(0x0112) or 1)
                except Exception:
                    orientation = 1
            # DCT-domain downscale for large JPEGs (role of ref
            # jpeg-source.cc:184-195: smallest tjscalingfactor >= target
            # before decode; the exact target resample still follows).
            # Guarded to plain downscales -- no EXIF rotation (would
            # swap the target axes) and no auto-crop (trims at full
            # resolution) -- where the reference fast path applies too.
            if (img.format == "JPEG" and orientation == 1
                    and not options.auto_crop):
                tw, th, _ = calc_scale_to_fit(true_size[0], true_size[1],
                                              options)
                if (tw > 0 and th > 0 and true_size[0] >= 2 * tw
                        and true_size[1] >= 2 * th):
                    img.draft(None, (tw, th))
                    if img.size != true_size:
                        # drafted decode: report the file's real
                        # dimensions (checked here, before any EXIF
                        # transpose can also change img.size -- a
                        # rotated image must NOT report pre-rotation
                        # dims or the target aspect would be swapped)
                        self._true_orig = true_size
            if options.exif_rotate and orientation != 1:
                img = ImageOps.exif_transpose(img)
            raw_frames.append(_to_rgba(img))
            delays.append(0.0)

        if is_animation and any(f.shape[:2] != raw_frames[0].shape[:2]
                                for f in raw_frames):
            # Mixed-size frame stacks (multipage TIFF is the one PIL
            # decoder that yields them; GIF/WebP/APNG come back
            # full-canvas): GM's coalesceImages() composites every
            # frame onto the FIRST frame's canvas at its page offset
            # (none for TIFF -> 0,0), each over the previous result
            # (ref graphics-magick-source.cc:208-213).
            raw_frames = _coalesce_frames(raw_frames)

        if frame_offset > 0 and is_animation:
            raw_frames = raw_frames[frame_offset:]
            delays = delays[frame_offset:]
            if not raw_frames:
                return False

        # Crop: explicit border crop then auto-crop; animations keep
        # geometry stable so cropping is skipped (ref gm-source.cc:229-241).
        if not is_animation and options.auto_crop:
            from timg_tpu_torch.ops.autocrop import auto_crop
            raw_frames[0] = auto_crop(raw_frames[0], options.crop_border)

        self.orig_width = raw_frames[0].shape[1]
        self.orig_height = raw_frames[0].shape[0]
        if getattr(self, "_true_orig", None) is not None:
            # drafted JPEG decode: %w/%h titles and the target
            # computation use the file's real dimensions
            self.orig_width, self.orig_height = self._true_orig

        target_w, target_h, _ = calc_scale_to_fit(
            self.orig_width, self.orig_height, options)

        processed = _process_frames(raw_frames, target_w, target_h, options)
        self.frames = [
            PreprocessedFrame(frame=frm, delay_ms=d)
            for frm, d in zip(processed, delays)
        ]

        self.indentation = (
            int((options.width - target_w) / 2)
            if options.center_horizontally else 0
        )
        self.max_frames = (
            len(self.frames) if frame_count < 0
            else min(frame_count, len(self.frames))
        )
        self._options = options
        return bool(self.frames)

    def _load_multi_images(self, images, options: DisplayOptions,
                           frame_offset: int, frame_count: int) -> bool:
        """Multi-image container (.ico): every contained image shown
        stacked, each scaled to fit independently, never treated as an
        animation (ref graphics-magick-source.cc:193-214; per-image
        trim/scale loop :225-267; per-frame centering :310)."""
        raw = [_to_rgba(im) for im in images]
        self.orig_width = raw[0].shape[1]
        self.orig_height = raw[0].shape[0]
        # Frame range like the reference: truncate to offset+count,
        # then drop the offset clamped to keep at least the last image
        # (gm-source.cc:204-207, 220-223).
        if frame_count > 0 and frame_offset + frame_count < len(raw):
            raw = raw[:frame_offset + frame_count]
        if frame_offset > 0:
            raw = raw[min(frame_offset, len(raw) - 1):]

        from timg_tpu_torch.ops.autocrop import auto_crop
        self.frames = []
        for arr in raw:
            if options.auto_crop:
                arr = auto_crop(arr, options.crop_border)
            tw, th, _ = calc_scale_to_fit(arr.shape[1], arr.shape[0], options)
            processed = _process_frames([arr], tw, th, options)[0]
            indent = (int((options.width - tw) / 2)
                      if options.center_horizontally else 0)
            # delay: GM images without a delay attribute get the
            # <1-centisecond -> 100 ms rule (gm-source.cc:79-82); it
            # only feeds the duration cutoff for immediate frames.
            self.frames.append(PreprocessedFrame(
                frame=processed, delay_ms=100.0, indentation=indent))
        self.multi_image = True
        self.max_frames = (
            len(self.frames) if frame_count < 0
            else min(frame_count, len(self.frames)))
        self._options = options
        return bool(self.frames)

    def send_frames(self, duration_ms, loops, interrupt, sink) -> None:
        if getattr(self, "_options", None) is not None \
                and self._options.scroll_animation and self.frames:
            # Scroll mode pans the first frame (ref gm-source.cc:333-341).
            from timg_tpu_torch.sources.scroll import send_scroll_frames
            send_scroll_frames(self.frames[0].frame, self._options,
                               duration_ms, loops, interrupt, sink)
            return
        super().send_frames(duration_ms, loops, interrupt, sink)


def _process_frames(
    raw_frames: List[np.ndarray],
    target_w: int,
    target_h: int,
    options: DisplayOptions,
) -> List[np.ndarray]:
    """Device pipeline: batched resize + alpha compose + plane priming,
    one device dispatch per animation (all frames batched), vs. the
    reference's per-frame serial CPU loop (stb-image-source.cc:42-68).

    Grid sessions batch across *images*: when a GridBatchCollector is
    attached (sources/batch.py), single still frames are registered
    there and resolved lazily -- same-geometry grid cells then share one
    resize dispatch (ref decode fan-out analog src/timg.cc:946-968).
    """
    collector = getattr(options, "batch_collector", None)
    if collector is not None and len(raw_frames) == 1:
        ticket = collector.register(raw_frames[0], target_w, target_h,
                                    options)
        if ticket is not None:
            return [ticket]

    out, batch = _resize_compose(raw_frames, target_w, target_h, options)
    _prime_planes(out, options, batch)
    return out


def _resize_compose(
    raw_frames: List[np.ndarray],
    target_w: int,
    target_h: int,
    options: DisplayOptions,
) -> Tuple[List[np.ndarray], torch.Tensor]:
    """The resize + lazy-background-compose legs (no priming) on
    ``backend.device()``: the processed frames on the host, and the same
    frames stacked on the device ([N, target_h, target_w, 4] uint8) for
    the primers."""
    from timg_tpu_torch.ops.compose import alpha_compose_background
    from timg_tpu_torch.ops.resize import (input_rows, resize_batch,
                                           resize_batch_rows, resize_nearest)
    from timg_tpu_torch.parallel import auto

    dev = backend.device()
    same_size = all(f.shape == raw_frames[0].shape for f in raw_frames)
    if same_size:
        batches = [np.stack(raw_frames)]
    else:  # rare: per-frame geometry, process individually
        batches = [f[None] for f in raw_frames]

    results = []
    for batch in batches:
        needs_resize = (batch.shape[1], batch.shape[2]) != (target_h,
                                                            target_w)
        spatial = None
        if needs_resize and options.antialias:
            # Spatial sharding for very large stills: with --devices N a
            # 4K frame splits its output rows over the cards, each with
            # the input rows its taps read (parallel/auto.py policy;
            # None when it does not apply)
            in_h = batch.shape[1]
            spatial = auto.spatial_shard_call(
                ("still_resize", target_h, target_w),
                lambda band, i0, o0, o1: resize_batch_rows(
                    band, in_h, target_h, target_w, i0, o0, o1),
                batch, target_h,
                lambda o0, o1: input_rows(in_h, target_h, o0, o1))
        if spatial is not None:
            x = torch.from_numpy(spatial).to(dev)
        else:
            x = torch.from_numpy(batch).to(dev)
            if needs_resize and not options.antialias:
                # -a: nearest-neighbor sampling (the reference's GM
                # sample() path, graphics-magick-source.cc:248-254)
                x = resize_nearest(x, target_h, target_w)
            elif needs_resize:
                x = resize_batch(x, target_h, target_w)

        # Lazy background query (ref framebuffer.cc:113-121).
        if options.bgcolor_getter is not None \
                and bool((x[..., 3] != 255).any()):
            bg = options.bgcolor_getter()
            if bg[3] != 0:
                x = alpha_compose_background(
                    x, bg, options.bg_pattern_color,
                    pattern_w=options.pattern_size * options.cell_x_px,
                    pattern_h=options.pattern_size * options.cell_y_px // 2)
        results.append(x)
    stacked = torch.cat(results) if len(results) > 1 else results[0]
    return list(stacked.cpu().numpy()), stacked


def _prime_planes(out: List[np.ndarray], options: DisplayOptions,
                  batch: torch.Tensor) -> None:
    from timg_tpu_torch.render.plane_cache import (prime_block_planes,
                                                   prime_sixel_planes)
    prime_block_planes(out, options, batch=batch)
    prime_sixel_planes(out, options, {}, batch=batch)  # palette per image
