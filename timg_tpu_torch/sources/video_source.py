"""Video source of the port (counterpart of
timg_tpu/sources/video_source.py).

Behavioral spec: ref src/video-source.cc. Demux/decode happen in the
port's native helper (native/timg_video.cc, libav); frames go to the
device in windows of several frames per dispatch. Pacing semantics are
the reference's: dy=-height reposition per frame, AnimationFrame
timestamps at k/fps (:356-360), rewind-and-loop via seek (:302-307),
"videos loop once" default handled by the CLI, frame_offset skip
(:342-347).

A window holds frames of one kind:
- ``"yuv"``: when the decoded stream is 8-bit 4:2:0 the raw Y/U/V planes
  ship to the device at 1.5 bytes/pixel and the port's device flow
  converts and resizes them there, then dithers them (sixel sessions,
  render/plane_cache.prime_sixel_video_device), picks the block cells
  (half and quarter sessions, prime_block_video_device) or hands the
  words to the kitty or iTerm2 canvas, which fetches each frame in its
  encode pool (prime_pixel_video_device).  Odd-width quarter frames
  come back to the host after the resize, and the canvas renders them
  one by one.  ``--resample=sws-bitexact`` makes the words with the
  swscale-exact kernel instead of the convert and the resize.
- ``"rgba"``: other pixel formats, ``TIMG_TPU_VIDEO_RGBA=1``, a
  mid-stream frame the helper converted to RGBA, and files whose suffix
  may carry transparency (APNG, GIF; always RGBA).  The helper's
  swscale makes RGBA frames on the host; on the device the
  transparent-capable ones take the stb resize and opaque ones the lean
  resize of RGBA words (the K1 kernel), then a one-scalar probe decides
  whether any pixel is transparent, and only then is the background
  asked for (the reference's lazy query, ref framebuffer.cc:113-121)
  and composed.  ``--resample=sws-bitexact`` on such streams takes the
  host swscale below, as the JAX package does.
- ``"scaled"`` (``--resample=sws``, the reference's own video leg, ref
  video-source.cc:59-89, :352-354): the helper decodes and swscales each
  frame to the display size on the host; the device only probes,
  composes and primes.
The RGBA windows' frames then go, still on the device, to the RGBA
window primers (prime_block_planes, prime_sixel_planes) and come back
to the host once for the canvases.  The JAX package's host order for
these windows (``TIMG_TPU_VIDEO_DEVICE_WINDOW=0``) writes the same
bytes, so they ignore that setting.

In a session sharded over cards (``--devices``, parallel/auto.py) the
device windows step aside: each window's convert and resize (or sws
kernel), or its RGBA resize, runs split over the cards and comes back to
the host, and the RGBA window primers shard the dither or the block
cells in turn, as the JAX package's legacy window path does.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Callable, List

import numpy as np
import torch

from timg_tpu_torch import tracing
from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.ops import backend
from timg_tpu_torch.ops.compose import alpha_compose_background
from timg_tpu_torch.ops.resize import resize_batch, resize_video_words
from timg_tpu_torch.options import NOT_INITIALIZED, DisplayOptions
from timg_tpu_torch.parallel import auto
from timg_tpu_torch.render.plane_cache import (prime_block_planes,
                                               prime_block_video_device,
                                               prime_pixel_video_device,
                                               prime_sixel_planes,
                                               prime_sixel_video_device,
                                               stage_window)
from timg_tpu_torch.render.sequencer import SeqType
from timg_tpu_torch.sources.base import FrameSink, ImageSource

_WINDOW = 8  # frames per device dispatch


class VideoSource(ImageSource):
    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "video"
        self._handle = None
        self._lib = None
        self._options: DisplayOptions | None = None
        self._frame_offset = 0
        self._frame_count = -1
        self._fps = 25.0
        self._target = (0, 0)
        self._is_apng_like = False
        # across windows: the VideoStage, the adaptive palette, the
        # block window's tail
        self._sixel_state: dict = {}
        self._sws_device = False
        self._use_yuv = False
        self._use_sws = False
        self._full_range = False
        self._transparent_suffix = False

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        from timg_tpu_torch.native import runtime

        lib = runtime.load_video()
        if lib is None:
            return False
        path = "/dev/stdin" if self.filename == "-" else self.filename
        handle = lib.timg_video_open(path.encode())
        if not handle:
            return False
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        lib.timg_video_info(handle, ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(fps))
        self._lib = lib
        self._handle = handle
        self.orig_width, self.orig_height = w.value, h.value
        self._fps = fps.value or 25.0
        self._options = options
        self._frame_offset = frame_offset
        self._frame_count = frame_count

        if options.auto_crop:  # ref video-source.cc:221-234
            print("timg: no auto-crop for video", file=sys.stderr)

        lower = self.filename.lower()
        self._is_apng_like = lower.endswith((".png", ".apng", ".gif"))
        # transparency only considered for certain suffixes
        # (ref video-source.cc:140-150)
        self._transparent_suffix = lower.endswith(
            (".png", ".gif", ".qoi", ".apng", ".svg")) or lower == "-"

        # Raw-plane transport: 4:2:0 streams ship YUV planes to the
        # device (1.5 B/px).  Transparent-capable suffixes keep the
        # reference's RGBA path (4:2:0 carries no alpha, but their RGBA
        # compose path is the tested one).
        self._full_range = False
        self._use_yuv = False
        self._sws_device = False
        # --resample=sws: the reference's exact video leg -- decode +
        # swscale SWS_BILINEAR straight to display size in one host
        # call per frame (ref video-source.cc:59-89 + :352-354); no
        # device resize, no YUV transport.
        resample = getattr(options, "resample", "auto")
        self._use_sws = resample == "sws"
        if not self._use_sws and not self._maybe_transparent() \
                and not os.environ.get("TIMG_TPU_VIDEO_RGBA"):
            info = lib.timg_video_pix_info(handle)
            self._use_yuv = bool(info & 1)
            self._full_range = bool(info & 2)

        tw, th, _ = calc_scale_to_fit(self.orig_width, self.orig_height,
                                      options)
        self._target = (tw, th)
        if resample == "sws-bitexact":
            # the swscale-exact kernel in the same window as the lean
            # path (ops/sws_resize.py), every geometry of a 4:2:0
            # stream; the other streams take the host sws leg
            if self._use_yuv:
                self._sws_device = True
            else:
                self._use_sws = True
        self.indentation = (
            int((options.width - tw) / 2)
            if options.center_horizontally else 0
        )
        return True

    def is_animation_before_frame_limit(self) -> bool:
        return True

    def _maybe_transparent(self) -> bool:
        return self._transparent_suffix

    def default_loops(self) -> int:
        """Videos loop once, APNG forever (ref video-source.cc:277-285)."""
        return -1 if self._is_apng_like else 1

    def __del__(self):
        if self._handle and self._lib:
            self._lib.timg_video_close(self._handle)
            self._handle = None

    def _process_window(self, raw: List, kind: str = "rgba"
                        ) -> List[np.ndarray]:
        """One device window of ``kind`` (module docstring): "yuv": raw =
        list of (y, u, v) plane triples; "rgba": [H, W, 4] uint8 frames
        at the stream's size; "scaled": [th, tw, 4] uint8 frames at the
        display size."""
        with tracing.span("window", len(raw)):
            if kind == "yuv":
                return self._yuv_window(raw)
            with tracing.span("window.stack") as s:
                arr = np.stack(raw)
                s.count = arr.nbytes
            tw, th = self._target
            resized = None
            if kind == "rgba":
                resized = auto.shard_batch_call(
                    ("video_resize_batch" if self._maybe_transparent()
                     else "video_resize_words", th, tw), self._resize,
                    [arr])
            host = arr if resized is None else resized
            with tracing.span("window.stage", host.nbytes):
                x = torch.from_numpy(host).to(backend.device())
            if kind == "rgba" and resized is None:
                x = self._resize(x)
            # "scaled": the host swscale made display-size frames already
            x = self._composed(x)
            with tracing.span("window.fetch") as s:
                frames = x.cpu().numpy()
                s.count = frames.nbytes
            return self._prime_and_list(list(frames), x)

    def _resize(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 4] uint8 frames on the device -> the display size."""
        tw, th = self._target
        if self._maybe_transparent():
            return resize_batch(x, th, tw)          # stb-exact
        # opaque codecs: the lean resize (the reference's video path
        # swscales here, ref video-source.cc:352, so the stb-exact
        # pipeline isn't the parity target) of RGBA words, a free view of
        # the contiguous frames (R in the low byte)
        words = resize_video_words(x.view(torch.int32)[..., 0], th, tw)
        return words.unsqueeze(-1).view(torch.uint8)

    def _composed(self, x: torch.Tensor) -> torch.Tensor:
        """Lazy background query (ref framebuffer.cc:113-121): one scalar
        says whether any pixel of the window is transparent; only then
        is the background asked for (it may query the terminal) and
        composed on the resident frames."""
        opts = self._options
        if opts.bgcolor_getter is None \
                or not bool((x[..., 3] != 255).any()):
            return x
        return alpha_compose_background(
            x, opts.bgcolor_getter(), opts.bg_pattern_color,
            pattern_w=opts.pattern_size * opts.cell_x_px,
            pattern_h=opts.pattern_size * opts.cell_y_px // 2)

    def _prime_and_list(self, frames: List[np.ndarray],
                        batch: torch.Tensor) -> List[np.ndarray]:
        """The RGBA window primers on ``frames``, stacked on the device
        as ``batch``."""
        opts = self._options
        prime_block_planes(frames, opts, batch=batch)
        # sustained: libsixel windows take the table dither even for a
        # one-frame window, as the JAX package's video windows do
        prime_sixel_planes(frames, opts, self._sixel_state, sustained=True,
                           batch=batch)
        return frames

    def _yuv_window(self, raw: List) -> List[np.ndarray]:
        tw, th = self._target
        opts = self._options
        state = self._sixel_state
        resample = "sws" if self._sws_device else "lean"
        with tracing.span("window.stack") as s:
            ys = np.stack([f[0] for f in raw])
            us = np.stack([f[1] for f in raw])
            vs = np.stack([f[2] for f in raw])
            s.count = ys.nbytes + us.nbytes + vs.nbytes
        if getattr(opts, "sixel_batch_dither", None) is not None:
            fast = prime_sixel_video_device(ys, us, vs, th, tw,
                                            self._full_range, opts, state,
                                            resample=resample)
        else:
            fast = prime_block_video_device(ys, us, vs, th, tw,
                                            self._full_range, opts, state,
                                            resample=resample)
            if fast is None:
                fast = prime_pixel_video_device(ys, us, vs, th, tw,
                                                self._full_range, opts,
                                                state, resample=resample)
        if fast is not None:
            return fast
        # odd-width quarter frames, pixel sessions with
        # TIMG_TPU_VIDEO_DEVICE_WINDOW=0 and sessions sharded over cards:
        # converted and resized on the device(s), then fetched at once
        # (opaque: no compose) and primed as RGBA windows
        words = auto.shard_batch_call(
            ("video_" + resample, th, tw, self._full_range),
            lambda y, u, v: stage_window(state, y, u, v, th, tw,
                                         self._full_range, th, 0, resample),
            [ys, us, vs])
        if words is None:
            words = stage_window(state, ys, us, vs, th, tw, self._full_range,
                                 th, 0, resample)
            with tracing.span("window.fetch", words.nbytes):
                words = words.cpu().numpy()
        frames = list(words.view(np.uint8).reshape(words.shape + (4,)))
        return self._prime_and_list(frames, None)

    def send_frames(self, duration_ms: float, loops: int,
                    interrupt: Callable[[], bool], sink: FrameSink) -> None:
        lib, handle = self._lib, self._handle
        if handle is None:
            return
        opts = self._options
        frame_ms = 1000.0 / self._fps
        w, h = self.orig_width, self.orig_height
        nbytes = w * h * 4
        buf = ctypes.create_string_buffer(nbytes)
        use_yuv = self._use_yuv
        use_sws = self._use_sws
        ybuf = ubuf = vbuf = sbuf = None
        cw = ch = 0
        tw, th = self._target
        if use_sws:
            sbuf = ctypes.create_string_buffer(max(tw * th * 4, 4))
        elif use_yuv:
            cw, ch = (w + 1) // 2, (h + 1) // 2
            ybuf = ctypes.create_string_buffer(w * h)
            ubuf = ctypes.create_string_buffer(cw * ch)
            vbuf = ctypes.create_string_buffer(cw * ch)

        if loops == NOT_INITIALIZED:
            loops = self.default_loops()
        loop_forever = loops < 0

        # Window pipeline: decode of window k+1 overlaps the device
        # processing + emission of window k (one lookahead slot; the
        # bounded write queue provides end-to-end backpressure like the
        # reference's depth-4 queue, ref timg.cc:972 /
        # buffered-write-sequencer.cc:91-146).  Byte-identical to the
        # serial order: the duration cutoff runs on a decode-side clock
        # (sched_ms) that equals the serial path's post-flush time.
        # TIMG_TPU_NO_OVERLAP=1 restores the serial dispatch.
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        overlap = not os.environ.get("TIMG_TPU_NO_OVERLAP")
        proc_pool = ThreadPoolExecutor(max_workers=1) if overlap else None
        windows: deque = deque()

        time_ms = 0.0      # emission clock (sink timestamps)
        sched_ms = 0.0     # decode-side clock (duration cutoff)
        is_first = True
        last_height = -1

        def emit(frames):
            nonlocal time_ms, is_first, last_height
            with tracing.span("window.emit", len(frames)):
                for frame in frames:
                    time_ms += frame_ms
                    dy = -last_height if last_height > 0 else 0
                    seq = (SeqType.START_OF_ANIMATION if is_first
                           else SeqType.ANIMATION_FRAME)
                    sink(self.indentation, dy, frame, seq,
                         min(time_ms, duration_ms))
                    last_height = frame.shape[0]
                    is_first = False

        try:
            k = 0
            while (loop_forever or k < loops) and not interrupt() \
                    and sched_ms < duration_ms:
                if k > 0 and not lib.timg_video_rewind(handle):
                    break
                frames_seen = 0
                emitted = 0
                pending: List = []
                pending_kind = "rgba"

                def flush(drain: bool = False):
                    nonlocal sched_ms
                    if pending:
                        batch, kind = list(pending), pending_kind
                        pending.clear()
                        sched_ms += len(batch) * frame_ms
                        if proc_pool is not None:
                            windows.append(proc_pool.submit(
                                self._process_window, batch, kind))
                        else:
                            emit(self._process_window(batch, kind))
                    while windows and (drain or len(windows) > 1):
                        # the main thread blocked on the window's worker
                        with tracing.span("window.wait"):
                            frames = windows.popleft().result()
                        emit(frames)

                while not interrupt():
                    if use_sws:
                        ret = lib.timg_video_read_frame_scaled(
                            handle, sbuf, tw, th)
                    elif use_yuv:
                        ret = lib.timg_video_read_frame_yuv(
                            handle, ybuf, ubuf, vbuf, buf)
                    else:
                        ret = lib.timg_video_read_frame(handle, buf)
                    if ret <= 0:
                        break
                    frames_seen += 1
                    if frames_seen <= self._frame_offset:  # ref :342-347
                        continue
                    if self._frame_count >= 0 \
                            and emitted >= self._frame_count:
                        break
                    emitted += 1
                    if use_sws:
                        item = np.frombuffer(
                            sbuf, np.uint8, tw * th * 4).reshape(
                                th, tw, 4).copy()
                        kind = "scaled"
                    elif ret == 1 and use_yuv:
                        item = (np.frombuffer(ybuf, np.uint8,
                                              w * h).reshape(h, w).copy(),
                                np.frombuffer(ubuf, np.uint8,
                                              cw * ch).reshape(ch,
                                                               cw).copy(),
                                np.frombuffer(vbuf, np.uint8,
                                              cw * ch).reshape(ch,
                                                               cw).copy())
                        kind = "yuv"
                    else:
                        # ret == 2: mid-stream non-4:2:0 frame, native
                        # helper sws-converted it to RGBA as fallback
                        item = np.frombuffer(buf, np.uint8,
                                             nbytes).reshape(h, w,
                                                             4).copy()
                        kind = "rgba"
                    if pending and kind != pending_kind:
                        flush()       # homogeneous device windows only
                    pending_kind = kind
                    pending.append(item)
                    if len(pending) >= _WINDOW:
                        flush()
                    if sched_ms > duration_ms:
                        break
                flush(drain=True)
                if emitted == 0:
                    break
                k += 1
        finally:
            if proc_pool is not None:
                proc_pool.shutdown(wait=True)
