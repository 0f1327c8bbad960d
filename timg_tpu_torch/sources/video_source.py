"""Video source of the port (counterpart of
timg_tpu/sources/video_source.py).

Behavioral spec: ref src/video-source.cc. Demux/decode happen in the
port's native helper (native/timg_video.cc, libav); frames go to the
device in windows of several frames per dispatch. Pacing semantics are
the reference's: dy=-height reposition per frame, AnimationFrame
timestamps at k/fps (:356-360), rewind-and-loop via seek (:302-307),
"videos loop once" default handled by the CLI, frame_offset skip
(:342-347).

When the decoded stream is 8-bit 4:2:0 the raw Y/U/V planes ship to the
device at 1.5 bytes/pixel and the port's device flow converts and
resizes them there, then dithers them (sixel sessions,
render/plane_cache.prime_sixel_video_device) or picks the block cells
(half and quarter sessions, prime_block_video_device).  Odd-width
quarter frames come back to the host after the resize, and the canvas
renders them one by one.  Streams that would take another path in the
reference (RGBA decode, transparent-capable suffixes, swscale
resampling) are not yet ported.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Callable, List

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import NOT_INITIALIZED, DisplayOptions
from timg_tpu_torch.render.plane_cache import (not_ported,
                                               prime_block_video_device,
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

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        from timg_tpu_torch.native import runtime

        resample = getattr(options, "resample", "auto")
        if resample != "auto":
            raise not_ported(f"--resample={resample}")
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
        # reference's RGBA path, which is not yet ported.
        self._full_range = False
        self._use_yuv = False
        self._use_sws = False
        if not self._maybe_transparent() \
                and not os.environ.get("TIMG_TPU_VIDEO_RGBA"):
            info = lib.timg_video_pix_info(handle)
            self._use_yuv = bool(info & 1)
            self._full_range = bool(info & 2)
        if not self._use_yuv:
            raise not_ported("video that is not opaque 8-bit 4:2:0 "
                             "(RGBA window path)")

        tw, th, _ = calc_scale_to_fit(self.orig_width, self.orig_height,
                                      options)
        self._target = (tw, th)
        self.indentation = (
            int((options.width - tw) / 2)
            if options.center_horizontally else 0
        )
        return True

    def is_animation_before_frame_limit(self) -> bool:
        return True

    def _maybe_transparent(self) -> bool:
        return getattr(self, "_transparent_suffix", False)

    def default_loops(self) -> int:
        """Videos loop once, APNG forever (ref video-source.cc:277-285)."""
        return -1 if self._is_apng_like else 1

    def __del__(self):
        if self._handle and self._lib:
            self._lib.timg_video_close(self._handle)
            self._handle = None

    def _process_window(self, raw: List, kind: str = "rgba"
                        ) -> List[np.ndarray]:
        """One device window: raw = list of (y, u, v) plane triples.
        The reference's other kinds ("rgba", "scaled") and the
        pixel-direct sessions are not yet ported."""
        if kind != "yuv":
            raise not_ported(f"the {kind!r} video window")
        tw, th = self._target
        opts = self._options
        ys = np.stack([f[0] for f in raw])
        us = np.stack([f[1] for f in raw])
        vs = np.stack([f[2] for f in raw])
        if getattr(opts, "sixel_batch_dither", None) is not None:
            return prime_sixel_video_device(ys, us, vs, th, tw,
                                            self._full_range, opts,
                                            self._sixel_state)
        fast = prime_block_video_device(ys, us, vs, th, tw, self._full_range,
                                        opts, self._sixel_state)
        if fast is not None:
            return fast
        # odd-width quarter frames: converted and resized on the device,
        # then rendered one by one by the canvas (opaque: no compose)
        words = stage_window(self._sixel_state, ys, us, vs, th, tw,
                       self._full_range, th, 0).cpu().numpy()
        return list(words.view(np.uint8).reshape(words.shape + (4,)))

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
        use_yuv = getattr(self, "_use_yuv", False)
        use_sws = getattr(self, "_use_sws", False)
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
                        emit(windows.popleft().result())

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
