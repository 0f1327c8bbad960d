"""ImageSource interface, factory and helpers (counterpart of
timg_tpu/sources/base.py).

Behavioral spec: ref src/image-source.{h,cc}. A source loads & scales at
construction time (in the decode pool), then streams frames to a renderer
sink via ``send_frames`` honoring duration/loop limits.

The ported slices decode video only, so the factory offers the port's
VideoSource and nothing else; images fail with a "not yet ported"
message instead of reaching a decoder.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from timg_tpu_torch.options import NOT_INITIALIZED, DisplayOptions
from timg_tpu_torch.render.sequencer import SeqType

# sink(x, dy, frame, seq_type, end_of_frame_ms)
FrameSink = Callable[[int, int, np.ndarray, SeqType, float], None]


@dataclass
class PreprocessedFrame:
    """A device-processed RGBA frame ready for emission
    (ref stb-image-source.cc:42-68).

    ``indentation`` overrides the source-level centering indent for
    sources whose frames have different widths (multi-image .ico: the
    reference centers per frame, gm-source.cc:310 IndentationIfCentered)."""

    frame: np.ndarray  # [H, W, 4] uint8
    delay_ms: float = 0.0
    indentation: Optional[int] = None


class ImageSource:
    def __init__(self, filename: str):
        self.filename = filename
        self.frames: List[PreprocessedFrame] = []
        self.orig_width = 0
        self.orig_height = 0
        self.indentation = 0
        self.max_frames = 0
        self.decoder_name = "image"
        # Multiple independent images in one container (.ico) -- shown
        # stacked as immediate frames, never looped as an animation
        # (ref gm-source.cc:193-214 could_be_animation blacklist).
        self.multi_image = False

    # -- interface --
    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        raise NotImplementedError

    def is_animation_before_frame_limit(self) -> bool:
        return len(self.frames) > 1 and not self.multi_image

    def format_title(self, fmt: str) -> str:
        return format_from_parameters(
            fmt, self.filename, self.orig_width, self.orig_height,
            self.decoder_name)

    def send_frames(self, duration_ms: float, loops: int,
                    interrupt: Callable[[], bool], sink: FrameSink) -> None:
        """Stream frames with animation timing
        (ref stb-image-source.cc:172-207)."""
        # the reference first resolves grid-batched stills here
        # (sources/batch.py); no source of the port defers its frames
        last_height = -1
        is_animation = len(self.frames) > 1 and not self.multi_image
        if not is_animation:
            loops = 1
        loop_forever = loops < 0 or loops == NOT_INITIALIZED

        time_from_first_frame = 0.0
        is_first = True
        k = 0
        while ((loop_forever or k < loops) and not interrupt()
               and time_from_first_frame < duration_ms):
            for f in range(self.max_frames):
                if interrupt():
                    break
                frame = self.frames[f]
                time_from_first_frame += frame.delay_ms
                dx = (frame.indentation if frame.indentation is not None
                      else self.indentation)
                dy = -last_height if (is_animation and last_height > 0) else 0
                if is_animation:
                    seq = (SeqType.START_OF_ANIMATION if is_first
                           else SeqType.ANIMATION_FRAME)
                else:
                    seq = SeqType.FRAME_IMMEDIATE
                sink(dx, dy, frame.frame, seq,
                     min(time_from_first_frame, duration_ms))
                last_height = frame.frame.shape[0]
                if time_from_first_frame > duration_ms:
                    break
                is_first = False
            k += 1


def format_from_parameters(fmt: str, filename: str, orig_width: int,
                           orig_height: int, decoder: str) -> str:
    """%f %b %w %h %D expansion (ref image-source.cc:272-295)."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch != "%" or i >= len(fmt) - 1:
            out.append(ch)
            i += 1
            continue
        i += 1
        spec = fmt[i]
        if spec == "f":
            out.append(filename)
        elif spec == "b":
            out.append(os.path.basename(filename))
        elif spec == "w":
            out.append(str(orig_width))
        elif spec == "h":
            out.append(str(orig_height))
        elif spec == "D":
            out.append(decoder)
        else:
            out.append(spec)
        i += 1
    return "".join(out)


def create_source(
    filename: str,
    options: DisplayOptions,
    frame_offset: int = 0,
    frame_count: int = NOT_INITIALIZED,
    attempt_image_loading: bool = True,
    attempt_video_loading: bool = True,
) -> tuple[Optional[ImageSource], str]:
    """Returns (source, error_message), like the JAX package's factory."""
    from timg_tpu_torch.native import runtime
    from timg_tpu_torch.sources.video_source import VideoSource

    if filename != "-" and not os.path.exists(filename):
        return None, f"{filename}: No such file or directory"
    if attempt_video_loading:
        count = -1 if frame_count == NOT_INITIALIZED else frame_count
        src = VideoSource(filename)
        try:
            if src.load_and_scale(options, frame_offset, count):
                return src, ""
        except NotImplementedError as e:
            return None, f"{filename}: {e}"
    if runtime.load_video() is None:
        return None, (f"{filename}: the native video helper is not built "
                      "(timg_tpu_torch/native/timg_video.cc needs the libav "
                      "headers and libraries)")
    return None, (f"{filename}: not a video the native decoder opens; "
                  "images are not yet ported to timg_tpu_torch")
