"""ImageSource interface, factory and helpers (counterpart of
timg_tpu/sources/base.py).

Behavioral spec: ref src/image-source.{h,cc}. A source loads & scales at
construction time (in the decode pool), then streams frames to a renderer
sink via ``send_frames`` honoring duration/loop limits.

The factory tries the port's decoders in the JAX package's order:
OpenSlide, QOI, Radiance HDR, SVG, PDF, PostScript, the GraphicsMagick
formats (DPX, Cineon, XWD, MIFF, RLA, XCF), Pillow (PNG, JPEG, GIF, BMP,
WebP, TIFF, ICO, ...), video, and text last.  Every decoder decodes on
the host and hands its frames to the still path on the device.
"""

from __future__ import annotations

import os
import struct
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
        from timg_tpu_torch.sources.batch import resolve_frames
        resolve_frames(self.frames)  # grid-batched stills (sources/batch.py)
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


def looks_like_apng(filename: str) -> bool:
    """Scan the first KiB of PNG chunks for acTL
    (ref image-source.cc:297-326)."""
    if not filename.lower().endswith((".png", ".apng")):
        return False
    try:
        with open(filename, "rb") as f:
            pos = 8
            while pos < 1024:
                f.seek(pos)
                buf = f.read(8)
                if len(buf) != 8:
                    break
                if buf[4:8] == b"acTL":
                    return True
                (length,) = struct.unpack(">I", buf[:4])
                pos += length + 12
    except OSError:
        return False
    return False


def create_source(
    filename: str,
    options: DisplayOptions,
    frame_offset: int = 0,
    frame_count: int = NOT_INITIALIZED,
    attempt_image_loading: bool = True,
    attempt_video_loading: bool = True,
) -> tuple[Optional[ImageSource], str]:
    """Factory: try sources in priority order, first success wins
    (ref image-source.cc:155-263). Returns (source, error_message)."""
    from timg_tpu_torch.sources.gm_formats import GMFormatsSource
    from timg_tpu_torch.sources.hdr_source import HDRSource
    from timg_tpu_torch.sources.openslide_source import OpenSlideSource
    from timg_tpu_torch.sources.pdf_source import PDFSource
    from timg_tpu_torch.sources.pil_source import PILSource
    from timg_tpu_torch.sources.ps_source import PSSource
    from timg_tpu_torch.sources.qoi_source import QOISource
    from timg_tpu_torch.sources.svg_source import SVGSource
    from timg_tpu_torch.sources.text_source import TextSource
    from timg_tpu_torch.sources.video_source import VideoSource

    candidates: list = []
    if attempt_image_loading:
        # OpenSlide first, like the reference factory priority (ref
        # image-source.cc:161-221); HDR (signature-gated) fills part of
        # the reference's stb-fallback role; PostScript before Pillow,
        # whose EpsImagePlugin also needs gs but fails without the gated
        # diagnostic hint; the suffix-gated GM formats before Pillow too
        candidates += [OpenSlideSource, QOISource, HDRSource, SVGSource,
                       PDFSource, PSSource, GMFormatsSource, PILSource]
    if attempt_video_loading:
        candidates.append(VideoSource)
    if attempt_image_loading:
        # last resort, suffix-gated: .txt rendering (role of the
        # full-GM reference's TXT coder; see sources/text_source.py)
        candidates.append(TextSource)

    count = -1 if frame_count == NOT_INITIALIZED else frame_count
    hint = ""
    for cls in candidates:
        try:
            src = cls(filename)
            if src.load_and_scale(options, frame_offset, count):
                return src, ""
        except RuntimeError as e:  # gated-feature diagnosis
            hint = str(e)
        except Exception:
            continue

    # Diagnose (ref image-source.cc:223-243).
    error = ""
    if filename != "-":
        if not os.path.exists(filename):
            error = f"{filename}: No such file or directory"
        elif os.path.isdir(filename):
            error = f"{filename}: is a directory"
        elif not os.access(filename, os.R_OK):
            error = f"{filename}: Permission denied"
    if not error and (filename == "-" or filename == "/dev/stdin"):
        # ref image-source.cc:239-243
        error = "If this is a video on stdin, use '-V' to skip image probing"
    if not error:
        from timg_tpu_torch.native import runtime
        if runtime.load_video() is None and filename.lower().endswith(
                (".mov", ".mp4", ".mkv", ".avi", ".wmv", ".webm")):
            # ref image-source.cc:245-260; the port's video decoder
            # builds apart from the assembler (native/runtime.py)
            error = (f"{filename}: looks like a video file, but the native "
                     "video helper is not built "
                     "(timg_tpu_torch/native/timg_video.cc needs the libav "
                     "headers and libraries)")
    if not error and not hint:
        # Formats only GraphicsMagick's exotic coders decode (ref
        # graphics-magick-source.cc:156-282 gets these for free; no PIL
        # equivalent exists): name the format instead of failing
        # silently, so the user learns *why* instead of guessing.
        ext = os.path.splitext(filename)[1].lower()
        if ext in _GM_ONLY_FORMATS:
            error = (f"{filename}: {ext[1:].upper()} is not supported by "
                     "this build's decoders (the reference's "
                     "GraphicsMagick delegate handles it); convert with "
                     f"`gm convert {os.path.basename(filename)} out.png`")
    if not error:
        # gated-feature diagnosis or nothing: the reference is
        # deliberately silent for a readable-but-undecodable file (its
        # generic "couldn't load" is commented out,
        # ref image-source.cc:238, and timg.cc:963 only queues
        # non-empty errors) -- exit code 1 still reports the failure
        error = hint
    return None, error


# GraphicsMagick-only long tail (ref graphics-magick-source.cc relies
# on GM's coder registry): named-diagnostic suffixes with no decoder in
# the JAX package either (timg_tpu/sources/base.py:_GM_ONLY_FORMATS).
_GM_ONLY_FORMATS = {
    ".mvg", ".viff",
    ".pict", ".pct", ".mat", ".otb", ".palm", ".pwp", ".sct", ".wpg",
}
