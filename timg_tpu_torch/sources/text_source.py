"""Plain-text file rendering (role of the full-GM reference's TXT
coder: `timg notes.txt` shows the text as an image page).

The port's copy of timg_tpu/sources/text_source.py; only the imports differ.

The reference's GraphicsMagick build selects its TXT coder by file
suffix and rasterizes the text (graphics-magick-source.cc loads
whatever Magick++ can read); the minimal stb build errors instead.
This source renders with PIL's built-in bitmap font -- capability
parity with the full build (byte parity is meaningless across fonts).
Suffix-gated and tried last in the factory so it can never shadow a
real image decode.
"""

from __future__ import annotations

from typing import List

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import PreprocessedFrame
from timg_tpu_torch.sources.pil_source import PILSource

_TEXT_SUFFIXES = (".txt", ".text", ".log")
_MAX_LINES = 400
_MAX_COLS = 120
_MARGIN = 8


class TextSource(PILSource):
    """Subclasses PILSource for its send_frames: --scroll pans the
    rendered page exactly like any other single-frame image (the
    reference's TXT pages go through GraphicsMagickSource::SendFrames,
    which owns Scroll(), gm-source.cc:288-291)."""
    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "text"

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        if self.filename == "-" or \
                not self.filename.lower().endswith(_TEXT_SUFFIXES):
            return False
        from PIL import Image, ImageDraw, ImageFont

        try:
            with open(self.filename, "r", errors="replace") as f:
                raw = f.read(256 * 1024)
        except OSError:
            return False
        if "\0" in raw:
            return False                      # binary masquerading as .txt
        lines = [ln[:_MAX_COLS].replace("\t", "    ")
                 for ln in raw.splitlines()[:_MAX_LINES]] or [""]

        font = ImageFont.load_default()
        l, t, r, b = font.getbbox("M")
        ch_w, ch_h = max(r - l, 1), (b - t) + 4
        width = _MARGIN * 2 + ch_w * max(
            (len(ln) for ln in lines), default=1)
        height = _MARGIN * 2 + ch_h * len(lines)
        img = Image.new("RGB", (max(width, 1), max(height, 1)),
                        (255, 255, 255))
        draw = ImageDraw.Draw(img)
        for i, ln in enumerate(lines):
            draw.text((_MARGIN, _MARGIN + i * ch_h), ln,
                      fill=(0, 0, 0), font=font)

        frame = np.dstack([np.asarray(img),
                           np.full(img.size[::-1], 255, np.uint8)])
        self.orig_width, self.orig_height = img.size
        target_w, target_h, _ = calc_scale_to_fit(
            self.orig_width, self.orig_height, options)
        from timg_tpu_torch.sources.pil_source import _process_frames
        processed = _process_frames([frame], target_w, target_h, options)
        self.frames: List[PreprocessedFrame] = [
            PreprocessedFrame(frame=processed[0])]
        self.max_frames = 1
        self.indentation = (
            int((options.width - target_w) / 2)
            if options.center_horizontally else 0)
        self._options = options
        return True
