"""QOI image decoder (pure Python, from the public QOI specification;
the port's copy of timg_tpu/sources/qoi_source.py).

Fills the decode role of the reference's QOIImageSource
(ref src/qoi-image-source.cc, behavior of third_party/qoi/qoi.h).
Spec: https://qoiformat.org/qoi-specification.pdf
"""

from __future__ import annotations

import struct

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import ImageSource, PreprocessedFrame

_QOI_OP_INDEX = 0x00
_QOI_OP_DIFF = 0x40
_QOI_OP_LUMA = 0x80
_QOI_OP_RUN = 0xC0
_QOI_OP_RGB = 0xFE
_QOI_OP_RGBA = 0xFF


def decode_qoi(data: bytes) -> np.ndarray:
    if len(data) < 22 or data[:4] != b"qoif":
        raise ValueError("not a QOI file")
    width, height, channels, colorspace = struct.unpack(">IIBB", data[4:14])
    if width == 0 or height == 0 or channels not in (3, 4):
        raise ValueError("bad QOI header")

    npx = width * height
    out = np.empty((npx, 4), dtype=np.uint8)
    index = [(0, 0, 0, 0)] * 64
    r, g, b, a = 0, 0, 0, 255
    p = 14
    i = 0
    dlen = len(data) - 8  # trailing 8-byte end marker
    while i < npx and p < dlen:
        b1 = data[p]
        p += 1
        if b1 == _QOI_OP_RGB:
            r, g, b = data[p], data[p + 1], data[p + 2]
            p += 3
        elif b1 == _QOI_OP_RGBA:
            r, g, b, a = data[p], data[p + 1], data[p + 2], data[p + 3]
            p += 4
        else:
            tag = b1 & 0xC0
            if tag == _QOI_OP_INDEX:
                r, g, b, a = index[b1 & 0x3F]
            elif tag == _QOI_OP_DIFF:
                r = (r + ((b1 >> 4) & 0x03) - 2) & 0xFF
                g = (g + ((b1 >> 2) & 0x03) - 2) & 0xFF
                b = (b + (b1 & 0x03) - 2) & 0xFF
            elif tag == _QOI_OP_LUMA:
                b2 = data[p]
                p += 1
                vg = (b1 & 0x3F) - 32
                r = (r + vg - 8 + ((b2 >> 4) & 0x0F)) & 0xFF
                g = (g + vg) & 0xFF
                b = (b + vg - 8 + (b2 & 0x0F)) & 0xFF
            else:  # QOI_OP_RUN
                run = (b1 & 0x3F) + 1
                out[i:i + run] = (r, g, b, a)
                i += run
                continue
        index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
        out[i] = (r, g, b, a)
        i += 1

    if i < npx:
        out[i:] = (0, 0, 0, 255)
    return out.reshape(height, width, 4)


class QOISource(ImageSource):
    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "qoi"

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        if self.filename == "-" or not self.filename.lower().endswith(".qoi"):
            return False
        with open(self.filename, "rb") as f:
            rgba = decode_qoi(f.read())

        from timg_tpu_torch.sources.pil_source import _process_frames

        self.orig_height, self.orig_width = rgba.shape[:2]
        target_w, target_h, _ = calc_scale_to_fit(
            self.orig_width, self.orig_height, options)
        processed = _process_frames([rgba], target_w, target_h, options)
        self.frames = [PreprocessedFrame(frame=processed[0])]
        self.indentation = (
            int((options.width - target_w) / 2)
            if options.center_horizontally else 0
        )
        self.max_frames = 1
        return True
