"""Radiance HDR (.hdr / RGBE) decoder, pure numpy.

The port's copy of timg_tpu/sources/hdr_source.py; only the imports differ.

Fills the HDR role of the reference's STB fallback source
(ref src/stb-image-source.cc:140-158 with stb_image.h's
stbi__hdr_load at third_party/stb/stb_image.h:7159-7287 and the
stbi__hdr_to_ldr tone-map at :1885-1911).  The LDR conversion is
kept stb-exact so golden byte-parity holds: per channel
``trunc(clamp(f32(pow(f64(v), f64(f32(1/2.2)))) * 255 + 0.5))``
where ``v = byte * ldexp(1, e - 136)`` in float32.
"""

from __future__ import annotations

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import ImageSource, PreprocessedFrame

_SIGNATURES = (b"#?RADIANCE\n", b"#?RGBE\n")

# stb defaults: stbi__h2l_gamma_i = 1.0f/2.2f, stbi__h2l_scale_i = 1.0f
# (stb_image.h:1853-1857); the exponent is the float32 constant widened
# to double by C's pow() promotion.
_GAMMA_I = np.float64(np.float32(1.0 / 2.2))


def _rgbe_to_ldr(rgbe: np.ndarray) -> np.ndarray:
    """[...,4] uint8 RGBE -> [...,4] uint8 RGBA, stb-exact.

    rgbe->float: f1 = ldexp(1.0f, e-(128+8)); c*f1 in float32, zero
    when e == 0 (stb_image.h:7132-7157, req_comp=4 so alpha=1.0).
    float->ldr: stb_image.h:1885-1911 with default gamma/scale.
    """
    e = rgbe[..., 3].astype(np.int32)
    f1 = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    v = rgbe[..., :3].astype(np.float32) * f1[..., None]
    v = np.where((e == 0)[..., None], np.float32(0.0), v)
    z = np.power(v.astype(np.float64), _GAMMA_I).astype(np.float32)
    z = z * np.float32(255) + np.float32(0.5)
    out = np.empty(rgbe.shape[:-1] + (4,), dtype=np.uint8)
    out[..., :3] = np.clip(z, 0, 255).astype(np.uint8)  # trunc like (int)z
    out[..., 3] = 255  # alpha 1.0f * 255 + 0.5f
    return out


def _parse_header(data: bytes) -> tuple[int, int, int]:
    """Returns (width, height, offset-of-pixel-data).

    Mirrors stbi__hdr_load's token loop (stb_image.h:7173-7196):
    newline-delimited tokens until an empty line, FORMAT must be
    32-bit_rle_rgbe, then a '-Y <h> +X <w>' resolution line.
    """
    pos = data.index(b"\n") + 1  # signature token (validated by caller)
    valid = False
    while True:
        end = data.index(b"\n", pos)
        token = data[pos:end]
        pos = end + 1
        if not token:
            break
        if token == b"FORMAT=32-bit_rle_rgbe":
            valid = True
    if not valid:
        raise ValueError("unsupported HDR format")
    end = data.index(b"\n", pos)
    token = data[pos:end]
    pos = end + 1
    if not token.startswith(b"-Y "):
        raise ValueError("unsupported HDR data layout")
    fields = token.split()
    if len(fields) != 4 or fields[2] != b"+X":
        raise ValueError("unsupported HDR data layout")
    height = int(fields[1])
    width = int(fields[3])
    if width <= 0 or height <= 0:
        raise ValueError("bad HDR dimensions")
    return width, height, pos


def _decode_flat(data: bytes, pos: int, width: int, height: int,
                 first_pixel: bytes = b"") -> np.ndarray:
    npx = width * height
    lead = np.frombuffer(first_pixel, dtype=np.uint8).reshape(-1, 4)
    need = (npx - len(lead)) * 4
    body = np.frombuffer(data, dtype=np.uint8, count=min(need,
                         max(0, len(data) - pos)), offset=pos)
    body = body[: (len(body) // 4) * 4].reshape(-1, 4)
    rgbe = np.concatenate([lead, body], axis=0)
    if len(rgbe) < npx:
        # Deliberate deviation on truncated files: stb's stbi__getn does
        # NOT zero-fill at EOF (it leaves the tail of a stack buffer
        # uninitialized and the hdr loader ignores the short read), so
        # the reference's bytes here are unreproducible garbage. We
        # zero-pad instead, which is deterministic.
        pad = np.zeros((npx - len(rgbe), 4), dtype=np.uint8)
        rgbe = np.concatenate([rgbe, pad], axis=0)
    return rgbe.reshape(height, width, 4)


def decode_hdr(data: bytes) -> np.ndarray:
    """Decode a Radiance HDR byte buffer to uint8 RGBA, stb-exact."""
    if not data.startswith(_SIGNATURES):
        raise ValueError("not an HDR file")
    width, height, pos = _parse_header(data)

    if width < 8 or width >= 32768:
        # flat (non-RLE) layout, stb_image.h:7216-7225
        return _rgbe_to_ldr(_decode_flat(data, pos, width, height))

    # Adaptive-RLE scanlines (stb_image.h:7227-7283): each row starts
    # 0x02 0x02 hi lo; each of the 4 RGBE components is run-length
    # coded across the row.  A row that fails the header check makes
    # stb restart the whole image as flat data with those 4 bytes as
    # pixel zero (:7234-7245).
    rows = np.empty((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    for j in range(height):
        if pos + 4 > len(data):
            raise ValueError("truncated HDR")
        c1, c2, hi, lo = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
        if c1 != 2 or c2 != 2 or (hi & 0x80):
            return _rgbe_to_ldr(_decode_flat(
                data, pos + 4, width, height, data[pos:pos + 4]))
        pos += 4
        if (hi << 8) | lo != width:
            raise ValueError("invalid HDR scanline length")
        for k in range(4):
            i = 0
            while i < width:
                if pos >= len(data):
                    raise ValueError("truncated HDR")
                count = data[pos]
                pos += 1
                if count > 128:  # run
                    count -= 128
                    if count == 0 or count > width - i:
                        raise ValueError("bad RLE data in HDR")
                    rows[j, i:i + count, k] = data[pos]
                    pos += 1
                else:  # dump
                    if count == 0 or count > width - i:
                        raise ValueError("bad RLE data in HDR")
                    if pos + count > len(data):
                        raise ValueError("truncated HDR")
                    rows[j, i:i + count, k] = buf[pos:pos + count]
                    pos += count
                i += count
    return _rgbe_to_ldr(rows)


class HDRSource(ImageSource):
    """Radiance HDR stills: signature-gated like stb (not by suffix)."""

    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "hdr"

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        if self.filename == "-":
            return False
        try:
            with open(self.filename, "rb") as f:
                head = f.read(16)
                if not head.startswith(_SIGNATURES):
                    return False
                rgba = decode_hdr(head + f.read())
        except (OSError, ValueError):
            return False

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
