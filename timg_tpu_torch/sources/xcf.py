"""GIMP XCF decoder: flattened composite of the visible layers.

The port's copy of timg_tpu/sources/xcf.py; only the imports differ.

Fills the XCF slot of the reference's GraphicsMagick delegate
(ref graphics-magick-source.cc:156-282 -- GM's xcf.c also reads the
layer stack and flattens).  Pure numpy, jax-free.

Supported: XCF v0-v11+ (32- and 64-bit offset variants), RGB / Gray /
Indexed base types at 8-bit precision, compression None or RLE
(GIMP's defaults), per-layer alpha, opacity (integer and float
property variants), visibility, offsets, layer masks (grayscale
coverage multiplied into alpha, honoring PROP_APPLY_MASK), and
bottom-to-top "Normal" compositing.  Other layer modes composite as Normal (documented
deviation -- GM renders them; a terminal preview favors showing the
content over failing).  Higher bit-depth precisions raise the gated
conversion diagnostic.

Format notes (from the public XCF specification):
* tiles are 64x64, laid out row-major, edge tiles clipped;
* RLE encodes each channel of a tile separately with the 4-opcode
  byte stream (short run / long run / long literal / short literal);
* layer pointers appear top-first; compositing runs bottom-to-top.
"""

from __future__ import annotations

import struct

import numpy as np

_TILE = 64

_PROP_END = 0
_PROP_COLORMAP = 1
_PROP_OPACITY = 6
_PROP_VISIBLE = 8
_PROP_APPLY_MASK = 11
_PROP_COMPRESSION = 17
_PROP_OFFSETS = 15
_PROP_FLOAT_OPACITY = 33

# base type -> channels before alpha
_LAYER_CHANNELS = {0: 3, 1: 4, 2: 1, 3: 2, 4: 1, 5: 2}
_LAYER_HAS_ALPHA = {0: False, 1: True, 2: False, 3: True,
                    4: False, 5: True}


class _Reader:
    def __init__(self, data: bytes, wide_offsets: bool):
        self.d = data
        self.pos = 0
        self.wide = wide_offsets

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.d, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.d, self.pos)
        self.pos += 4
        return v

    def f32(self) -> float:
        (v,) = struct.unpack_from(">f", self.d, self.pos)
        self.pos += 4
        return v

    def offset(self) -> int:
        if self.wide:
            (v,) = struct.unpack_from(">Q", self.d, self.pos)
            self.pos += 8
            return v
        return self.u32()

    def string(self) -> str:
        n = self.u32()
        if n == 0:
            return ""
        s = self.d[self.pos:self.pos + n - 1]
        self.pos += n
        return s.decode("utf-8", "replace")

    def props(self):
        """Yield (prop_type, payload_start, length); stops after END."""
        while True:
            ptype = self.u32()
            plen = self.u32()
            start = self.pos
            if ptype == _PROP_END:
                return
            yield ptype, start, plen
            self.pos = start + plen


def _rle_decode(data: bytes, pos: int, n: int) -> tuple[np.ndarray, int]:
    """One RLE channel stream of n bytes; returns (plane, next_pos)."""
    out = np.empty(n, np.uint8)
    i = 0
    while i < n:
        if pos >= len(data):
            raise ValueError("truncated XCF RLE stream")
        op = data[pos]
        pos += 1
        if op < 127:  # short run
            run = op + 1
            out[i:i + run] = data[pos]
            pos += 1
            i += run
        elif op == 127:  # long run
            run = (data[pos] << 8) | data[pos + 1]
            out[i:i + run] = data[pos + 2]
            pos += 3
            i += run
        elif op == 128:  # long literal
            run = (data[pos] << 8) | data[pos + 1]
            pos += 2
            out[i:i + run] = np.frombuffer(data, np.uint8, run, pos)
            pos += run
            i += run
        else:  # short literal
            run = 256 - op
            out[i:i + run] = np.frombuffer(data, np.uint8, run, pos)
            pos += run
            i += run
    if i != n:
        raise ValueError("XCF RLE overrun")
    return out, pos


def _read_hierarchy(data: bytes, off: int, wide: bool,
                    compression: int) -> np.ndarray:
    r = _Reader(data, wide)
    r.pos = off
    w = r.u32()
    h = r.u32()
    bpp = r.u32()
    if not (0 < w < 65536 and 0 < h < 65536 and 1 <= bpp <= 4):
        raise ValueError("bad XCF hierarchy")
    from timg_tpu_torch.sources.gm_formats import _check_dims
    _check_dims(w, h, "XCF layer")
    level_off = r.offset()  # full-res level; lower levels are unused
    lr = _Reader(data, wide)
    lr.pos = level_off
    lw = lr.u32()
    lh = lr.u32()
    if (lw, lh) != (w, h):
        raise ValueError("XCF level geometry mismatch")
    tiles_x = (w + _TILE - 1) // _TILE
    tiles_y = (h + _TILE - 1) // _TILE
    tile_offs = []
    for _ in range(tiles_x * tiles_y):
        t = lr.offset()
        if t == 0:
            raise ValueError("short XCF tile list")
        tile_offs.append(t)
    out = np.empty((h, w, bpp), np.uint8)
    for ti, toff in enumerate(tile_offs):
        ty, tx = divmod(ti, tiles_x)
        tw = min(_TILE, w - tx * _TILE)
        th = min(_TILE, h - ty * _TILE)
        n = tw * th
        if compression == 0:
            need = n * bpp
            if len(data) < toff + need:
                raise ValueError("truncated XCF tile")
            tile = np.frombuffer(data, np.uint8, need, toff).reshape(
                th, tw, bpp)
        elif compression == 1:
            planes = []
            pos = toff
            for _c in range(bpp):
                plane, pos = _rle_decode(data, pos, n)
                planes.append(plane.reshape(th, tw))
            tile = np.stack(planes, axis=-1)
        else:
            raise RuntimeError(
                "XCF zlib/fractal compression is not supported by this "
                "build; re-export from GIMP with RLE (the default) or "
                "convert to PNG")
        out[ty * _TILE:ty * _TILE + th,
            tx * _TILE:tx * _TILE + tw] = tile
    return out


def _read_mask(data: bytes, off: int, wide: bool, compression: int,
               lw: int, lh: int) -> np.ndarray:
    """Layer mask: a channel structure (w, h, name, props, hierarchy)
    whose hierarchy is one grayscale plane.  Returns [lh, lw] float32
    coverage in [0, 1]."""
    cr = _Reader(data, wide)
    cr.pos = off
    mw = cr.u32()
    mh = cr.u32()
    if (mw, mh) != (lw, lh):
        raise ValueError("XCF mask geometry mismatch")
    cr.string()  # name
    for _ptype, _start, _plen in cr.props():
        pass  # channel opacity/visibility do not affect mask coverage
    mh_off = cr.offset()
    plane = _read_hierarchy(data, mh_off, wide, compression)
    if plane.shape[2] != 1:
        raise ValueError("XCF mask bpp mismatch")
    return plane[..., 0].astype(np.float32) / 255.0


def decode_xcf(data: bytes) -> np.ndarray:
    if len(data) < 30 or data[:9] != b"gimp xcf ":
        raise ValueError("not an XCF file")
    ver = data[9:13]
    if ver == b"file":
        version = 0
    elif ver[:1] == b"v" and ver[1:].isdigit():
        version = int(ver[1:])
    else:
        raise ValueError("unknown XCF version tag")
    wide = version >= 11

    r = _Reader(data, wide)
    r.pos = 14
    width = r.u32()
    height = r.u32()
    base_type = r.u32()
    if base_type not in (0, 1, 2):
        raise ValueError("bad XCF base type")
    if not (0 < width < 65536 and 0 < height < 65536):
        raise ValueError("bad XCF geometry")
    from timg_tpu_torch.sources.gm_formats import _check_dims
    _check_dims(width, height, "XCF")
    if version >= 4:
        precision = r.u32()
        # 8-bit precisions: 100/150 (linear/gamma); GIMP's default.
        if precision not in (100, 150):
            raise RuntimeError(
                "XCF high-precision image (>8 bit) is not supported by "
                "this build; export as PNG from GIMP")

    compression = 1  # GIMP's default when the property is absent
    colormap = None
    for ptype, start, plen in r.props():
        if ptype == _PROP_COMPRESSION and plen >= 1:
            compression = data[start]
        elif ptype == _PROP_COLORMAP:
            pr = _Reader(data, wide)
            pr.pos = start
            n_colors = pr.u32()
            if not (0 < n_colors <= 256):
                raise ValueError("bad XCF colormap")
            colormap = np.frombuffer(
                data, np.uint8, n_colors * 3, pr.pos).reshape(-1, 3)

    layer_offs = []
    while True:
        off = r.offset()
        if off == 0:
            break
        layer_offs.append(off)
    if not layer_offs:
        raise ValueError("XCF with no layers")

    canvas = np.zeros((height, width, 4), np.float32)
    # file order is top-first; composite bottom-to-top
    for loff in reversed(layer_offs):
        lr = _Reader(data, wide)
        lr.pos = loff
        lw = lr.u32()
        lh = lr.u32()
        ltype = lr.u32()
        if ltype not in _LAYER_CHANNELS:
            raise ValueError("bad XCF layer type")
        lr.string()  # name
        opacity = 255
        visible = True
        apply_mask = True
        ox = oy = 0
        for ptype, start, plen in lr.props():
            if ptype == _PROP_OPACITY and plen >= 4:
                (opacity,) = struct.unpack_from(">I", data, start)
            elif ptype == _PROP_FLOAT_OPACITY and plen >= 4:
                (fo,) = struct.unpack_from(">f", data, start)
                opacity = int(round(max(0.0, min(1.0, fo)) * 255))
            elif ptype == _PROP_VISIBLE and plen >= 4:
                (v,) = struct.unpack_from(">I", data, start)
                visible = bool(v)
            elif ptype == _PROP_APPLY_MASK and plen >= 4:
                (v,) = struct.unpack_from(">I", data, start)
                apply_mask = bool(v)
            elif ptype == _PROP_OFFSETS and plen >= 8:
                ox, oy = struct.unpack_from(">ii", data, start)
        hier_off = lr.offset()
        mask_off = lr.offset()
        if not visible or opacity == 0:
            continue
        pix = _read_hierarchy(data, hier_off, wide, compression)
        if pix.shape[2] != _LAYER_CHANNELS[ltype]:
            raise ValueError("XCF layer bpp mismatch")
        mask = None
        if mask_off and apply_mask:
            mask = _read_mask(data, mask_off, wide, compression, lw, lh)

        # expand to RGBA f32
        if ltype in (4, 5) and colormap is None:
            raise ValueError("indexed XCF layer without colormap")
        if ltype in (0, 1):
            rgb = pix[..., :3].astype(np.float32)
        elif ltype in (2, 3):
            rgb = np.repeat(pix[..., :1], 3, axis=-1).astype(np.float32)
        else:
            idx = np.clip(pix[..., 0].astype(np.intp), 0,
                          len(colormap) - 1)
            rgb = colormap[idx].astype(np.float32)
        if _LAYER_HAS_ALPHA[ltype]:
            a = pix[..., -1].astype(np.float32) / 255.0
        else:
            a = np.ones(pix.shape[:2], np.float32)
        a = a * (opacity / 255.0)
        if mask is not None:
            a = a * mask

        # clip layer extent to the canvas
        x0, y0 = max(ox, 0), max(oy, 0)
        x1, y1 = min(ox + lw, width), min(oy + lh, height)
        if x0 >= x1 or y0 >= y1:
            continue
        sx0, sy0 = x0 - ox, y0 - oy
        s_rgb = rgb[sy0:sy0 + (y1 - y0), sx0:sx0 + (x1 - x0)]
        s_a = a[sy0:sy0 + (y1 - y0),
                sx0:sx0 + (x1 - x0)][..., None]
        dst = canvas[y0:y1, x0:x1]
        dst_a = dst[..., 3:4]
        out_a = s_a + dst_a * (1.0 - s_a)
        safe = np.where(out_a > 0, out_a, 1.0)
        dst[..., :3] = (s_rgb * s_a
                        + dst[..., :3] * dst_a * (1.0 - s_a)) / safe
        dst[..., 3:4] = out_a

    out = np.empty((height, width, 4), np.uint8)
    out[..., :3] = np.clip(np.round(canvas[..., :3]), 0, 255)
    out[..., 3] = np.clip(np.round(canvas[..., 3] * 255.0), 0, 255)
    return out
