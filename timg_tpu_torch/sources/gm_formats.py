"""Native decoders for the GraphicsMagick-only long tail.

The port's copy of timg_tpu/sources/gm_formats.py; only the imports differ.

The reference gets DPX/Cineon/XWD/MIFF (and more) for free from
GraphicsMagick's coder registry (ref graphics-magick-source.cc:156-282
hands any file to GM and converts the result).  This build decodes the
four most common of those formats natively (pure numpy, jax-free --
these are interactive one-shot paths):

* DPX   (SMPTE 268M): 8/10/12/16-bit RGB/RGBA/luma, packed or
        filled-to-32-bit method A/B, both endiannesses.
* Cineon (Kodak, DPX's predecessor): the universal 10-bit
        longword-filled RGB layout plus 8-bit tight packing.
* XWD   (X Window Dump): ZPixmap true color 16/24/32 bpp via the
        header's channel masks, 8 bpp pseudocolor via the colormap.
* XCF   (GIMP): flattened visible-layer composite -- see
        sources/xcf.py for the supported envelope.
* RLA   (Wavefront): 8-bit integer scanline RLE, color + matte.
* MIFF  (GM/ImageMagick native): DirectClass and PseudoClass,
        depth 8/16, compression None or RLE, matte (stored as
        *opacity*: 0 = opaque) -- the subset GM itself writes by
        default.  Zip/BZip streams raise a gated diagnostic naming the
        needed conversion.

Pixel values scale to 8 bits with round-half-up over the full code
range (v * 255 / maxval), GM's ScaleQuantumToChar behavior class.
Deviation (documented): DPX/Cineon printing-density transfer curves
are not linearized -- code values map linearly, which is also what GM
does unless explicitly asked to apply a LUT.

The remaining exotic suffixes (.pict, .viff, ...) keep the named
diagnostic in sources/base.py.
"""

from __future__ import annotations

import struct

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import ImageSource, PreprocessedFrame

# Decompression-bomb guard: a hostile header must not drive output
# allocation (the pixel-data reads are bounded by the actual file size
# via np.frombuffer, but output planes are header-sized). 64 MP covers
# any plausible still for a terminal preview.
_MAX_PIXELS = 1 << 26


def _check_dims(width: int, height: int, what: str) -> None:
    if not (0 < width < 65536 and 0 < height < 65536):
        raise ValueError(f"bad {what} geometry")
    if width * height > _MAX_PIXELS:
        raise ValueError(f"{what} image too large ({width}x{height})")


def _scale_to_u8(v: np.ndarray, bits: int) -> np.ndarray:
    """Full-range code value -> 8 bit with round-half-up."""
    if bits == 8:
        return v.astype(np.uint8)
    maxval = (1 << bits) - 1
    return ((v.astype(np.uint32) * 255 + maxval // 2) // maxval).astype(
        np.uint8)


def _to_rgba(channels: np.ndarray, bits: int, has_alpha: bool,
             alpha_is_opacity: bool = False) -> np.ndarray:
    """[H, W, C] code values -> [H, W, 4] uint8."""
    u8 = _scale_to_u8(channels, bits)
    h, w, c = u8.shape
    out = np.empty((h, w, 4), np.uint8)
    if c == 1:
        out[..., 0] = out[..., 1] = out[..., 2] = u8[..., 0]
        out[..., 3] = 255
    else:
        out[..., :3] = u8[..., :3]
        if has_alpha and c >= 4:
            a = u8[..., 3]
            out[..., 3] = (255 - a) if alpha_is_opacity else a
        else:
            out[..., 3] = 255
    return out


# --------------------------------------------------------------------------
# DPX (SMPTE 268M)
# --------------------------------------------------------------------------

_DPX_DESCRIPTORS = {6: 1, 50: 3, 51: 4, 52: 4}  # descriptor -> n components


def _unpack_filled10(data: bytes, offset: int, width: int, height: int,
                     ncomp: int, eol_pad: int, bo: str,
                     left: bool) -> np.ndarray:
    """Three 10-bit components per 32-bit word (DPX filled method A/B,
    Cineon longword packing 5/6).  ``left``: padding in the LSBs,
    components at bits 22/12/2; else padding in the MSBs (20/10/0)."""
    words_per_line = (width * ncomp + 2) // 3
    stride_w = words_per_line + (eol_pad + 3) // 4
    words = np.frombuffer(
        data, dtype=np.dtype(bo + "u4"), count=stride_w * height,
        offset=offset).reshape(height, stride_w)[:, :words_per_line]
    shifts = (22, 12, 2) if left else (20, 10, 0)
    comps = np.stack([(words >> s) & 0x3FF for s in shifts],
                     axis=-1).reshape(height, -1)[:, :width * ncomp]
    return comps.reshape(height, width, ncomp)


def decode_dpx(data: bytes) -> np.ndarray:
    if len(data) < 820:
        raise ValueError("not a DPX file (truncated header)")
    if data[:4] == b"SDPX":
        bo = ">"
    elif data[:4] == b"XPDS":
        bo = "<"
    else:
        raise ValueError("not a DPX file (bad magic)")

    (n_elements,) = struct.unpack(bo + "H", data[770:772])
    (width,) = struct.unpack(bo + "I", data[772:776])
    (height,) = struct.unpack(bo + "I", data[776:780])
    _check_dims(width, height, "DPX")
    if n_elements < 1:
        raise ValueError("DPX with no image elements")

    # image element 0 (the only one decoded; multi-element files are
    # planar exotica GM also rarely sees)
    descriptor = data[800]
    bits = data[803]
    (packing,) = struct.unpack(bo + "H", data[804:806])
    (encoding,) = struct.unpack(bo + "H", data[806:808])
    (offset,) = struct.unpack(bo + "I", data[808:812])
    (eol_pad,) = struct.unpack(bo + "I", data[812:816])
    if eol_pad == 0xFFFFFFFF:  # "undefined" per spec
        eol_pad = 0
    if descriptor not in _DPX_DESCRIPTORS:
        raise ValueError(f"unsupported DPX descriptor {descriptor}")
    if encoding not in (0, 0xFFFF):
        raise ValueError("RLE DPX not supported")
    ncomp = _DPX_DESCRIPTORS[descriptor]

    if bits == 10 and packing in (1, 2):
        comps = _unpack_filled10(data, offset, width, height, ncomp,
                                 eol_pad, bo, left=(packing == 1))
    elif bits == 12 and packing in (1, 2):
        # one 12-bit component per 16-bit word.  Method A: left
        # justified (data bits 4-15); method B: right justified.
        stride = width * ncomp + (eol_pad + 1) // 2
        v = np.frombuffer(data, dtype=np.dtype(bo + "u2"),
                          count=stride * height,
                          offset=offset).reshape(height, stride)
        v = v[:, :width * ncomp]
        comps = ((v >> 4) if packing == 1
                 else (v & 0xFFF)).reshape(height, width, ncomp)
    elif bits == 8 and packing in (0, 1, 2):
        stride = width * ncomp + eol_pad
        v = np.frombuffer(data, dtype=np.uint8, count=stride * height,
                          offset=offset).reshape(height, stride)
        comps = v[:, :width * ncomp].reshape(height, width, ncomp)
    elif bits == 16 and packing in (0, 1, 2):
        stride = width * ncomp + (eol_pad + 1) // 2
        v = np.frombuffer(data, dtype=np.dtype(bo + "u2"),
                          count=stride * height,
                          offset=offset).reshape(height, stride)
        comps = v[:, :width * ncomp].reshape(height, width, ncomp)
    else:
        raise ValueError(
            f"unsupported DPX bit depth {bits} packing {packing}")
    if descriptor == 52:  # ABGR: components stored A,B,G,R
        comps = comps[..., ::-1]
    return _to_rgba(comps, bits, ncomp == 4)


# --------------------------------------------------------------------------
# Cineon
# --------------------------------------------------------------------------

def decode_cineon(data: bytes) -> np.ndarray:
    if len(data) < 692:
        raise ValueError("not a Cineon file (truncated header)")
    if data[:4] == b"\x80\x2a\x5f\xd7":
        bo = ">"
    elif data[:4] == b"\xd7\x5f\x2a\x80":
        bo = "<"
    else:
        raise ValueError("not a Cineon file (bad magic)")
    (offset,) = struct.unpack(bo + "I", data[4:8])
    n_channels = data[193]
    if not (1 <= n_channels <= 8):
        raise ValueError("bad Cineon channel count")
    bits = data[196 + 2]
    (width,) = struct.unpack(bo + "I", data[196 + 4:196 + 8])
    (height,) = struct.unpack(bo + "I", data[196 + 8:196 + 12])
    _check_dims(width, height, "Cineon")
    interleave = data[680]
    packing = data[681]
    (eol_pad,) = struct.unpack(bo + "I", data[684:688])
    if interleave != 0:
        raise ValueError("only pixel-interleaved Cineon supported")
    ncomp = n_channels

    if bits == 10 and packing in (5, 6):
        # Kodak's universal layout: three 10-bit values per 32-bit
        # word; 5 = longword left-justified, 6 = right -- the same
        # filled-word layouts as DPX packing methods A/B.
        comps = _unpack_filled10(data, offset, width, height, ncomp,
                                 eol_pad, bo, left=(packing == 5))
        return _to_rgba(comps, 10, False)
    if bits == 8 and packing == 0:
        stride = width * ncomp + eol_pad
        v = np.frombuffer(data, dtype=np.uint8, count=stride * height,
                          offset=offset).reshape(height, stride)
        return _to_rgba(v[:, :width * ncomp].reshape(height, width, ncomp),
                        8, False)
    raise ValueError(
        f"unsupported Cineon bit depth {bits} packing {packing}")


# --------------------------------------------------------------------------
# XWD (X Window Dump)
# --------------------------------------------------------------------------

def _mask_extract(pix: np.ndarray, mask: int) -> np.ndarray:
    if mask == 0:
        return np.zeros(pix.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    width = (mask >> shift).bit_length()
    v = (pix >> shift) & (mask >> shift)
    # expand to 8 bits by bit replication (X server convention)
    if width >= 8:
        return (v >> (width - 8)).astype(np.uint8)
    out = v.astype(np.uint32)
    got = width
    while got < 8:
        out = (out << min(width, 8 - got)) | (
            v >> max(0, width - (8 - got)))
        got += width
    return out.astype(np.uint8)


def decode_xwd(data: bytes) -> np.ndarray:
    if len(data) < 100:
        raise ValueError("not an XWD file (truncated header)")
    for bo in (">", "<"):
        hdr = struct.unpack(bo + "25I", data[:100])
        if hdr[1] == 7:
            break
    else:
        raise ValueError("not an XWD file (bad version)")
    (header_size, _version, pixmap_format, _depth, width, height,
     _xoffset, byte_order, _bitmap_unit, _bit_order, _bitmap_pad,
     bits_per_pixel, bytes_per_line, _visual_class, red_mask,
     green_mask, blue_mask, _bits_per_rgb, _cmap_entries, ncolors,
     *_rest) = hdr
    _check_dims(width, height, "XWD")
    if pixmap_format != 2:
        raise ValueError("only ZPixmap XWD supported")
    pos = header_size
    cmap = None
    if ncolors:
        if ncolors > 65536:
            raise ValueError("bad XWD colormap")
        cmap = np.zeros((ncolors, 3), np.uint8)
        for i in range(ncolors):
            _pixel, r, g, b = struct.unpack(
                bo + "IHHH", data[pos:pos + 10])
            cmap[i] = (r >> 8, g >> 8, b >> 8)
            pos += 12
    need = bytes_per_line * height
    if len(data) < pos + need:
        raise ValueError("truncated XWD pixel data")
    rows = np.frombuffer(data, np.uint8, need, pos).reshape(
        height, bytes_per_line)

    pbo = ">" if byte_order == 1 else "<"
    if bits_per_pixel == 8:
        pix = rows[:, :width].astype(np.uint32)
    elif bits_per_pixel == 16:
        pix = rows[:, :width * 2].view(np.dtype(pbo + "u2"))[
            :, :width].astype(np.uint32)
    elif bits_per_pixel == 24:
        t = rows[:, :width * 3].reshape(height, width, 3).astype(np.uint32)
        pix = ((t[..., 0] << 16) | (t[..., 1] << 8) | t[..., 2]) \
            if byte_order == 1 else \
            ((t[..., 2] << 16) | (t[..., 1] << 8) | t[..., 0])
    elif bits_per_pixel == 32:
        pix = rows[:, :width * 4].view(np.dtype(pbo + "u4"))[:, :width] \
            .astype(np.uint32)
    else:
        raise ValueError(f"unsupported XWD bpp {bits_per_pixel}")

    out = np.empty((height, width, 4), np.uint8)
    if red_mask or green_mask or blue_mask:
        out[..., 0] = _mask_extract(pix, red_mask)
        out[..., 1] = _mask_extract(pix, green_mask)
        out[..., 2] = _mask_extract(pix, blue_mask)
    elif cmap is not None:
        idx = np.clip(pix, 0, len(cmap) - 1).astype(np.intp)
        out[..., :3] = cmap[idx]
    else:
        raise ValueError("XWD with neither masks nor colormap")
    out[..., 3] = 255
    return out


# --------------------------------------------------------------------------
# MIFF (GraphicsMagick / ImageMagick native)
# --------------------------------------------------------------------------

def _parse_miff_header(data: bytes):
    """Parse the key=value token stream up to the ':' terminator.
    Returns (fields, data_offset)."""
    fields = {}
    i = 0
    n = len(data)
    while i < n:
        c = data[i]
        if c == 0x3A:  # ':'
            return fields, i + 1
        if c == 0x7B:  # '{' comment block
            depth = 1
            i += 1
            while i < n and depth:
                if data[i] == 0x7B:
                    depth += 1
                elif data[i] == 0x7D:
                    depth -= 1
                i += 1
            continue
        if c in (0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x1A, 0x00):
            i += 1
            continue
        # key=value (value may be brace-quoted)
        j = i
        while j < n and data[j] not in (0x3D, 0x20, 0x09, 0x0A, 0x0D,
                                        0x0C, 0x3A):
            j += 1
        if j >= n or data[j] != 0x3D:  # not key=  -> skip token
            i = j
            continue
        key = data[i:j].decode("latin-1").lower()
        j += 1
        if j < n and data[j] == 0x7B:
            k = data.find(b"}", j)
            if k < 0:
                raise ValueError("unterminated MIFF brace value")
            val = data[j + 1:k].decode("latin-1")
            i = k + 1
        else:
            k = j
            while k < n and data[k] not in (0x20, 0x09, 0x0A, 0x0D, 0x0C):
                k += 1
            val = data[j:k].decode("latin-1")
            i = k
        fields[key] = val
    raise ValueError("MIFF header missing ':' terminator")


def decode_miff(data: bytes) -> np.ndarray:
    if b"id=ImageMagick" not in data[:4096]:
        raise ValueError("not a MIFF file")
    fields, pos = _parse_miff_header(data)
    if fields.get("id", "").lower() != "imagemagick":
        raise ValueError("not a MIFF file")
    try:
        width = int(fields["columns"])
        height = int(fields["rows"])
    except (KeyError, ValueError):
        raise ValueError("MIFF missing geometry")
    _check_dims(width, height, "MIFF")
    depth = int(fields.get("depth", "8"))
    if depth not in (8, 16):
        raise ValueError(f"unsupported MIFF depth {depth}")
    klass = fields.get("class", "DirectClass").lower()
    compression = fields.get("compression", "None").lower()
    matte = fields.get("matte", "False").lower() == "true"
    if compression in ("zip", "bzip"):
        raise RuntimeError(
            f"MIFF {fields.get('compression')} compression is not "
            "supported by this build; convert with `gm convert "
            "-compress rle img.miff out.miff` or to PNG")
    if compression not in ("none", "rle", "runlengthencoded"):
        raise ValueError(f"unknown MIFF compression {compression}")
    bps = depth // 8  # bytes per sample

    def read_samples(count):
        """Uncompressed sample plane of `count` samples."""
        nbytes = count * bps
        if len(data) < pos + nbytes:
            raise ValueError("truncated MIFF pixel data")
        if depth == 8:
            return np.frombuffer(data, np.uint8, count, pos), nbytes
        return np.frombuffer(data, np.dtype(">u2"), count, pos), nbytes

    if klass == "pseudoclass":
        colors = int(fields.get("colors", "0"))
        if not (0 < colors <= 65536):
            raise ValueError("bad MIFF colormap size")
        cmap_raw, nbytes = read_samples(colors * 3)
        pos += nbytes
        cmap = _scale_to_u8(
            cmap_raw.reshape(colors, 3).astype(np.uint32), depth)
        idx_bytes = 1 if colors <= 256 else 2
        npx = width * height
        if compression == "none":
            need = npx * idx_bytes
            if len(data) < pos + need:
                raise ValueError("truncated MIFF index data")
            if idx_bytes == 1:
                idx = np.frombuffer(data, np.uint8, npx, pos)
            else:
                idx = np.frombuffer(data, np.dtype(">u2"), npx, pos)
        else:  # RLE: index sample(s) + count byte
            idx = np.empty(npx, np.uint32)
            i, p = 0, pos
            step = idx_bytes + 1
            while i < npx:
                if len(data) < p + step:
                    raise ValueError("truncated MIFF RLE stream")
                v = (data[p] if idx_bytes == 1
                     else (data[p] << 8) | data[p + 1])
                run = data[p + idx_bytes] + 1
                if i + run > npx:
                    raise ValueError("MIFF RLE overrun")
                idx[i:i + run] = v
                i += run
                p += step
        idx = np.clip(idx.astype(np.intp), 0, colors - 1)
        out = np.empty((height, width, 4), np.uint8)
        out[..., :3] = cmap[idx].reshape(height, width, 3)
        out[..., 3] = 255
        return out

    # DirectClass: RGB(+opacity) samples, pixel-interleaved
    ncomp = 4 if matte else 3
    npx = width * height
    if compression == "none":
        v, _ = read_samples(npx * ncomp)
        comps = v.astype(np.uint32).reshape(height, width, ncomp)
    else:  # RLE packet: one pixel's samples + count byte
        flat = np.empty((npx, ncomp), np.uint32)
        i, p = 0, pos
        step = ncomp * bps + 1
        while i < npx:
            if len(data) < p + step:
                raise ValueError("truncated MIFF RLE stream")
            if depth == 8:
                px = list(data[p:p + ncomp])
            else:
                px = [((data[p + 2 * c] << 8) | data[p + 2 * c + 1])
                      for c in range(ncomp)]
            run = data[p + ncomp * bps] + 1
            if i + run > npx:
                raise ValueError("MIFF RLE overrun")
            flat[i:i + run] = px
            i += run
            p += step
        comps = flat.reshape(height, width, ncomp)
    return _to_rgba(comps, depth, matte, alpha_is_opacity=True)


# --------------------------------------------------------------------------
# RLA (Wavefront raster)
# --------------------------------------------------------------------------

def decode_rla(data: bytes) -> np.ndarray:
    """Wavefront RLA: 740-byte big-endian header, absolute scanline
    offset table, per-scanline per-channel signed-count RLE, stored
    bottom-to-top.  Supports the classic 8-bit integer layout (1/3
    color channels + optional matte)."""
    if len(data) < 740:
        raise ValueError("not an RLA file (truncated header)")
    (wl, wr, wb, wt, al, ar, ab, at, _frame, storage_type, num_chan,
     num_matte, num_aux, revision) = struct.unpack(">14h", data[:28])
    if revision not in (-2, -3):
        # Wavefront writes 0xFFFE (-2 signed); RLB variants -3.  Reject
        # anything else early -- every other field would be garbage.
        raise ValueError("not an RLA file (bad revision)")
    width = ar - al + 1
    height = at - ab + 1
    _check_dims(width, height, "RLA")
    # header layout: 16 B windows + 12 B shorts + 16 gamma + 4x24
    # chromaticities + 4 job + 128 name + 128 desc + 64 program +
    # 32 machine + 32 user + 20 date + 24 aspect + 8 ratio + 32 chan
    # + 2 field + 12 time + 32 filter = 658 -> chan_bits
    (chan_bits,) = struct.unpack(">h", data[658:660])
    if chan_bits != 8:
        raise ValueError(f"unsupported RLA channel depth {chan_bits}")
    if storage_type != 0:
        raise ValueError("only integer RLA storage supported")
    if num_chan not in (1, 3) or num_matte not in (0, 1):
        raise ValueError("unsupported RLA channel layout")
    n_streams = num_chan + num_matte + num_aux

    table_at = 740
    need = table_at + 4 * height
    if len(data) < need:
        raise ValueError("truncated RLA offset table")
    offsets = struct.unpack(">%di" % height, data[table_at:need])

    def rle_scanline(pos, n):
        out = np.empty(n, np.uint8)
        i = 0
        while i < n:
            if pos >= len(data):
                raise ValueError("truncated RLA scanline")
            c = data[pos]
            pos += 1
            if c < 128:  # run of c+1 copies
                out[i:i + c + 1] = data[pos]
                pos += 1
                i += c + 1
            else:  # 256-c literal bytes
                lit = 256 - c
                end = pos + lit
                if end > len(data):
                    raise ValueError("truncated RLA literal")
                out[i:i + lit] = np.frombuffer(data, np.uint8, lit, pos)
                pos = end
                i += lit
        if i != n:
            raise ValueError("RLA scanline overrun")
        return out, pos

    planes = np.empty((height, width, num_chan + num_matte), np.uint8)
    for row in range(height):
        pos = offsets[row]
        if not (0 < pos < len(data)):
            raise ValueError("bad RLA scanline offset")
        y = height - 1 - row  # bottom-to-top storage
        for c in range(n_streams):
            if len(data) < pos + 2:
                raise ValueError("truncated RLA stream header")
            (enc_len,) = struct.unpack_from(">H", data, pos)
            pos += 2
            plane, endpos = rle_scanline(pos, width)
            if endpos - pos != enc_len:
                raise ValueError("RLA stream length mismatch")
            pos = endpos
            if c < num_chan + num_matte:
                planes[y, :, c] = plane
    if num_chan == 1:
        rgb = np.repeat(planes[..., :1], 3, axis=-1)
        a = planes[..., 1] if num_matte else None
    else:
        rgb = planes[..., :3]
        a = planes[..., 3] if num_matte else None
    out = np.empty((height, width, 4), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = 255 if a is None else a
    return out


# --------------------------------------------------------------------------
# Source
# --------------------------------------------------------------------------

from timg_tpu_torch.sources.xcf import decode_xcf  # noqa: E402

_DECODERS = {
    ".dpx": ("dpx", decode_dpx),
    ".cin": ("cin", decode_cineon),
    ".xwd": ("xwd", decode_xwd),
    ".miff": ("miff", decode_miff),
    ".xcf": ("xcf", decode_xcf),
    ".rla": ("rla", decode_rla),
}


class GMFormatsSource(ImageSource):
    """Single-frame stills for the natively decoded GM-only formats."""

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        if self.filename == "-":
            return False
        import os as _os
        ext = _os.path.splitext(self.filename)[1].lower()
        entry = _DECODERS.get(ext)
        if entry is None:
            return False
        name, decoder = entry
        with open(self.filename, "rb") as f:
            rgba = decoder(f.read())  # RuntimeError = gated diagnostic

        self.decoder_name = name
        self.orig_height, self.orig_width = rgba.shape[:2]
        from timg_tpu_torch.sources.pil_source import _process_frames

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
