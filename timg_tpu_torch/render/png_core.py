"""numpy-free core of the PNG writer: libdeflate loader, zlib-stream
compression, chunk assembly (split from render/png.py so the one-shot
fastpath can emit iTerm2/kitty PNGs without importing numpy; byte
semantics are render/png.py's, which pins them to ref src/timg-png.cc).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import threading
import zlib
from typing import Optional

_libdeflate = None
_checked = False
_load_lock = threading.Lock()


def load_libdeflate() -> Optional[ctypes.CDLL]:
    """Thread-safe one-time loader.  Kitty/iTerm2 animation frames
    compress concurrently in the pool; setting the checked flag before
    the handle is ready would make racing threads silently take the
    zlib fallback, whose deflate bytes differ from libdeflate's --
    frames of one animation would then mix compressors (caught by the
    kitty animation parity test vs the reference binary)."""
    global _libdeflate, _checked
    if _checked:
        return _libdeflate
    with _load_lock:
        if _checked:
            return _libdeflate
        name = ctypes.util.find_library("deflate") or "libdeflate.so.0"
        try:
            lib = ctypes.CDLL(name)
            lib.libdeflate_alloc_compressor.restype = ctypes.c_void_p
            lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
            lib.libdeflate_zlib_compress.restype = ctypes.c_size_t
            lib.libdeflate_zlib_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t]
            lib.libdeflate_free_compressor.argtypes = [ctypes.c_void_p]
            lib.libdeflate_zlib_compress_bound.restype = ctypes.c_size_t
            lib.libdeflate_zlib_compress_bound.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t]
            _libdeflate = lib
        except OSError:
            _libdeflate = None
        _checked = True
    return _libdeflate


def zlib_compress(data: bytes, level: int) -> bytes:
    lib = load_libdeflate()
    if lib is not None:
        comp = lib.libdeflate_alloc_compressor(level)
        if comp:
            try:
                bound = lib.libdeflate_zlib_compress_bound(comp, len(data))
                out = ctypes.create_string_buffer(bound)
                n = lib.libdeflate_zlib_compress(comp, data, len(data),
                                                 out, bound)
                if n:
                    return out.raw[:n]
            finally:
                lib.libdeflate_free_compressor(comp)
    return zlib.compress(data, min(max(level, 0), 9))


def chunk(chunk_type: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(chunk_type + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + chunk_type + payload + \
        struct.pack(">I", crc)


def encode_png_from_filtered(raw: bytes, w: int, h: int,
                             compression_level: int,
                             with_alpha: bool) -> bytes:
    """Assemble a PNG from already Sub-filtered scanlines
    (ref timg-png.cc:90-152 layout: IHDR + one IDAT + IEND)."""
    idat = zlib_compress(raw, compression_level)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if with_alpha else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))
