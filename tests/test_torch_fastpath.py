"""The port's still library (timg_tpu_torch/native/timg_still.cc, built to
libtimg_still.so without libdeflate.h or zlib.h) against the JAX
package's libtimg_still.so: every entry the one-shot fast path calls, on
the same seeded inputs, byte for byte.  Then the port's run-time deflate:
each branch (libdeflate.so.0 and libz.so.1 both load here) is selected
and called directly.

Tolerance: none -- byte equality everywhere.
"""

import ctypes
import io
import os
import struct
import zlib

import numpy as np
import pytest

from tests.corpus import build_corpus
from timg_tpu.native import runtime as jax_runtime
from timg_tpu_torch.native import runtime

# tests/corpus.py's PNGs (test_png_decode_corpus checks the list)
PNGS = ["alpha_80x100.png", "alpha_band_60x40.png", "bordered_90x60.png",
        "gradient_320x200.png", "gray16_48x32.png", "gray_50x40.png",
        "noise_33x27.png", "noise_512x512.png", "noise_64x48.png",
        "tiny_8x6.png"]
LIBDEFLATE, ZLIB = 1, 2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(str(tmp_path_factory.mktemp("corpus")))


@pytest.fixture(scope="module")
def port():
    lib = runtime.load_still()
    assert lib is not None, runtime.build_error("still")
    yield lib
    lib.timg_deflate_use(0)


@pytest.fixture(scope="module")
def ref():
    lib = jax_runtime.load_still()
    if lib is None or not hasattr(lib, "timg_png_decode"):
        pytest.skip("the JAX package's still library does not build here")
    return lib


@pytest.fixture
def branch(port):
    """Select a deflate library for one test, then go back to the one
    the library resolves itself."""
    def use(which):
        assert port.timg_deflate_use(which) == which
    yield use
    port.timg_deflate_use(0)


def _decode(lib, data: bytes):
    out = ctypes.c_void_p()
    w, h, flags = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.timg_png_decode(data, len(data), ctypes.byref(out),
                             ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(flags))
    if rc != 0:
        return rc, None, flags.value
    rgba = ctypes.string_at(out, w.value * h.value * 4)
    lib.timg_buf_free(out)
    return 0, (w.value, h.value, rgba), flags.value


def _pil_png(arr: np.ndarray, mode: str, **save_kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **save_kw)
    return buf.getvalue()


def _with_chunk(png: bytes, ctype: bytes, payload: bytes) -> bytes:
    """``png`` with one chunk inserted after IHDR."""
    chunk = struct.pack(">I", len(payload)) + ctype + payload
    chunk += struct.pack(">I", zlib.crc32(ctype + payload))
    return png[:33] + chunk + png[33:]


def _generated_pngs() -> dict:
    rng = np.random.default_rng(7)
    out = {}
    for mode, ch in (("RGB", 3), ("RGBA", 4), ("L", 1), ("LA", 2)):
        arr = rng.integers(0, 256, (37, 23, ch), dtype=np.uint8)
        out[mode] = _pil_png(arr[..., 0] if ch == 1 else arr, mode)
    from PIL import Image
    img = Image.fromarray(rng.integers(0, 16, (21, 33), dtype=np.uint8), "P")
    img.putpalette(rng.integers(0, 256, 48, dtype=np.uint8).tolist())
    buf = io.BytesIO()
    img.save(buf, format="PNG", transparency=bytes(range(0, 160, 10)),
             bits=8)
    out["P tRNS"] = buf.getvalue()
    y = np.linspace(0, 255, 200, dtype=np.uint8)[:, None, None]
    out["filters"] = _pil_png(
        (y + rng.integers(0, 30, (200, 177, 4))).astype(np.uint8), "RGBA",
        compress_level=9)
    rgb = out["RGB"]
    out["acTL"] = _with_chunk(rgb, b"acTL", struct.pack(">II", 2, 0))
    out["eXIf"] = _with_chunk(rgb, b"eXIf", b"\0" * 8)
    bad = bytearray(rgb)
    bad[bytes(bad).find(b"IDAT") + 6] ^= 1           # CRC mismatch
    out["bad crc"] = bytes(bad)
    inter = bytearray(rgb)
    inter[28] = 1                                    # Adam7
    inter[29:33] = struct.pack(">I", zlib.crc32(bytes(inter[12:29])))
    out["interlaced"] = bytes(inter)
    buf = io.BytesIO()
    Image.fromarray(np.arange(256, dtype=np.uint16).reshape(16, 16)
                    * 251).save(buf, format="PNG")
    out["16-bit"] = buf.getvalue()
    out["truncated"] = rgb[:len(rgb) // 2]
    return out


GENERATED = _generated_pngs()


@pytest.mark.parametrize("name", PNGS)
def test_png_decode_corpus(corpus, port, ref, name):
    assert PNGS == sorted(k for k in corpus if k.endswith(".png"))
    with open(corpus[name], "rb") as f:
        data = f.read()
    got = _decode(port, data)
    assert got == _decode(ref, data)
    assert (got[0] != 0) == (name == "gray16_48x32.png")    # 16-bit


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_png_decode_generated(port, ref, name):
    """Colour types, a palette with tRNS, every filter, the APNG and
    eXIf flags, and the refusals (bad CRC, Adam7, 16-bit, truncated):
    the same return code, flags and pixels."""
    got = _decode(port, GENERATED[name])
    assert got == _decode(ref, GENERATED[name])
    refused = ("bad crc", "interlaced", "16-bit", "truncated")
    assert (got[0] != 0) == (name in refused)


@pytest.mark.parametrize("which", [LIBDEFLATE, ZLIB])
def test_png_decode_through_each_library(corpus, port, ref, branch,
                                         which):
    """A PNG inflated through zlib equals the same PNG through
    libdeflate, and both the JAX decoder's pixels."""
    branch(which)
    for name in PNGS + ["filters", "RGBA"]:
        data = (GENERATED[name] if name in GENERATED
                else open(corpus[name], "rb").read())
        assert _decode(port, data) == _decode(ref, data), name


def test_calc_scale(port, ref):
    rng = np.random.default_rng(5)
    for _ in range(600):
        args = [int(rng.integers(1, 4000)), int(rng.integers(1, 4000)),
                int(rng.integers(1, 500)), int(rng.integers(1, 300)),
                int(rng.integers(0, 2)), int(rng.integers(0, 2)),
                float(rng.uniform(0.05, 16.0)), int(rng.integers(0, 2)),
                int(rng.integers(0, 2)),
                *[(1, 2), (2, 2), (9, 18)][int(rng.integers(0, 3))],
                int(rng.integers(0, 2))]
        outs = []
        for lib in (port, ref):
            ow, oh = ctypes.c_int(), ctypes.c_int()
            ns = lib.timg_calc_scale(*args, ctypes.byref(ow),
                                     ctypes.byref(oh))
            outs.append((ow.value, oh.value, ns))
        assert outs[0] == outs[1], args


def _taps(lib, in_size, out_size, horizontal):
    starts, coeffs = ctypes.c_void_p(), ctypes.c_void_p()
    widest = lib.timg_build_taps(in_size, out_size, int(horizontal),
                                 ctypes.byref(starts), ctypes.byref(coeffs))
    got = (widest, ctypes.string_at(starts, 4 * out_size),
           ctypes.string_at(coeffs, 4 * out_size * max(widest, 0)))
    lib.timg_buf_free(starts)
    lib.timg_buf_free(coeffs)
    return got


@pytest.mark.parametrize("horizontal", [False, True])
def test_build_taps(port, ref, horizontal):
    pairs = [(1, 1), (1, 7), (7, 1), (2, 3), (3, 2), (10, 10), (640, 160),
             (512, 47), (1920, 160), (3840, 93), (37, 160), (160, 37),
             (1080, 48), (255, 256), (99, 100), (2000, 137), (4032, 320)]
    for in_size, out_size in pairs:
        assert _taps(port, in_size, out_size, horizontal) == \
            _taps(ref, in_size, out_size, horizontal), (in_size, out_size)


def test_plan_passes(port, ref):
    rng = np.random.default_rng(9)
    for _ in range(300):
        g = [int(rng.integers(1, 2000)) for _ in range(4)]
        for aw in (0, 1):
            assert port.timg_plan_passes(*g, aw) == \
                ref.timg_plan_passes(*g, aw), g


def _resize(lib, frame, out_h, out_w):
    in_h, in_w = frame.shape[:2]
    taps = []
    for n_in, n_out, hor in ((in_h, out_h, 0), (in_w, out_w, 1)):
        s, c = ctypes.c_void_p(), ctypes.c_void_p()
        taps.append((lib.timg_build_taps(n_in, n_out, hor, ctypes.byref(s),
                                         ctypes.byref(c)), s, c))
    (wv, sv, cv), (wh, sh, ch) = taps
    out = ctypes.create_string_buffer(out_h * out_w * 4)
    vfirst = lib.timg_plan_passes(in_h, in_w, out_h, out_w, 1)
    rc = lib.timg_resize_polyphase(frame.ctypes.data, 1, in_h, in_w, out,
                                   out_h, out_w, sv, cv, wv, sh, ch, wh,
                                   vfirst, 1)
    for p in (sv, cv, sh, ch):
        lib.timg_buf_free(p)
    return rc, out.raw


@pytest.mark.parametrize("geom", [(512, 512, 48, 160), (27, 33, 60, 90),
                                  (200, 320, 37, 41), (1, 9, 4, 4),
                                  (300, 7, 11, 2)])
def test_resize_polyphase(port, ref, geom):
    in_h, in_w, out_h, out_w = geom
    frame = np.random.default_rng(sum(geom)).integers(
        0, 256, (in_h, in_w, 4), dtype=np.uint8)
    frame[::3, ::2, 3] = 255
    got = _resize(port, frame, out_h, out_w)
    assert got[0] == 0
    assert got == _resize(ref, frame, out_h, out_w)


def test_alpha_over_bg(port, ref):
    rng = np.random.default_rng(13)
    for _ in range(16):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        frame = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        frame[..., 3][rng.random((h, w)) < 0.3] = 255
        bg = rng.integers(0, 256, 4, dtype=np.uint8)
        pat = rng.integers(0, 256, 4, dtype=np.uint8)
        bg[3] *= rng.random() > 0.3
        pat[3] *= rng.random() > 0.4
        args = (h, w, bg.tobytes(), pat.tobytes(), int(rng.integers(0, 5)),
                int(rng.integers(0, 5)), int(rng.integers(0, h + 1)))
        a, b = frame.copy(), frame.copy()
        port.timg_alpha_over_bg(a.ctypes.data, *args)
        ref.timg_alpha_over_bg(b.ctypes.data, *args)
        assert a.tobytes() == b.tobytes()


def _blockish(rng, h, w):
    frame = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    for _ in range(10):
        y, x = int(rng.integers(0, h)) & ~1, int(rng.integers(0, w)) & ~1
        frame[y:y + 2, x:x + 2] = frame[y, x]
    frame[..., 3][rng.random((h, w)) < 0.25] = rng.integers(0, 0x60)
    frame[..., 3][rng.random((h, w)) < 0.5] = 255
    return frame


def _cells(lib, fn, frame, upper, wcells):
    h, w = frame.shape[:2]
    n = (h // 2) * wcells
    g, f, b = (ctypes.create_string_buffer(4 * n) for _ in range(3))
    getattr(lib, fn)(frame.ctypes.data, h, w, int(upper), g, f, b)
    return g.raw, f.raw, b.raw


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("fn", ["timg_quarter_blocks", "timg_half_blocks"])
def test_blocks(port, ref, fn, upper):
    rng = np.random.default_rng(17 + upper)
    for _ in range(8):
        h = int(rng.integers(1, 30)) * 2
        w = int(rng.integers(1, 30)) * 2
        frame = _blockish(rng, h, w)
        wcells = w // 2 if fn == "timg_quarter_blocks" else w
        assert _cells(port, fn, frame, upper, wcells) == \
            _cells(ref, fn, frame, upper, wcells), (h, w)


def test_resize_nearest_and_translucency(port, ref):
    rng = np.random.default_rng(23)
    for in_h, in_w, out_h, out_w in [(10, 10, 3, 7), (3, 7, 10, 10),
                                     (480, 640, 48, 160), (1, 1, 5, 5)]:
        frame = rng.integers(0, 256, (in_h, in_w, 4), dtype=np.uint8)
        outs = []
        for lib in (port, ref):
            out = ctypes.create_string_buffer(out_h * out_w * 4)
            lib.timg_resize_nearest(frame.ctypes.data, in_h, in_w, out,
                                    out_h, out_w)
            outs.append(out.raw)
        assert outs[0] == outs[1]
    a = np.full((5, 5, 4), 255, np.uint8)
    assert port.timg_has_translucency(a.ctypes.data, 25) == 0
    a[4, 4, 3] = 254
    assert port.timg_has_translucency(a.ctypes.data, 25) == \
        ref.timg_has_translucency(a.ctypes.data, 25) == 1


def _compress(lib, data: bytes, level: int) -> bytes:
    out = ctypes.c_void_p()
    n = lib.timg_zlib_compress(data, len(data), level, ctypes.byref(out))
    assert n > 0
    got = ctypes.string_at(out, n)
    lib.timg_buf_free(out)
    return got


def _scanlines() -> bytes:
    """Sub-filtered rows of a seeded photo-like RGBA image, as the kitty
    and iTerm2 writers compress them."""
    rng = np.random.default_rng(29)
    y = np.linspace(0, 255, 90, dtype=np.uint8)[:, None, None]
    img = (y + rng.integers(0, 12, (90, 130, 4))).astype(np.uint8)
    raw = np.zeros((90, 1 + 130 * 4), np.uint8)
    raw[:, 0] = 1
    raw[:, 1:] = img.reshape(90, -1)
    raw[:, 5:] -= img.reshape(90, -1)[:, :-4]
    return raw.tobytes()


@pytest.mark.parametrize("level", range(10))
def test_zlib_branch_equals_python_zlib(port, branch, level):
    """The zlib branch (compress2) writes Python's zlib.compress bytes at
    every --compress level the CLI takes (0-9): the PNG writer's
    fallback where libdeflate is absent."""
    branch(ZLIB)
    data = _scanlines()
    got = _compress(port, data, level)
    assert got == zlib.compress(data, level)
    assert zlib.decompress(got) == data


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_libdeflate_branch_equals_png_core(port, branch, level):
    """The libdeflate branch writes png_core.zlib_compress's bytes (which
    takes libdeflate here too)."""
    from timg_tpu_torch.render import png_core

    if png_core.load_libdeflate() is None:
        pytest.skip("png_core found no libdeflate")
    branch(LIBDEFLATE)
    data = _scanlines()
    assert _compress(port, data, level) == png_core.zlib_compress(data,
                                                                  level)


def test_inflate_and_crc(port, branch):
    data = _scanlines()
    stream = zlib.compress(data, 6)
    for which in (LIBDEFLATE, ZLIB):
        branch(which)
        out = ctypes.create_string_buffer(len(data))
        assert port.timg_zlib_inflate(stream, len(stream), out,
                                      len(data)) == 0
        assert out.raw == data
        short = ctypes.create_string_buffer(len(data) - 1)
        assert port.timg_zlib_inflate(stream, len(stream), short,
                                      len(data) - 1) == 1
        long_ = ctypes.create_string_buffer(len(data) + 1)
        assert port.timg_zlib_inflate(stream, len(stream), long_,
                                      len(data) + 1) == 1
        assert port.timg_zlib_inflate(stream[:-9], len(stream) - 9, out,
                                      len(data)) == 1
    for chunk in (b"", b"IEND", data):
        assert port.timg_crc32(0, chunk, len(chunk)) == zlib.crc32(chunk)


def test_deflate_resolution(port, branch):
    """Resolved in png_core.load_libdeflate's order, and named in the
    --version row."""
    branch(LIBDEFLATE)
    assert port.timg_deflate_name() == b"libdeflate.so.0"
    branch(ZLIB)
    assert port.timg_deflate_name() == b"libz.so.1"
    port.timg_deflate_use(0)
    assert port.timg_deflate_name() == b"libdeflate.so.0"
    assert runtime.describe().endswith("still pipeline (libdeflate.so.0)")
