"""ctypes loader for the port's native helper (counterpart of
timg_tpu/native/runtime.py and its Makefile), built at first use.

Three libraries and a program from the sources in this directory, built
with g++ into ``build/`` (git-ignored) and rebuilt when a source is
newer:

- ``libtimg_native.so`` from ``timg_native.cc`` alone: the C sixel
  assembler, the C ANSI block emitter (``timg_ansi_emit``), the
  polyphase resize executor ``ops/resize_np.py`` calls, and libsixel's
  quantizer (``libsixel_quant``, a one-shot still's palette and dither)
  and palette (``libsixel_palette``, each frame of an animation).  It needs only standard headers, so it builds on any host
  with a C++17 compiler;
- ``libtimg_video.so`` from ``timg_video.cc``: the libav video decoder.
  It builds only where the libav headers and libraries exist; elsewhere
  ``load_video()`` returns None and the source factory reports it;
- ``libtimg_still.so`` from ``timg_native.cc`` and ``timg_still.cc``:
  the one-shot still path's PNG decode, scale-to-fit, taps, compose and
  block selection (``load_still()``, which fast.py calls).  It resolves
  deflate at run time (libdeflate.so.0, else libz.so.1), so it builds
  without either library's header;
- ``timg-tpu-torch-fast`` at the repository's root, beside the launcher
  it execs (it finds ``timg-tpu-torch`` through /proc/self/exe), from
  ``timg_fast_main.cc`` and the still library's two sources
  (``build_launcher()``).  It is compiled with -march=native, so it is
  also rebuilt on a host other than the one that built it.

The JAX package links the first two halves (with its still pipeline)
into one library, so a host without libav lost the assembler too; here
the halves stand apart.  Only the entry points the port calls are bound.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
LOG_PATH = os.path.join(BUILD_DIR, "g++.log")
LAUNCHER = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                        "timg-tpu-torch-fast")
_LAUNCHER_HOST = os.path.join(BUILD_DIR, "timg-tpu-torch-fast.host")
_LAUNCHER_SOURCES = ("timg_fast_main.cc", "css3_colors.inc",
                     "timg_native.cc", "timg_still.cc")

# the JAX Makefile's flags: -ffp-contract=off keeps the resize executor's
# f32 mul/add roundings those of numpy
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17",
            "-ffp-contract=off"]
# name -> (its sources, the libraries it links)
_LIBS = {
    "native": (("timg_native.cc",), []),
    "video": (("timg_video.cc",),
              ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]),
    "still": (("timg_native.cc", "timg_still.cc"), ["-ldl"]),
}

_handles: dict = {}
_errors: dict = {}
# one lock a library (and the launcher), so their builds run in parallel
_locks = {name: threading.Lock() for name in (*_LIBS, "launcher")}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libtimg_{name}.so")


def source_path(name: str) -> str:
    """The first source of library ``name``."""
    return sources(name)[0]


def sources(name: str) -> list:
    return [os.path.join(_DIR, src) for src in _LIBS[name][0]]


def _newer(out: str, srcs) -> bool:
    """``out`` exists and no source is newer."""
    return os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(src) for src in srcs)


def _build(name: str) -> Optional[str]:
    """Compile one library if missing or stale; its path, or None (the
    compiler's message kept in ``build_error(name)`` and the log)."""
    srcs, libs = sources(name), _LIBS[name][1]
    out = lib_path(name)
    if _newer(out, srcs):
        return out
    return _compile(name, out, ["-shared", *srcs, *libs])


def _compile(name: str, out: str, args: list) -> Optional[str]:
    """g++ with CXXFLAGS and ``args`` into ``out`` (through a temporary
    file, so a concurrent loader never sees half a file); ``out``, or
    None with the message in ``build_error(name)``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, *args]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _errors[name] = str(e)
        return None
    with open(LOG_PATH, "a") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        _errors[name] = proc.stderr[-2000:]
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, out)
    return out


def _load(name: str, bind) -> Optional[ctypes.CDLL]:
    if name in _handles:
        return _handles[name]
    with _locks[name]:
        if name not in _handles:
            path = _build(name)
            lib = None
            if path is not None:
                try:
                    lib = bind(ctypes.CDLL(path))
                except OSError as e:
                    _errors[name] = str(e)
            _handles[name] = lib
    return _handles[name]


def _bind_native(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.timg_ansi_emit.restype = ctypes.c_long
    lib.timg_ansi_emit.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p]
    lib.timg_sixel_encode.restype = ctypes.c_long
    lib.timg_sixel_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.timg_sixel_encode_runs.restype = ctypes.c_long
    lib.timg_sixel_encode_runs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.timg_resize_polyphase.restype = ctypes.c_long
    lib.timg_resize_polyphase.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.timg_libsixel_quant.restype = ctypes.c_int
    lib.timg_libsixel_quant.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.timg_libsixel_palette.restype = ctypes.c_int
    lib.timg_libsixel_palette.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_int, ctypes.c_void_p]
    lib.timg_png_sub_filter.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def _bind_video(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.timg_video_version.restype = ctypes.c_char_p
    lib.timg_video_device_capture_available.restype = ctypes.c_int
    lib.timg_video_open.restype = ctypes.c_void_p
    lib.timg_video_open.argtypes = [ctypes.c_char_p]
    lib.timg_video_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)]
    lib.timg_video_read_frame.restype = ctypes.c_int
    lib.timg_video_read_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.timg_video_rewind.restype = ctypes.c_int
    lib.timg_video_rewind.argtypes = [ctypes.c_void_p]
    lib.timg_video_pix_info.restype = ctypes.c_int
    lib.timg_video_pix_info.argtypes = [ctypes.c_void_p]
    lib.timg_video_read_frame_yuv.restype = ctypes.c_int
    lib.timg_video_read_frame_yuv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p]
    lib.timg_video_close.argtypes = [ctypes.c_void_p]
    # --resample=sws: decode + swscale SWS_BILINEAR to display size in
    # one host call a frame (ref video-source.cc:59-89, :352-354)
    lib.timg_video_read_frame_scaled.restype = ctypes.c_int
    lib.timg_video_read_frame_scaled.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.timg_sws_scale_rgba.restype = ctypes.c_int
    lib.timg_sws_scale_rgba.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _bind_still(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The still pipeline's entries (fast.py's calls) and its deflate."""
    _bind_native(lib)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.timg_png_decode.restype = ctypes.c_long
    lib.timg_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_void_p), c_int_p, c_int_p, c_int_p]
    lib.timg_buf_free.argtypes = [ctypes.c_void_p]
    lib.timg_calc_scale.restype = ctypes.c_int
    lib.timg_calc_scale.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_int_p, c_int_p]
    lib.timg_build_taps.restype = ctypes.c_int
    lib.timg_build_taps.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
    lib.timg_plan_passes.restype = ctypes.c_int
    lib.timg_plan_passes.argtypes = [ctypes.c_int] * 5
    lib.timg_has_translucency.restype = ctypes.c_long
    lib.timg_has_translucency.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.timg_alpha_over_bg.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for fn in (lib.timg_quarter_blocks, lib.timg_half_blocks):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.timg_resize_nearest.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]
    lib.timg_deflate_use.restype = ctypes.c_int
    lib.timg_deflate_use.argtypes = [ctypes.c_int]
    lib.timg_deflate_name.restype = ctypes.c_char_p
    lib.timg_crc32.restype = ctypes.c_uint32
    lib.timg_crc32.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_long]
    lib.timg_zlib_inflate.restype = ctypes.c_int
    lib.timg_zlib_inflate.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.c_void_p, ctypes.c_long]
    lib.timg_zlib_compress.restype = ctypes.c_long
    lib.timg_zlib_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p)]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The assembler library (built on first call); None if it cannot
    be built here."""
    return _load("native", _bind_native)


def load_still() -> Optional[ctypes.CDLL]:
    """The one-shot still path's library (built on first call); None if
    it cannot be built here (fast.py then falls back to the CLI)."""
    return _load("still", _bind_still)


def _host_id() -> str:
    """This host and its CPU model: a -march=native binary runs where it
    was built."""
    import platform

    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.node()}; {platform.machine()}; {model}"


def launcher_fresh() -> bool:
    """``timg-tpu-torch-fast`` exists, is newer than its sources and was
    built on this host."""
    try:
        with open(_LAUNCHER_HOST) as f:
            host = f.read()
    except OSError:
        return False
    return host == _host_id() and _newer(
        LAUNCHER, [os.path.join(_DIR, s) for s in _LAUNCHER_SOURCES])


def build_launcher() -> Optional[str]:
    """Build ``timg-tpu-torch-fast`` at the repository's root if it is
    missing, stale or from another host; its path, or None (the
    compiler's message in ``build_error("launcher")``)."""
    with _locks["launcher"]:
        if launcher_fresh():
            return LAUNCHER
        srcs = [os.path.join(_DIR, s) for s in _LAUNCHER_SOURCES
                if s.endswith(".cc")]
        out = _compile("launcher", LAUNCHER, [*srcs, "-ldl"])
        if out is not None:
            # through a temporary file, as the binary: another process
            # checking freshness never reads a truncated stamp
            tmp = f"{_LAUNCHER_HOST}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(_host_id())
            os.replace(tmp, _LAUNCHER_HOST)
        return out


def load_video() -> Optional[ctypes.CDLL]:
    """The libav video library (built on first call); None where libav
    is missing."""
    return _load("video", _bind_video)


def _fresh(name: str) -> bool:
    return _newer(lib_path(name), sources(name))


def describe() -> str:
    """One line for ``--version`` (timg_tpu/native/runtime.py:describe):
    the libav decoder's version, the C assembler and emitter, and the
    still pipeline with the deflate library it resolved, each as built,
    or why not.  Loads only libraries already built and fresh: it never
    starts the compiler."""
    if _fresh("video"):
        lib = load_video()
        video = (lib.timg_video_version().decode() if lib is not None
                 else "video decoder unavailable")
        if lib is not None and lib.timg_video_device_capture_available():
            # ref prints "; avdevice <version>" when built with it
            video += "; avdevice (v4l2 capture)"
    else:
        video = "video decoder not built"
    native = ("C sixel assembler; ansi emitter" if _fresh("native")
              and load() is not None else "C sixel assembler not built")
    still = "still pipeline not built"
    if _fresh("still") and load_still() is not None:
        deflate = load_still().timg_deflate_name().decode()
        still = f"still pipeline ({deflate or 'no deflate library'})"
    return f"{video}; {native}; {still}"


def build_error(name: str) -> str:
    """Why ``name`` ("native", "video", "still" or "launcher") did not
    build or load ("" if it did, or was not tried)."""
    return _errors.get(name, "")


def resize_polyphase(frames, out_h: int, out_w: int, starts_v, coeffs_v,
                     starts_h, coeffs_h, vertical_first: bool,
                     alpha_weighted: bool):
    """Native polyphase resize (bit-exact mirror of resize_np's numpy
    executor — see timg_native.cc:timg_resize_polyphase).  frames:
    [B, H, W, 4] uint8 contiguous.  Returns [B, out_h, out_w, 4] uint8
    or None when the native library is unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    b, in_h, in_w, _ = frames.shape
    starts_v = np.ascontiguousarray(starts_v, dtype=np.int32)
    coeffs_v = np.ascontiguousarray(coeffs_v, dtype=np.float32)
    starts_h = np.ascontiguousarray(starts_h, dtype=np.int32)
    coeffs_h = np.ascontiguousarray(coeffs_h, dtype=np.float32)
    out = np.empty((b, out_h, out_w, 4), dtype=np.uint8)
    rc = lib.timg_resize_polyphase(
        frames.ctypes.data, b, in_h, in_w, out.ctypes.data, out_h, out_w,
        starts_v.ctypes.data, coeffs_v.ctypes.data, coeffs_v.shape[1],
        starts_h.ctypes.data, coeffs_h.ctypes.data, coeffs_h.shape[1],
        int(vertical_first), int(alpha_weighted))
    if rc != 0:
        return None
    return out


def _rgba(frame):
    """[H, W, 4] uint8 with 4-byte pixels (3-channel input padded)."""
    import numpy as np

    frame = np.asarray(frame)
    if frame.shape[2] == 4 and frame.strides[1] == 4 \
            and frame.strides[2] == 1 and frame.dtype == np.uint8:
        return frame
    rgba = np.zeros(frame.shape[:2] + (4,), dtype=np.uint8)
    rgba[..., :min(frame.shape[2], 4)] = frame[..., :4]
    return rgba


def libsixel_quant(frame_rgba, reqcolors: int = 256):
    """libsixel's quantizer on one frame (quant.c's histogram, median
    cut and cached Floyd-Steinberg; timg_native.cc:timg_libsixel_quant).
    frame_rgba: [H, W, 4] (or [H, W, 3]) uint8.  Returns (indices [H, W]
    uint8, palette [ncolors, 3] uint8), or None when the native library
    is unavailable (callers then run ops/libsixel_quant.py's oracle)."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    frame = _rgba(frame_rgba)
    h, w = frame.shape[:2]
    pal = np.zeros((reqcolors, 3), dtype=np.uint8)
    idx = np.zeros((h, w), dtype=np.uint8)
    rc = lib.timg_libsixel_quant(frame.ctypes.data, h, w, frame.strides[0],
                                 reqcolors, pal.ctypes.data,
                                 idx.ctypes.data)
    if rc < 0:
        return None
    return idx, pal[:rc & 0xFFFF]


def libsixel_palette(frame_rgba, reqcolors: int = 256):
    """libsixel's palette of one frame (histogram and median cut;
    timg_native.cc:timg_libsixel_palette).  Returns (palette [ncolors, 3]
    uint8, diffuse bool), or None when the native library is
    unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    frame = _rgba(frame_rgba)
    h, w = frame.shape[:2]
    pal = np.zeros((reqcolors, 3), dtype=np.uint8)
    rc = lib.timg_libsixel_palette(frame.ctypes.data, h, w,
                                   frame.strides[0], reqcolors,
                                   pal.ctypes.data)
    if rc < 0:
        return None
    return pal[:rc & 0xFFFF], bool(rc >> 16)
