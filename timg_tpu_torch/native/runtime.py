"""ctypes loader for the port's native helper (counterpart of
timg_tpu/native/runtime.py), built at first use.

Two libraries, each from one source in this directory, built with g++
into ``build/`` (git-ignored) and rebuilt when their source is newer:

- ``libtimg_native.so`` from ``timg_native.cc`` alone: the C sixel
  assembler (and the polyphase resize executor ``ops/resize_np.py``
  calls).  It needs only standard headers, so it builds on any host
  with a C++17 compiler;
- ``libtimg_video.so`` from ``timg_video.cc``: the libav video decoder.
  It builds only where the libav headers and libraries exist; elsewhere
  ``load_video()`` returns None and the source factory reports it.

The JAX package links both halves (and a libdeflate still pipeline the
port does not call) into one library, so a host without libav lost the
assembler too; here the halves stand apart.  Only the entry points the
port calls are bound.
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

# the JAX Makefile's flags: -ffp-contract=off keeps the resize executor's
# f32 mul/add roundings those of numpy
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17",
            "-ffp-contract=off"]
_LIBS = {
    "native": ("timg_native.cc", []),
    "video": ("timg_video.cc",
              ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]),
}

_handles: dict = {}
_errors: dict = {}
_lock = threading.Lock()


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libtimg_{name}.so")


def source_path(name: str) -> str:
    return os.path.join(_DIR, _LIBS[name][0])


def _build(name: str) -> Optional[str]:
    """Compile one library if missing or stale; its path, or None (the
    compiler's message kept in ``build_error(name)`` and the log)."""
    src, libs = _LIBS[name]
    src = os.path.join(_DIR, src)
    out = lib_path(name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", tmp,
           src, *libs]
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
    os.replace(tmp, out)     # a concurrent loader never sees half a file
    return out


def _load(name: str, bind) -> Optional[ctypes.CDLL]:
    if name in _handles:
        return _handles[name]
    with _lock:
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
    lib.timg_sixel_encode.restype = ctypes.c_long
    lib.timg_sixel_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.timg_resize_polyphase.restype = ctypes.c_long
    lib.timg_resize_polyphase.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    return lib


def _bind_video(lib: ctypes.CDLL) -> ctypes.CDLL:
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
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The assembler library (built on first call); None if it cannot
    be built here."""
    return _load("native", _bind_native)


def load_video() -> Optional[ctypes.CDLL]:
    """The libav video library (built on first call); None where libav
    is missing."""
    return _load("video", _bind_video)


def build_error(name: str) -> str:
    """Why ``name`` ("native" or "video") did not build or load ("" if
    it did, or was not tried)."""
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
