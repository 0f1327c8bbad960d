"""OpenSlide source: pyramidal scientific images (gated).

The port's copy of timg_tpu/sources/openslide_source.py; only the imports differ.

Behavioral spec: ref src/openslide-source.cc (off by default upstream,
ref CMakeLists.txt:18). Strategy, matching the reference:

1. prefer the embedded "thumbnail" associated image when it is at
   least as large as the display target (ref :88-105);
2. otherwise pick the pyramid level best matching the downsample
   factor and ``openslide_read_region`` the whole slide at that level
   (ref :107-123);
3. exact-target scaling then runs through the shared device resize
   (the reference hands off to ImageScaler, ref :126-131).

OpenSlide returns premultiplied ARGB (BGRA in memory on little
endian); we unpremultiply and swap to RGBA before the shared pipeline
(the reference consumes it as pre-swapped RGB32).

The ctypes binding is complete; when libopenslide is absent the source
is skipped exactly like a reference build without WITH_OPENSLIDE, with
a diagnostic hint for slide-format suffixes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import ImageSource, PreprocessedFrame

_SLIDE_SUFFIXES = (".svs", ".ndpi", ".mrxs", ".scn", ".vms", ".vmu",
                   ".bif", ".svslide")


@functools.lru_cache(maxsize=1)
def _lib():
    import os
    override = os.environ.get("TIMG_OPENSLIDE_LIB")  # test mock hook
    names = ((override,) if override else
             ("libopenslide.so.1", "libopenslide.so.0", "libopenslide.so"))
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.openslide_open.restype = ctypes.c_void_p
    lib.openslide_open.argtypes = [ctypes.c_char_p]
    lib.openslide_get_error.restype = ctypes.c_char_p
    lib.openslide_get_error.argtypes = [ctypes.c_void_p]
    lib.openslide_close.argtypes = [ctypes.c_void_p]
    lib.openslide_get_level_count.restype = ctypes.c_int32
    lib.openslide_get_level_count.argtypes = [ctypes.c_void_p]
    lib.openslide_get_level_dimensions.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.openslide_get_best_level_for_downsample.restype = ctypes.c_int32
    lib.openslide_get_best_level_for_downsample.argtypes = [
        ctypes.c_void_p, ctypes.c_double]
    lib.openslide_read_region.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64]
    lib.openslide_get_associated_image_names.restype = ctypes.POINTER(
        ctypes.c_char_p)
    lib.openslide_get_associated_image_names.argtypes = [ctypes.c_void_p]
    lib.openslide_get_associated_image_dimensions.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.openslide_read_associated_image.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32)]
    return lib


def _argb_to_rgba(buf: np.ndarray, h: int, w: int) -> np.ndarray:
    """Premultiplied native-endian ARGB words -> straight RGBA u8."""
    words = buf.reshape(h, w)
    a = ((words >> 24) & 0xFF).astype(np.uint8)
    r = ((words >> 16) & 0xFF).astype(np.uint8)
    g = ((words >> 8) & 0xFF).astype(np.uint8)
    b = (words & 0xFF).astype(np.uint8)
    out = np.stack([r, g, b, a], axis=-1)
    if not (a == 255).all():  # unpremultiply wherever alpha < 255
        nz = a > 0
        af = np.where(nz, a, 1).astype(np.uint32)
        for c in range(3):
            ch = out[..., c].astype(np.uint32)
            out[..., c] = np.where(
                nz, np.minimum((ch * 255 + af // 2) // af, 255),
                0).astype(np.uint8)
    return out


class OpenSlideSource(ImageSource):
    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "openslide"

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        if self.filename == "-":
            return False
        lib = _lib()
        if lib is None:
            if self.filename.lower().endswith(_SLIDE_SUFFIXES):
                raise RuntimeError(
                    f"{self.filename}: slide formats need libopenslide, "
                    "which is not available (like a timg build without "
                    "WITH_OPENSLIDE)")
            return False
        osr = lib.openslide_open(self.filename.encode())
        if not osr:
            return False
        try:
            if lib.openslide_get_error(osr):
                return False
            w0 = ctypes.c_int64()
            h0 = ctypes.c_int64()
            lib.openslide_get_level_dimensions(
                osr, 0, ctypes.byref(w0), ctypes.byref(h0))
            if w0.value <= 0 or h0.value <= 0:
                return False
            self.orig_width, self.orig_height = w0.value, h0.value
            target_w, target_h, _ = calc_scale_to_fit(
                w0.value, h0.value, options)

            rgba = self._try_thumbnail(lib, osr, target_w, target_h)
            if rgba is None:
                downsample = max(
                    min(w0.value / max(target_w, 1),
                        h0.value / max(target_h, 1)), 1.0)
                level = lib.openslide_get_best_level_for_downsample(
                    osr, ctypes.c_double(downsample))
                lw = ctypes.c_int64()
                lh = ctypes.c_int64()
                lib.openslide_get_level_dimensions(
                    osr, level, ctypes.byref(lw), ctypes.byref(lh))
                buf = np.empty(lw.value * lh.value, np.uint32)
                lib.openslide_read_region(
                    osr, buf.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint32)),
                    0, 0, level, lw.value, lh.value)
                if lib.openslide_get_error(osr):
                    return False
                rgba = _argb_to_rgba(buf, lh.value, lw.value)
        finally:
            lib.openslide_close(osr)

        from timg_tpu_torch.sources.pil_source import _process_frames

        processed = _process_frames([rgba], target_w, target_h, options)
        self.frames = [PreprocessedFrame(frame=processed[0])]
        self.indentation = (
            int((options.width - target_w) / 2)
            if options.center_horizontally else 0
        )
        self.max_frames = 1
        return True

    @staticmethod
    def _try_thumbnail(lib, osr, target_w: int, target_h: int):
        """ref openslide-source.cc:88-105: use the embedded thumbnail
        when it is at least target-sized (downscale keeps quality)."""
        names = lib.openslide_get_associated_image_names(osr)
        i = 0
        found = False
        while names and names[i]:
            if names[i] == b"thumbnail":
                found = True
                break
            i += 1
        if not found:
            return None
        tw = ctypes.c_int64()
        th = ctypes.c_int64()
        lib.openslide_get_associated_image_dimensions(
            osr, b"thumbnail", ctypes.byref(tw), ctypes.byref(th))
        if tw.value < target_w or th.value < target_h:
            return None
        buf = np.empty(tw.value * th.value, np.uint32)
        lib.openslide_read_associated_image(
            osr, b"thumbnail", buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint32)))
        if lib.openslide_get_error(osr):
            return None  # corrupt thumbnail: fall back to read_region
        return _argb_to_rgba(buf, th.value, tw.value)
