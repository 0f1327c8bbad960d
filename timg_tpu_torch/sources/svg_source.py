"""SVG decoder via librsvg + cairo (ctypes).

The port's copy of timg_tpu/sources/svg_source.py; only the imports differ.

Behavioral spec: ref src/svg-image-source.cc — intrinsic size from the
SVG (ref :62-75), render into a surface at the already-computed target
size (ref :89-106), serialize renders behind a global lock (rsvg+cairo
are not thread-safe together, ref :31-46), then channel-fix the
ARGB32 surface (ref :123-126; we additionally un-premultiply, which
cairo surfaces are).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional, Tuple

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import ImageSource, PreprocessedFrame

_render_lock = threading.Lock()  # ref svg-image-source.cc:31-46

_CAIRO_FORMAT_ARGB32 = 0


class _RsvgRectangle(ctypes.Structure):
    _fields_ = [("x", ctypes.c_double), ("y", ctypes.c_double),
                ("width", ctypes.c_double), ("height", ctypes.c_double)]


_libs: Optional[Tuple[ctypes.CDLL, ctypes.CDLL]] = None
_tried = False


def _load() -> Optional[Tuple[ctypes.CDLL, ctypes.CDLL]]:
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    try:
        rsvg = ctypes.CDLL("librsvg-2.so.2")
        cairo = ctypes.CDLL("libcairo.so.2")
    except OSError:
        return None
    rsvg.rsvg_handle_new_from_file.restype = ctypes.c_void_p
    rsvg.rsvg_handle_new_from_file.argtypes = [ctypes.c_char_p,
                                               ctypes.c_void_p]
    rsvg.rsvg_handle_get_intrinsic_size_in_pixels.restype = ctypes.c_bool
    rsvg.rsvg_handle_get_intrinsic_size_in_pixels.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    rsvg.rsvg_handle_render_document.restype = ctypes.c_bool
    rsvg.rsvg_handle_render_document.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_RsvgRectangle),
        ctypes.c_void_p]
    cairo.cairo_image_surface_create.restype = ctypes.c_void_p
    cairo.cairo_image_surface_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_int]
    cairo.cairo_create.restype = ctypes.c_void_p
    cairo.cairo_create.argtypes = [ctypes.c_void_p]
    cairo.cairo_scale.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                  ctypes.c_double]
    cairo.cairo_image_surface_get_data.restype = ctypes.POINTER(
        ctypes.c_ubyte)
    cairo.cairo_image_surface_get_data.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_stride.restype = ctypes.c_int
    cairo.cairo_image_surface_get_stride.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_flush.argtypes = [ctypes.c_void_p]
    cairo.cairo_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_destroy.argtypes = [ctypes.c_void_p]
    # GObject unref to free parsed handles (the reference unrefs after
    # rendering, svg-image-source.cc:122); librsvg links gobject, so
    # the symbol resolves through the rsvg handle.
    try:
        rsvg.g_object_unref.argtypes = [ctypes.c_void_p]
        _ = rsvg.g_object_unref
    except AttributeError:
        rsvg.g_object_unref = None  # type: ignore[attr-defined]
    _libs = (rsvg, cairo)
    return _libs


def _unref(rsvg, handle) -> None:
    fn = getattr(rsvg, "g_object_unref", None)
    if fn is not None and handle:
        fn(handle)


def render_svg(filename: str, width: int, height: int,
               intrinsic: Optional[Tuple[int, int]] = None
               ) -> Optional[np.ndarray]:
    """Render an SVG to [height, width, 4] RGBA, or None.

    Axes scale independently like the reference's cairo transform
    (ref svg-image-source.cc:89-106), so non-uniform targets (e.g. the
    quarter-block 2x width) stretch instead of letterboxing."""
    libs = _load()
    if libs is None:
        return None
    rsvg, cairo = libs
    handle = rsvg.rsvg_handle_new_from_file(filename.encode(), None)
    if not handle:
        return None
    iw, ih = intrinsic or (width, height)
    if iw <= 0 or ih <= 0:
        _unref(rsvg, handle)
        return None
    with _render_lock:
        surface = cairo.cairo_image_surface_create(
            _CAIRO_FORMAT_ARGB32, width, height)
        cr = cairo.cairo_create(surface)
        cairo.cairo_scale(cr, width / iw, height / ih)
        viewport = _RsvgRectangle(0.0, 0.0, float(iw), float(ih))
        ok = rsvg.rsvg_handle_render_document(handle, cr,
                                              ctypes.byref(viewport), None)
        cairo.cairo_surface_flush(surface)
        stride = cairo.cairo_image_surface_get_stride(surface)
        data = cairo.cairo_image_surface_get_data(surface)
        if not ok or not data:
            cairo.cairo_destroy(cr)
            cairo.cairo_surface_destroy(surface)
            _unref(rsvg, handle)
            return None
        raw = np.ctypeslib.as_array(data, shape=(height, stride))
        buf = raw[:, : width * 4].reshape(height, width, 4).copy()
        cairo.cairo_destroy(cr)
        cairo.cairo_surface_destroy(surface)
        _unref(rsvg, handle)

    # Cairo ARGB32 is premultiplied BGRA (little endian). Un-premultiply
    # and reorder to RGBA.
    b, g, r, a = (buf[..., i].astype(np.float32) for i in range(4))
    safe_a = np.maximum(a, 1.0)
    scale = np.where(a > 0, 255.0 / safe_a, 0.0)
    rgba = np.stack([
        np.minimum(r * scale, 255), np.minimum(g * scale, 255),
        np.minimum(b * scale, 255), a], axis=-1).astype(np.uint8)
    return rgba


def svg_intrinsic_size(filename: str) -> Optional[Tuple[int, int]]:
    libs = _load()
    if libs is None:
        return None
    rsvg, _ = libs
    handle = rsvg.rsvg_handle_new_from_file(filename.encode(), None)
    if not handle:
        return None
    w = ctypes.c_double()
    h = ctypes.c_double()
    got = rsvg.rsvg_handle_get_intrinsic_size_in_pixels(
        handle, ctypes.byref(w), ctypes.byref(h))
    _unref(rsvg, handle)
    # Suspicious dimensions on EITHER axis take the fallback, like the
    # reference's guard (svg-image-source.cc:78-83) -- a 0 height would
    # otherwise divide by zero in render_svg.
    if not got or w.value <= 0 or h.value <= 0:
        return (512, 512)  # fallback like viewbox-less SVGs
    return (int(round(w.value)), int(round(h.value)))


class SVGSource(ImageSource):
    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "svg"

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        if not self.filename.lower().endswith((".svg", ".svgz")):
            return False
        size = svg_intrinsic_size(self.filename)
        if size is None:
            return False
        self.orig_width, self.orig_height = size
        tw, th, _ = calc_scale_to_fit(self.orig_width, self.orig_height,
                                      options)
        rgba = render_svg(self.filename, tw, th,
                          intrinsic=(self.orig_width, self.orig_height))
        if rgba is None:
            return False

        from timg_tpu_torch.sources.pil_source import _process_frames
        # already at target size; _process_frames only composes
        processed = _process_frames([rgba], tw, th, options)
        self.frames = [PreprocessedFrame(frame=processed[0])]
        self.indentation = (
            int((options.width - tw) / 2)
            if options.center_horizontally else 0
        )
        self.max_frames = 1
        self._options = options
        return True
