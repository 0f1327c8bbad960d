"""PDF decoder via poppler-glib + cairo (ctypes).

The port's copy of timg_tpu/sources/pdf_source.py; only the imports differ.

Behavioral spec: ref src/pdf-image-source.cc — document opened by URI
(ref :47-51), page range from frame_offset/frame_count (ref :57-63),
optional bounding-box auto-crop (ref :70-82), each page rendered into a
cairo ARGB32 surface scaled to the already-computed target size with a
white background paint (ref :89-108), channel swap to RGBA (ref
:116-119), and every page emitted as its own immediate frame (ref
:134-141).  Like the SVG source, rendering serializes behind the global
cairo render lock.

Gated exactly like a reference build configured without WITH_POPPLER
when poppler-glib is absent: reports a clear error instead of silently
failing.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import FrameSink, ImageSource, PreprocessedFrame
from timg_tpu_torch.sources.svg_source import _render_lock

_CAIRO_FORMAT_ARGB32 = 0


class _PopplerRectangle(ctypes.Structure):
    _fields_ = [("x1", ctypes.c_double), ("y1", ctypes.c_double),
                ("x2", ctypes.c_double), ("y2", ctypes.c_double)]


_libs: Optional[Tuple[ctypes.CDLL, ctypes.CDLL, ctypes.CDLL]] = None
_tried = False


def _load() -> Optional[Tuple[ctypes.CDLL, ctypes.CDLL, ctypes.CDLL]]:
    """(poppler-glib, cairo, gobject) or None.  Overridable for tests via
    TIMG_POPPLER_GLIB_LIB pointing at a mock .so."""
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    name = os.environ.get("TIMG_POPPLER_GLIB_LIB", "libpoppler-glib.so.8")
    try:
        poppler = ctypes.CDLL(name)
        cairo = ctypes.CDLL("libcairo.so.2")
        # g_object_unref resolves through poppler-glib's own dependency
        # on gobject (dlsym searches dependencies); the test mock
        # exports a no-op instead, since its handles are not GObjects.
        gobject = (poppler if hasattr(poppler, "g_object_unref")
                   else ctypes.CDLL("libgobject-2.0.so.0"))
    except OSError:
        return None

    poppler.poppler_document_new_from_file.restype = ctypes.c_void_p
    poppler.poppler_document_new_from_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p]
    poppler.poppler_document_get_n_pages.restype = ctypes.c_int
    poppler.poppler_document_get_n_pages.argtypes = [ctypes.c_void_p]
    poppler.poppler_document_get_page.restype = ctypes.c_void_p
    poppler.poppler_document_get_page.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
    poppler.poppler_page_get_size.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    poppler.poppler_page_render.argtypes = [ctypes.c_void_p,
                                            ctypes.c_void_p]
    if hasattr(poppler, "poppler_page_get_bounding_box"):
        # poppler >= 0.88, like the reference's version gate (ref :70)
        poppler.poppler_page_get_bounding_box.restype = ctypes.c_bool
        poppler.poppler_page_get_bounding_box.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_PopplerRectangle)]

    cairo.cairo_image_surface_create.restype = ctypes.c_void_p
    cairo.cairo_image_surface_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_int]
    cairo.cairo_create.restype = ctypes.c_void_p
    cairo.cairo_create.argtypes = [ctypes.c_void_p]
    cairo.cairo_scale.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                  ctypes.c_double]
    cairo.cairo_translate.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_double]
    cairo.cairo_set_source_rgb.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                           ctypes.c_double, ctypes.c_double]
    cairo.cairo_paint.argtypes = [ctypes.c_void_p]
    cairo.cairo_save.argtypes = [ctypes.c_void_p]
    cairo.cairo_restore.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_data.restype = ctypes.POINTER(
        ctypes.c_ubyte)
    cairo.cairo_image_surface_get_data.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_stride.restype = ctypes.c_int
    cairo.cairo_image_surface_get_stride.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_flush.argtypes = [ctypes.c_void_p]
    cairo.cairo_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_destroy.argtypes = [ctypes.c_void_p]

    gobject.g_object_unref.argtypes = [ctypes.c_void_p]
    _libs = (poppler, cairo, gobject)
    return _libs


def poppler_available() -> bool:
    return _load() is not None


def _render_page(poppler, cairo, page, bbox: _PopplerRectangle,
                 orig_w: float, orig_h: float, render_w: int,
                 render_h: int) -> Optional[np.ndarray]:
    """One page -> [render_h, render_w, 4] RGBA (ref :89-119)."""
    with _render_lock:
        surface = cairo.cairo_image_surface_create(
            _CAIRO_FORMAT_ARGB32, render_w, render_h)
        cr = cairo.cairo_create(surface)
        cairo.cairo_scale(cr, render_w / orig_w, render_h / orig_h)
        cairo.cairo_translate(cr, -bbox.x1, -bbox.y1)
        cairo.cairo_save(cr)
        # white page background (ref :104-106)
        cairo.cairo_set_source_rgb(cr, 1.0, 1.0, 1.0)
        cairo.cairo_paint(cr)
        poppler.poppler_page_render(page, cr)
        cairo.cairo_restore(cr)
        cairo.cairo_surface_flush(surface)
        stride = cairo.cairo_image_surface_get_stride(surface)
        data = cairo.cairo_image_surface_get_data(surface)
        if not data:
            cairo.cairo_destroy(cr)
            cairo.cairo_surface_destroy(surface)
            return None
        raw = np.ctypeslib.as_array(data, shape=(render_h, stride))
        buf = raw[:, : render_w * 4].reshape(render_h, render_w, 4).copy()
        cairo.cairo_destroy(cr)
        cairo.cairo_surface_destroy(surface)

    # ARGB32 little-endian = BGRA in memory; white paint makes the page
    # opaque, so a plain R<->B swap suffices (ref :116-119).
    rgba = buf[..., [2, 1, 0, 3]]
    return np.ascontiguousarray(rgba)


class PDFSource(ImageSource):
    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "pdf"
        self._options: Optional[DisplayOptions] = None

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        if not self.filename.lower().endswith(".pdf"):
            return False
        libs = _load()
        if libs is None:
            raise RuntimeError(
                f"{self.filename}: PDF support needs poppler-glib, which "
                "is not available (like a timg build without "
                "WITH_POPPLER)")
        poppler, cairo, gobject = libs

        uri = b"file://" + os.path.abspath(self.filename).encode()
        document = poppler.poppler_document_new_from_file(uri, None, None)
        if not document:
            return False

        try:
            page_count = poppler.poppler_document_get_n_pages(document)
            start_page = max(0, frame_offset)
            max_display_page = (
                page_count if frame_count < 0
                else min(page_count, start_page + frame_count))

            frames: List[PreprocessedFrame] = []
            for page_num in range(start_page, max_display_page):
                page = poppler.poppler_document_get_page(document, page_num)
                if not page:
                    return False
                try:
                    bbox = _PopplerRectangle(0.0, 0.0, 0.0, 0.0)
                    got_bbox = False
                    if (options.auto_crop
                            and hasattr(poppler,
                                        "poppler_page_get_bounding_box")):
                        ok = poppler.poppler_page_get_bounding_box(
                            page, ctypes.byref(bbox))
                        # a blank page returns FALSE / a degenerate
                        # box; fall back to the page size like the
                        # reference (ref pdf-image-source.cc:70-82)
                        got_bbox = bool(ok) and bbox.x2 > bbox.x1 \
                            and bbox.y2 > bbox.y1
                    if got_bbox:
                        self.orig_width = bbox.x2 - bbox.x1
                        self.orig_height = bbox.y2 - bbox.y1
                    else:
                        w = ctypes.c_double()
                        h = ctypes.c_double()
                        poppler.poppler_page_get_size(
                            page, ctypes.byref(w), ctypes.byref(h))
                        self.orig_width, self.orig_height = w.value, h.value
                        bbox = _PopplerRectangle(0.0, 0.0, w.value, h.value)

                    rw, rh, _ = calc_scale_to_fit(
                        self.orig_width, self.orig_height, options)
                    rgba = _render_page(poppler, cairo, page, bbox,
                                        self.orig_width, self.orig_height,
                                        rw, rh)
                    if rgba is None:
                        return False
                    # already at target size; _process_frames composes
                    # (a no-op for the opaque white page) and keeps the
                    # device/CPU pipeline consistent with the SVG source
                    from timg_tpu_torch.sources.pil_source import _process_frames
                    processed = _process_frames([rgba], rw, rh, options)
                    frames.append(PreprocessedFrame(frame=processed[0]))
                finally:
                    gobject.g_object_unref(page)
        finally:
            gobject.g_object_unref(document)

        if not frames:
            return False
        self.frames = frames
        self.max_frames = len(frames)
        self.orig_width = int(self.orig_width)
        self.orig_height = int(self.orig_height)
        self._options = options
        return True

    def is_animation_before_frame_limit(self) -> bool:
        return False  # pages are not an animation

    def send_frames(self, duration_ms: float, loops: int, interrupt,
                    sink: FrameSink) -> None:
        """Every page once, immediately, stacked (ref :134-141)."""
        from timg_tpu_torch.render.sequencer import SeqType

        opts = self._options
        for f in self.frames:
            if interrupt():
                break
            dx = 0
            if opts is not None and opts.center_horizontally:
                dx = int((opts.width - f.frame.shape[1]) / 2)
            sink(dx, 0, f.frame, SeqType.FRAME_IMMEDIATE, 0.0)
