"""Sixel escape-stream assembly and canvas (counterpart of
timg_tpu/render/sixel_render.py).

Behavioral spec: ref src/sixel-canvas.cc. The canvas rounds the frame
height up to a multiple of 6 with a background-composed strip
(ref :109-120), emits per-terminal cursor-placement quirk sequences
(ref :66-79), and paces output through the sequencer. This module turns
the palette + index planes into the DCS byte stream:

  ESC P q " 1;1;W;H  #i;2;r%;g%;b%...  bands of 6 rows  ESC backslash

with per-band per-color runs, '!' RLE, '$' carriage returns and '-' line
feeds, matching libsixel's emitter structure (quality/feature flags per
sixel-canvas.cc:134-148).

Assembly runs in the C assembler of the port's native helper
(native/timg_native.cc) when it builds, else in the pure-Python twin
``encode_sixel_stream_py``; ``ASSEMBLED`` counts the frames each one
assembled, so a run can show which set its time.  ``send`` pops the
port's SIXEL_PLANES, which the video window and the RGBA windows (stills,
animations, scroll) primed on the device in ``cube``, ``libsixel`` or
``adaptive`` mode.  A frame that was not primed takes the single-frame
route: a one-shot libsixel still libsixel's own C quantizer in the
compression pool (as the reference), anything else the session's
dither on the device at B=1.  A frame may come as a plane,
as run records (``encode_sixel_stream_runs``, the C assembler's records
entry) or as device-emitted DCS bands (``encode_sixel_stream_dcs``, a
splice), whichever ops/sixel_runs.py fetched.  The library's sixel model
assembles a batch's planes over a pool of host threads
(``encode_sixel_streams``).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from timg_tpu_torch import tracing
from timg_tpu_torch.ops import backend
from timg_tpu_torch.ops.sixel_dcs import SixelDcs, splice_host
from timg_tpu_torch.ops.sixel_runs import SixelRuns, expand_runs_np
from timg_tpu_torch.options import DisplayOptions, SixelOptions
from timg_tpu_torch.render.canvas import TerminalCanvas
from timg_tpu_torch.render.plane_cache import SIXEL_PLANES, not_ported
from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType

CSI = b"\033["

# frames assembled by each assembler in this process (the compression
# pool's threads count into it, so under a lock)
ASSEMBLED = {"c": 0, "python": 0}
_assembled_lock = threading.Lock()


def _count(which: str) -> None:
    with _assembled_lock:
        ASSEMBLED[which] += 1


_tls = None


def _tls_buffer(cap: int):
    """Thread-local output buffer for the C assembler, grown on
    demand.  The capacity bound is the no-runs worst case (~tens of MB
    at video sizes); ctypes.create_string_buffer zeroes its memory, so
    allocating per frame would cost more than the assembly itself
    (~40 MB memset vs ~10 ms of encoding at 720p).  Compression-pool
    threads each keep their own buffer (the C side keeps its mask
    arena thread-local too)."""
    import ctypes

    global _tls
    if _tls is None:
        _tls = threading.local()
    buf = getattr(_tls, "buf", None)
    if buf is None or ctypes.sizeof(buf) < cap:
        buf = ctypes.create_string_buffer(cap)
        _tls.buf = buf
    return buf


def _pct(v: int) -> int:
    """0..255 -> 0..100 percent as libsixel converts palette entries."""
    return (int(v) * 100 + 127) // 255


def encode_sixel_stream(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """indices: [H, W] int; palette: [N, 3] uint8 -> sixel DCS payload.

    Uses the C assembler when available (same bytes; ~50x faster for
    video-rate streams); the Python implementation below is the
    roundtrip-tested spec."""
    from timg_tpu_torch.native import runtime

    lib = runtime.load()
    if lib is not None and len(palette) <= 256:
        import ctypes

        h, w = indices.shape
        idx = np.asarray(indices)
        if idx.dtype != np.uint8 or idx.strides[1] != 1:
            idx = np.ascontiguousarray(indices, dtype=np.uint8)
        pitch = idx.strides[0]  # padded device planes pass their pitch
        pal = np.ascontiguousarray(palette[:, :3], dtype=np.uint8)
        # worst case: every color present in every band with no runs
        n_bands = (h + 5) // 6
        cap = n_bands * len(pal) * (w + 12) + len(pal) * 20 + 256
        buf = _tls_buffer(cap)
        n = lib.timg_sixel_encode(idx.ctypes.data, h, w, pitch,
                                  pal.ctypes.data, len(pal), buf)
        if n >= 0:
            _count("c")
            return ctypes.string_at(buf, n)
    return encode_sixel_stream_py(indices, palette)


_pool = None              # the assembly threads, built on first use
_pool_lock = threading.Lock()


def _host_cpus() -> int:
    """The CPUs this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:    # a platform without affinity
        return os.cpu_count() or 1


def _assembly_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=_host_cpus(),
                                       thread_name_prefix="timg-sixel")
        return _pool


def _assemble(plane) -> bytes:
    """One plane's payload, in the ``lib.assemble`` span of the thread
    that assembles it (count: the payload's bytes).  The module's
    ``encode_sixel_stream`` is looked up at each call."""
    with tracing.span("lib.assemble") as s:
        payload = encode_sixel_stream(*plane)
        s.count = len(payload)
    return payload


def encode_sixel_streams(planes) -> list:
    """[(indices, palette), ...] -> their payloads in the same order,
    each ``encode_sixel_stream``'s bytes.  The assemblies run at once
    over one pool of host threads for the process, as many as the CPUs
    it may run on and no more than the planes: the C assembler drops the
    interpreter's lock, and its output buffer and mask arena are the
    thread's own.  At a width of 1 (one plane, or one CPU) they run on
    the calling thread, and no thread starts."""
    width = min(_host_cpus(), len(planes))
    if width <= 1:
        return [_assemble(plane) for plane in planes]
    return list(_assembly_pool().map(_assemble, planes))


def encode_sixel_stream_runs(runs, palette: np.ndarray) -> bytes:
    """SixelRuns (device-compacted column runs, ops/sixel_runs.py) ->
    sixel DCS payload, byte-identical to encode_sixel_stream on the
    expanded plane.  Uses the C assembler's records entry point (cost
    scales with run count, not h*w); falls back to plane expansion
    (``encode_sixel_stream``, which counts the frame)."""
    from timg_tpu_torch.native import runtime

    lib = runtime.load()
    if lib is not None and len(palette) <= 256:
        import ctypes

        records = np.ascontiguousarray(runs.records, dtype=np.int32)
        band_counts = np.ascontiguousarray(runs.band_counts,
                                           dtype=np.int32)
        pal = np.ascontiguousarray(palette[:, :3], dtype=np.uint8)
        n_bands = (runs.h + 5) // 6
        cap = (n_bands * len(pal) * (runs.w + 12) + len(pal) * 20 + 256)
        buf = _tls_buffer(cap)
        n = lib.timg_sixel_encode_runs(
            records.ctypes.data, band_counts.ctypes.data, runs.h,
            runs.w, pal.ctypes.data, len(pal), buf)
        if n >= 0:
            _count("c")
            return ctypes.string_at(buf, n)
    return encode_sixel_stream(expand_runs_np(runs), palette)


def encode_sixel_stream_dcs(dcs, palette: np.ndarray) -> bytes:
    """SixelDcs (device-emitted DCS body, ops/sixel_dcs.py) -> full
    sixel payload, byte-identical to encode_sixel_stream on the source
    plane.  The host work is one join of band slices; no assembler runs
    (``ASSEMBLED`` does not count it)."""
    return splice_host(dcs.bands, dcs.band_lens, dcs.h, dcs.w,
                       np.ascontiguousarray(palette[:, :3], np.uint8))


def encode_sixel_stream_py(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """Pure-python sixel assembly (reference implementation)."""
    _count("python")
    h, w = indices.shape
    n = len(palette)
    out = bytearray()
    out += b"\033Pq"  # libsixel default header (params omitted when 0)
    out += b'"1;1;%d;%d' % (w, h)
    for i, (r, g, b) in enumerate(palette):
        out += b"#%d;2;%d;%d;%d" % (i, _pct(r), _pct(g), _pct(b))

    n_bands = (h + 5) // 6
    for band in range(n_bands):
        y0 = band * 6
        rows = indices[y0:y0 + 6]                      # [<=6, W]
        pad = 6 - rows.shape[0]
        if pad:
            rows = np.concatenate(
                [rows, np.full((pad, w), -1, rows.dtype)], axis=0)
        colors = np.unique(rows)
        # indices outside the palette are dropped, as the C assembler's
        # emission loop (and libsixel itself) cap at n_colors
        colors = colors[(colors >= 0) & (colors < n)]
        first = True
        for color in colors:
            mask = (rows == color)                     # [6, W]
            bits = (mask * (1 << np.arange(6))[:, None]).sum(axis=0)  # [W]
            if not bits.any():
                continue
            if not first:
                out += b"$"
            first = False
            out += b"#%d" % color
            out += _rle_sixels(bits.astype(np.uint8))
        if band != n_bands - 1:
            out += b"-"
    out += b"\033\\"
    return bytes(out)


def _rle_sixels(bits: np.ndarray) -> bytes:
    """Run-length encode one color's band row: '?'+bits chars, '!n' RLE."""
    chars = bits + 0x3F
    out = bytearray()
    i = 0
    n = len(chars)
    # find run boundaries vectorized
    change = np.flatnonzero(np.diff(chars)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    for s, e in zip(starts, ends):
        run = int(e - s)
        c = int(chars[s])
        if c == 0x3F and e == n:
            break  # trailing empty pixels can be omitted
        if run > 3:
            out += b"!%d%c" % (run, c)
        else:
            out += bytes([c]) * run
    return bytes(out)


def decode_sixel_stream(data: bytes):
    """Minimal sixel decoder for roundtrip tests. Returns (rgb [H,W,3],
    palette)."""
    assert data.startswith(b"\033P") and data.endswith(b"\033\\")
    body = data[data.index(b"q") + 1:-2].decode("latin-1")
    palette = {}
    i = 0
    x = y = 0
    max_x = max_y = 0
    cells = {}
    cur_color = 0
    repeat = 1
    if body.startswith('"'):
        # raster attributes "p1;p2;w;h
        j = 1
        while j < len(body) and (body[j].isdigit() or body[j] == ";"):
            j += 1
        i = j
    while i < len(body):
        ch = body[i]
        if ch == "#":
            j = i + 1
            while j < len(body) and (body[j].isdigit() or body[j] == ";"):
                j += 1
            parts = body[i + 1:j].split(";")
            if len(parts) >= 5:
                idx, _, r, g, b = (int(p) for p in parts[:5])
                palette[idx] = (r * 255 + 50) // 100, (g * 255 + 50) // 100, \
                    (b * 255 + 50) // 100
            else:
                cur_color = int(parts[0])
            i = j
        elif ch == "!":
            j = i + 1
            while body[j].isdigit():
                j += 1
            repeat = int(body[i + 1:j])
            i = j
        elif ch == "$":
            x = 0
            i += 1
        elif ch == "-":
            x = 0
            y += 6
            i += 1
        elif "?" <= ch <= "~":
            bits = ord(ch) - 0x3F
            for _ in range(repeat):
                for k in range(6):
                    if bits & (1 << k):
                        cells[(y + k, x)] = cur_color
                        max_y = max(max_y, y + k)
                x += 1
                max_x = max(max_x, x)
            repeat = 1
            i += 1
        else:
            i += 1
    h, w = max_y + 1, max_x
    rgb = np.zeros((h, w, 3), dtype=np.uint8)
    idx_plane = np.full((h, w), -1, dtype=np.int32)
    for (yy, xx), c in cells.items():
        idx_plane[yy, xx] = c
        rgb[yy, xx] = palette.get(c, (0, 0, 0))
    return rgb, idx_plane, palette


class SixelCanvas(TerminalCanvas):
    """ref src/sixel-canvas.{h,cc}."""

    def __init__(self, sequencer: BufferedWriteSequencer,
                 sixel_options: SixelOptions, options: DisplayOptions,
                 dither: str = "adaptive", executor=None):
        super().__init__(sequencer)
        self._options = options
        self._dither = dither  # "cube" | "libsixel" | "adaptive"
        # Compression pool: byte assembly runs async, future handed to
        # the sequencer (the reference encodes sixel in the shared
        # compression ThreadPool, ref timg.cc:321-336,
        # sixel-canvas.cc:128-154).
        self._executor = executor
        self._full_cell_jump = sixel_options.full_cell_jump
        if not sixel_options.known_broken_cursor_placement:  # ref :66-79
            self._before = CSI + b"80h" + CSI + b"?7730h" + CSI + b"?8452l"
            self._after = b"\r"
        else:
            self._before = CSI + b"80l" + CSI + b"?7730l" + CSI + b"?8452h"
            self._after = b"\n"

    def cell_height_for_pixels(self, pixels: int) -> int:
        """ref sixel-canvas.cc:157-172."""
        assert pixels <= 0
        pixels = -pixels
        rounded = _round_to_sixel(pixels)
        cell_y = self._options.cell_y_px
        if self._full_cell_jump:
            return -((rounded - 6) // cell_y + 1)
        return -((rounded + cell_y - 1) // cell_y)

    def send(self, x: int, dy: int, frame, seq_type: SeqType,
             end_of_frame_ms: float = 0.0) -> None:
        from timg_tpu_torch.ops.sixel_np import cube_palette

        if self._dither not in ("cube", "libsixel", "adaptive"):
            raise not_ported(f"--dither={self._dither}")
        if dy < 0:
            self.move_cursor_dy(self.cell_height_for_pixels(dy))
        self.move_cursor_dx(x // self._options.cell_x_px)

        # Batched path: sources prime whole windows in one device
        # dispatch (the same planes; see plane_cache).
        primed = SIXEL_PLANES.pop(frame)
        if primed is not None:
            indices, palette, quantizer = primed
            if palette is None:
                palette = cube_palette()
            else:
                self._quantizer = quantizer
            self._enqueue(indices, palette, seq_type, end_of_frame_ms)
            return

        h, w = frame.shape[:2]
        padded_h = _round_to_sixel(h)
        fb = np.zeros((padded_h, w, 4), dtype=np.uint8)
        fb[:h] = frame
        if padded_h > h and self._options.bgcolor_getter:
            # pad strip alpha-composed with background (ref :109-120)
            bg = self._options.bgcolor_getter()
            if bg[3] != 0:
                fb[h:, :, :3] = bg[:3]
                fb[h:, :, 3] = 255

        if self._dither == "libsixel":
            if seq_type in (SeqType.START_OF_ANIMATION,
                            SeqType.ANIMATION_FRAME):
                # an animation frame that missed the primed planes takes
                # the windows' route at B=1 (plane_cache.
                # prime_sixel_planes): its palette, then the bucket
                # tables and the table dither on the device
                from timg_tpu_torch.render.plane_cache import (
                    frame_palette, table_dither)
                pal, diffuse = frame_palette(fb)
                words = torch.from_numpy(fb.view(np.int32)[None, ..., 0])
                indices = table_dither(words.to(backend.device()), [pal],
                                       [diffuse], padded_h, w)[0]
                indices = indices.cpu().numpy()
                self._enqueue(indices, pal, seq_type, end_of_frame_ms)
                return
            # Stills: libsixel's own quantizer on the host inside the
            # compression pool -- the reference's architecture, whose
            # encode_fun runs sixel_dither_initialize + sixel_encode in
            # the pool per frame (ref sixel-canvas.cc:128-154).
            self._enqueue_libsixel(fb, seq_type, end_of_frame_ms)
            return
        from timg_tpu_torch.ops import sixel as sixel_op

        x_dev = torch.from_numpy(fb[None]).to(backend.device())
        if self._dither == "cube":
            palette = cube_palette()
            indices = sixel_op.fs_dither_cube(x_dev, out_u8=True)[0]
        else:
            # Adaptive palettes are rebuilt per still image but reused
            # across animation frames (refreshed at every animation
            # start), as the JAX canvas does.
            if (seq_type == SeqType.ANIMATION_FRAME
                    and getattr(self, "_quantizer", None) is not None):
                palette, levels, leaves = self._quantizer
            else:
                palette, levels, leaves = sixel_op.median_cut_tree(
                    fb[..., :3])
                self._quantizer = (palette, levels, leaves)
            indices = sixel_op.fs_dither_tree(x_dev, levels, leaves,
                                              out_u8=True)[0]
        self._enqueue(indices.cpu().numpy(), palette, seq_type,
                      end_of_frame_ms)

    def _enqueue_libsixel(self, fb: np.ndarray, seq_type: SeqType,
                          end_of_frame_ms: float) -> None:
        """Quantize with libsixel's C quantizer (the Python oracle where
        the native helper does not build) and assemble, all inside the
        pooled closure."""
        prefix = self.consume_prefix()

        def assemble() -> bytes:
            from timg_tpu_torch.native import runtime

            result = runtime.libsixel_quant(fb)
            if result is None:  # no native helper: the scalar oracle
                from timg_tpu_torch.ops import libsixel_quant as lsq
                result = lsq.quantize_reference(fb)
            indices, palette = result
            out = bytearray(prefix)
            out += self._before
            out += encode_sixel_stream(indices, palette)
            out += self._after
            return bytes(out)

        if self._executor is not None:
            self._sequencer.write_buffer(self._executor.submit(assemble),
                                         seq_type, end_of_frame_ms)
        else:
            self._sequencer.write_buffer(assemble(), seq_type,
                                         end_of_frame_ms)

    def _enqueue(self, indices, palette, seq_type: SeqType,
                 end_of_frame_ms: float) -> None:
        """Assemble + hand to the sequencer; async when pooled."""
        prefix = self.consume_prefix()
        if isinstance(indices, SixelRuns):
            encode = encode_sixel_stream_runs
        elif isinstance(indices, SixelDcs):
            encode = encode_sixel_stream_dcs
        else:
            encode = encode_sixel_stream

        def assemble() -> bytes:
            out = bytearray(prefix)
            out += self._before
            out += encode(indices, palette)
            out += self._after
            return bytes(out)

        if self._executor is not None:
            self._sequencer.write_buffer(self._executor.submit(assemble),
                                         seq_type, end_of_frame_ms)
        else:
            self._sequencer.write_buffer(assemble(), seq_type,
                                         end_of_frame_ms)


def _round_to_sixel(pixels: int) -> int:
    """Round up to a multiple of 6 (ref sixel-canvas.cc:91-94)."""
    pixels += 5
    return pixels - pixels % 6
