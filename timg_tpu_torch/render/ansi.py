"""Unicode block canvas: ANSI escape-stream assembly from the block planes
(counterpart of timg_tpu/render/ansi.py).

The device computes (glyph, fg, bg) planes for a whole window
(ops/blocks.py; the CUDA kernel on the card); this module turns one
frame's planes into the exact escape-byte stream of the reference viewer:

* ANSI 24-bit (``38;2;`` / ``48;2;``) or 8-bit (``38;5;``) SGR runs with
  change-detection color elision (ref src/unicode-block-canvas.cc:230-321);
* inter-frame diffing against a backing store, emitting cursor-right/down
  jumps over unchanged cells (ref :129-152, 244-262, 343-346);
* odd-height empty-line shift depending on upper/lower block use
  (ref :349-365).

The bytes come from the C emitter of the port's native helper
(``timg_ansi_emit``, native/timg_native.cc) when it builds, else from the
Python twin ``_emit_frame_py``; ``EMITTED`` counts the frames each one
wrote.  ``send`` pops BLOCK_PLANES, which the block video window primed
on the device; any other frame takes the single-frame route: the same
block op on one frame, on the port's device (the kernel on CUDA, the
plain version on the CPU).
"""

from __future__ import annotations

import threading

import numpy as np

from timg_tpu_torch.colors import as_256_term_color
from timg_tpu_torch.render.canvas import TerminalCanvas
from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType

_GLYPH_BYTES = [g.encode("utf-8") for g in
                (" ", "▘", "▝", "▖", "▗", "▌", "▚", "▄", "▀")]
_END_OF_LINE = b"\033[0m\n"

# uint8 -> b"nnn;" decimal lookup (ref unicode-block-canvas.cc:449-491).
_DEC = [b"%d;" % v for v in range(256)]

# frames written by each emitter in this process
EMITTED = {"c": 0, "python": 0}
_emitted_lock = threading.Lock()


def _count(which: str) -> None:
    with _emitted_lock:
        EMITTED[which] += 1


def _native_lib():
    from timg_tpu_torch.native import runtime
    return runtime.load()


def _emit_frame_native(lib, glyph, fg, bg, eq, indent: int,
                       use_256: bool) -> bytes:
    import ctypes

    from timg_tpu_torch.render.sixel_render import _tls_buffer

    hcells, wcells = glyph.shape
    g = np.ascontiguousarray(glyph, dtype=np.int32)
    f = np.ascontiguousarray(fg, dtype=np.uint8)
    b = np.ascontiguousarray(bg, dtype=np.uint8)
    e = (np.ascontiguousarray(eq, dtype=np.uint8)
         if eq is not None else None)
    cap = hcells * (wcells * 48 + 24) + 64
    buf = _tls_buffer(cap)
    n = lib.timg_ansi_emit(
        g.ctypes.data, f.ctypes.data, b.ctypes.data,
        e.ctypes.data if e is not None else None,
        hcells, wcells, indent, int(use_256), buf)
    _count("c")
    return ctypes.string_at(buf, n)


def _c_div2_trunc(a: int) -> int:
    """C integer division by 2 (truncation toward zero)."""
    q, _ = divmod(abs(a), 2)
    return q if a >= 0 else -q


class UnicodeBlockCanvas(TerminalCanvas):
    """ref src/unicode-block-canvas.{h,cc}."""

    def __init__(
        self,
        sequencer: BufferedWriteSequencer,
        use_quarter: bool,
        use_upper_half_block: bool = False,
        use_256_color: bool = False,
    ):
        super().__init__(sequencer)
        self.use_quarter = use_quarter
        self.use_upper_half_block = use_upper_half_block
        self.use_256_color = use_256_color
        self._prev_padded = None
        self._last_fb_height = 0
        self._last_x_indent = 0

    def cell_height_for_pixels(self, pixels: int) -> int:
        assert pixels <= 0
        return _c_div2_trunc(pixels - 1)  # ref unicode-block-canvas.h:42-45

    # ------------------------------------------------------------------
    def widen_odd_quarter(self, frame: np.ndarray) -> np.ndarray:
        """Replicate the reference's odd-width quarter-cell semantics.

        AppendDoubleRow<2> advances two pixels per cell, so at odd
        widths the rightmost cell reads one pixel past the row's end
        (ref unicode-block-canvas.cc:242-244 ``tline[1]``) -- which in
        the reference's contiguous framebuffer is the NEXT row's first
        pixel, and past the last row the (in-practice zeroed) sws
        scratch row (framebuffer.cc:56-63); the synthetic empty lines
        read their own zeroed buffer (ref :363-365, :435-438).  Widen
        the frame by that column so the glyph argmin and the diff
        backing see exactly the reference's bytes."""
        h = frame.shape[0]
        extra = np.zeros((h, 1, 4), dtype=frame.dtype)
        extra[:h - 1, 0] = frame[1:, 0]
        return np.concatenate([frame, extra], axis=1)

    def pad_frame(self, frame: np.ndarray) -> np.ndarray:
        """Apply the odd-height empty-line shift (ref :356-365)."""
        h = frame.shape[0]
        if h % 2 == 0:
            return frame
        empty = np.zeros((1,) + frame.shape[1:], dtype=frame.dtype)
        if not self.use_upper_half_block:  # row_offset = -1: blank on top
            return np.concatenate([empty, frame], axis=0)
        return np.concatenate([frame, empty], axis=0)

    def send(self, x: int, dy: int, frame, seq_type: SeqType,
             end_of_frame_ms: float = 0.0) -> None:
        """frame: [H, W, 4] uint8 (post resize/compose), or a primed
        DeviceFrame of the block video window."""
        height = frame.shape[0]
        if dy < 0:
            self.move_cursor_dy(self.cell_height_for_pixels(dy))
        if self.use_quarter:
            x //= 2  # character cell units (ref :334)

        from timg_tpu_torch.render.plane_cache import BLOCK_PLANES
        cached = BLOCK_PLANES.pop(frame)
        cached_prev = cached_eq = None
        if cached is not None:
            padded, glyph, fg, bg, cached_prev, cached_eq = cached
        else:
            frame = np.ascontiguousarray(frame)
            if self.use_quarter and frame.shape[1] % 2:
                frame = self.widen_odd_quarter(frame)
            padded = self.pad_frame(frame)
            glyph, fg, bg = self._single_frame(padded)

        self.send_planes(x, dy, height, padded, glyph, fg, bg,
                         seq_type, end_of_frame_ms,
                         cached_prev=cached_prev, cached_eq=cached_eq)

    def _single_frame(self, padded: np.ndarray):
        """The block op on one padded frame on the port's device."""
        import torch

        from timg_tpu_torch.ops import backend
        from timg_tpu_torch.ops import blocks as blocks_op

        fn = (blocks_op.quarter_blocks if self.use_quarter
              else blocks_op.half_blocks)
        t = torch.from_numpy(np.ascontiguousarray(padded)[None]).to(
            backend.device())
        glyph, fg, bg = fn(t, use_upper_half_block=self.use_upper_half_block)
        return glyph[0].cpu().numpy(), fg[0].cpu().numpy(), \
            bg[0].cpu().numpy()

    def send_planes(
        self,
        x: int,
        dy: int,
        height: int,
        padded,
        glyph: np.ndarray,
        fg: np.ndarray,
        bg: np.ndarray,
        seq_type: SeqType,
        end_of_frame_ms: float = 0.0,
        cached_prev=None,
        cached_eq: np.ndarray | None = None,
    ) -> None:
        """Assemble and enqueue the escape stream for precomputed planes."""
        emit_diff = (
            x == self._last_x_indent
            and self._last_fb_height > 0
            and abs(dy) == self._last_fb_height
            and self._prev_padded is not None
            and self._prev_padded.shape == padded.shape
        )
        if not emit_diff:
            eq = None
        elif cached_eq is not None and cached_prev is self._prev_padded:
            eq = cached_eq  # device-computed window diff
        else:
            n = 2 if self.use_quarter else 1
            hcells, wcells = glyph.shape
            cur = padded.reshape(hcells, 2, wcells, n, 4)
            prev = self._prev_padded.reshape(hcells, 2, wcells, n, 4)
            eq = np.all(cur == prev, axis=(1, 3, 4))  # [hcells, wcells]

        prefix = self.consume_prefix()
        body = self._emit_frame(glyph, fg, bg, eq, indent=x)

        self._last_fb_height = height
        self._last_x_indent = x
        self._prev_padded = padded

        if not body:
            # Nothing changed: zero-size write, prefix intentionally
            # dropped like the reference (ref :390-395).
            self._sequencer.write_buffer(b"", seq_type, end_of_frame_ms)
            return
        self._sequencer.write_buffer(prefix + body, seq_type, end_of_frame_ms)

    # ------------------------------------------------------------------
    def _emit_frame(self, glyph, fg, bg, eq, indent: int) -> bytes:
        """AppendDoubleRow over all rows (ref :229-321, 361-399): the C
        emitter when it builds, else the Python twin (same bytes)."""
        native = _native_lib()
        if native is not None:
            return _emit_frame_native(native, glyph, fg, bg, eq, indent,
                                      self.use_256_color)
        return self._emit_frame_py(glyph, fg, bg, eq, indent)

    def _emit_frame_py(self, glyph, fg, bg, eq, indent: int) -> bytes:
        _count("python")
        out = bytearray()
        use_256 = self.use_256_color
        hcells, wcells = glyph.shape
        glyphs = glyph.tolist()
        fgs = fg.tolist()
        bgs = bg.tolist()
        eqs = eq.tolist() if eq is not None else None
        dec = _DEC

        y_skip = 0
        for r in range(hcells):
            grow, frow, brow = glyphs[r], fgs[r], bgs[r]
            erow = eqs[r] if eqs is not None else None
            x_skip = indent
            row_start_len = len(out)
            last_fg = None          # last *emitted* foreground (ref :237)
            last_bg = None          # previous cell's bg pick (ref :282)
            for c in range(wcells):
                if erow is not None and erow[c]:
                    x_skip += 1
                    continue
                if y_skip:  # newline vs cursor-down (ref :249-258)
                    if y_skip <= 4:
                        out.extend(b"\n" * y_skip)
                    else:
                        out.extend(b"\033[%dB" % y_skip)
                    y_skip = 0
                if x_skip > 0:
                    out.extend(b"\033[%dC" % x_skip)
                    x_skip = 0

                g = grow[c]
                f = frow[c]
                b = brow[c]
                color_emitted = False
                if g != 0 and f != last_fg:  # fg elision (ref :270-279)
                    out.extend(b"\033[")
                    if use_256:
                        out.extend(b"38;5;")
                        out.extend(dec[as_256_term_color(f[0], f[1], f[2])])
                    else:
                        out.extend(b"38;2;")
                        out.extend(dec[f[0]])
                        out.extend(dec[f[1]])
                        out.extend(dec[f[2]])
                    color_emitted = True
                    last_fg = f
                if b != last_bg:  # bg elision (ref :281-297)
                    if not color_emitted:
                        out.extend(b"\033[")
                    if b[3] < 0x60:  # transparent bg: reset (ref :286-289)
                        out.extend(b"49;")
                    else:
                        if use_256:
                            out.extend(b"48;5;")
                            out.extend(dec[as_256_term_color(b[0], b[1], b[2])])
                        else:
                            out.extend(b"48;2;")
                            out.extend(dec[b[0]])
                            out.extend(dec[b[1]])
                            out.extend(dec[b[2]])
                    color_emitted = True
                if color_emitted:
                    out[-1] = 0x6D  # overwrite trailing ';' with 'm' (ref :300)
                out.extend(_GLYPH_BYTES[g])
                last_bg = b

            if len(out) == row_start_len:
                y_skip += 1  # whole line unchanged (ref :313-314)
            else:
                out.extend(_END_OF_LINE)

        if out and y_skip:
            out.extend(b"\033[%dB" % y_skip)  # ref :397-399
        return bytes(out)
