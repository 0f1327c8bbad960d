"""Kitty graphics protocol canvas of the port: its own copy of
timg_tpu/render/kitty.py, the imports rewritten.

Behavioral spec: ref src/kitty-canvas.cc. PNG -> base64 in <= 4096-char
chunks framed as ``ESC _ G a=T,i=<id>,q=2,f=100,m=<more>; ... ESC \\``,
unique ids per image and two flip-flop ids per animation (ref :143-172),
tmux passthrough wrapping with unicode-placeholder tiles (ref :55-111,
260-344).
"""

from __future__ import annotations

import base64
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np

from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.render.canvas import TerminalCanvas
from timg_tpu_torch.render.png import encode_png
from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType

_B64_CHUNK = 4096          # max allowed by the protocol (ref :43)
_BYTE_CHUNK = _B64_CHUNK // 4 * 3

TMUX_START = b"\033Ptmux;"
TMUX_END = b"\033\\"

# Row/column diacritics for unicode placeholders (kitty graphics protocol
# rowcolumn-diacritics.txt; ref kitty-canvas.cc:280-331).
_ROWCOL = [
    0x0305, 0x030D, 0x030E, 0x0310, 0x0312, 0x033D, 0x033E, 0x033F,
    0x0346, 0x034A, 0x034B, 0x034C, 0x0350, 0x0351, 0x0352, 0x0357,
    0x035B, 0x0363, 0x0364, 0x0365, 0x0366, 0x0367, 0x0368, 0x0369,
    0x036A, 0x036B, 0x036C, 0x036D, 0x036E, 0x036F, 0x0483, 0x0484,
    0x0485, 0x0486, 0x0487, 0x0592, 0x0593, 0x0594, 0x0595, 0x0597,
    0x0598, 0x0599, 0x059C, 0x059D, 0x059E, 0x059F, 0x05A0, 0x05A1,
    0x05A8, 0x05A9, 0x05AB, 0x05AC, 0x05AF, 0x05C4, 0x0610, 0x0611,
    0x0612, 0x0613, 0x0614, 0x0615, 0x0616, 0x0617, 0x0657, 0x0658,
    0x0659, 0x065A, 0x065B, 0x065D, 0x065E, 0x06D6, 0x06D7, 0x06D8,
    0x06D9, 0x06DA, 0x06DB, 0x06DC, 0x06DF, 0x06E0, 0x06E1, 0x06E2,
    0x06E4, 0x06E7, 0x06E8, 0x06EB, 0x06EC, 0x0730, 0x0732, 0x0733,
    0x0735, 0x0736, 0x073A, 0x073D, 0x073F, 0x0740, 0x0741, 0x0743,
    0x0745, 0x0747, 0x0749, 0x074A, 0x07EB, 0x07EC, 0x07ED, 0x07EE,
    0x07EF, 0x07F0, 0x07F1, 0x07F3, 0x0816, 0x0817, 0x0818, 0x0819,
    0x081B, 0x081C, 0x081D, 0x081E, 0x081F, 0x0820, 0x0821, 0x0822,
    0x0823, 0x0825, 0x0826, 0x0827, 0x0829, 0x082A, 0x082B, 0x082C,
    0x082D, 0x0951, 0x0953, 0x0954, 0x0F82, 0x0F83, 0x0F86, 0x0F87,
    0x135D, 0x135E, 0x135F, 0x17DD, 0x193A, 0x1A17, 0x1A75, 0x1A76,
    0x1A77, 0x1A78, 0x1A79, 0x1A7A, 0x1A7B, 0x1A7C, 0x1B6B, 0x1B6D,
    0x1B6E, 0x1B6F, 0x1B70, 0x1B71, 0x1B72, 0x1B73, 0x1CD0, 0x1CD1,
    0x1CD2, 0x1CDA, 0x1CDB, 0x1CE0, 0x1DC0, 0x1DC1, 0x1DC3, 0x1DC4,
    0x1DC5, 0x1DC6, 0x1DC7, 0x1DC8, 0x1DC9, 0x1DCB, 0x1DCC, 0x1DD1,
    0x1DD2, 0x1DD3, 0x1DD4, 0x1DD5, 0x1DD6, 0x1DD7, 0x1DD8, 0x1DD9,
    0x1DDA, 0x1DDB, 0x1DDC, 0x1DDD, 0x1DDE, 0x1DDF, 0x1DE0, 0x1DE1,
    0x1DE2, 0x1DE3, 0x1DE4, 0x1DE5, 0x1DE6, 0x1DFE, 0x20D0, 0x20D1,
    0x20D4, 0x20D5, 0x20D6, 0x20D7, 0x20DB, 0x20DC, 0x20E1, 0x20E7,
    0x20E9, 0x20F0, 0x2CEF, 0x2CF0, 0x2CF1, 0x2DE0, 0x2DE1, 0x2DE2,
    0x2DE3, 0x2DE4, 0x2DE5, 0x2DE6, 0x2DE7, 0x2DE8, 0x2DE9, 0x2DEA,
    0x2DEB, 0x2DEC, 0x2DED, 0x2DEE, 0x2DEF, 0x2DF0, 0x2DF1, 0x2DF2,
    0x2DF3, 0x2DF4, 0x2DF5, 0x2DF6, 0x2DF7, 0x2DF8, 0x2DF9, 0x2DFA,
    0x2DFB, 0x2DFC, 0x2DFD, 0x2DFE, 0x2DFF, 0xA66F, 0xA67C, 0xA67D,
    0xA6F0, 0xA6F1, 0xA8E0, 0xA8E1, 0xA8E2, 0xA8E3, 0xA8E4, 0xA8E5,
    0xA8E6, 0xA8E7, 0xA8E8, 0xA8E9, 0xA8EA, 0xA8EB, 0xA8EC, 0xA8ED,
    0xA8EE, 0xA8EF, 0xA8F0, 0xA8F1, 0xAAB0, 0xAAB2, 0xAAB3, 0xAAB7,
    0xAAB8, 0xAABE, 0xAABF, 0xAAC1, 0xFE20, 0xFE21, 0xFE22, 0xFE23,
    0xFE24, 0xFE25, 0xFE26, 0x10A0F, 0x10A38, 0x1D185, 0x1D186, 0x1D187,
    0x1D188, 0x1D189, 0x1D1AA, 0x1D1AB, 0x1D1AC, 0x1D1AD, 0x1D242,
    0x1D243, 0x1D244,
]  # 297 entries


_id_start: Optional[int] = None
_id_counter = 0


def _create_id() -> int:
    """Unique-enough image id (ref kitty-canvas.cc:48-53)."""
    global _id_start, _id_counter
    if _id_start is None:
        _id_start = (int(time.time()) << 7) & 0xFFFFFFFF
    _id_counter += 1
    return (_id_start + _id_counter) & 0xFFFFFFFF


def _enable_tmux_passthrough() -> None:
    """ref kitty-canvas.cc:83-111.  The reference's system() returns a
    waitstatus, so a tmux exiting 1 gives 256 and its `case 1` branch
    never matches an exit code: in practice ANY failure lands in the
    default branch, which stays silent unless $TMUX is set (a host
    without tmux, or a dead inherited session, must not spam stderr)."""
    ret = subprocess.call(
        "tmux set -p allow-passthrough on > /dev/null 2>&1", shell=True)
    if ret != 0 and os.environ.get("TMUX"):
        print(f"Can't set passthrough, tmux set exit-code={ret}",
              file=sys.stderr)


def _placeholder_tiles(image_id: int, indent: int, rows: int,
                       cols: int) -> bytes:
    """Unicode-placeholder rendering for tmux (ref kitty-canvas.cc:58-74)."""
    out = bytearray(b"\r")
    msb = (image_id >> 24) & 0xFF
    for r in range(rows):
        if indent > 0:
            out += b"\033[%dC" % indent
        out += b"\033[38:2:%d:%d:%dm" % (
            (image_id >> 16) & 0xFF, (image_id >> 8) & 0xFF, image_id & 0xFF)
        for c in range(cols):
            # U+10EEEE, the kitty graphics-protocol placeholder char.
            # The reference's comment says U+10FFFF but its emitted
            # bytes "\xf4\x8e\xbb\xae" are U+10EEEE (ref
            # kitty-canvas.cc:69), matching the kitty spec.
            cell = "\U0010EEEE"
            if r < len(_ROWCOL):
                cell += chr(_ROWCOL[r])
            if c < len(_ROWCOL):
                cell += chr(_ROWCOL[c])
            if msb and msb < len(_ROWCOL):
                cell += chr(_ROWCOL[msb])
            out += cell.encode("utf-8")
        out += b"\033[39m\n\r"
    return bytes(out)


class KittyCanvas(TerminalCanvas):
    """ref src/kitty-canvas.{h,cc}."""

    def __init__(self, sequencer: BufferedWriteSequencer,
                 tmux_passthrough_needed: bool, options: DisplayOptions,
                 executor=None):
        super().__init__(sequencer)
        self._options = options
        self._tmux = tmux_passthrough_needed
        self._animation_id = 0
        self._flip_buffer = 0
        # Compression pool: encode runs async, future handed to the
        # sequencer (ref kitty-canvas.cc:178-235, timg.cc:321-336).
        self._executor = executor
        if tmux_passthrough_needed:
            _enable_tmux_passthrough()

    def cell_height_for_pixels(self, pixels: int) -> int:
        assert pixels <= 0
        return -((-pixels + self._options.cell_y_px - 1)
                 // self._options.cell_y_px)

    def _pick_id(self, seq_type: SeqType) -> int:
        """Id management (ref kitty-canvas.cc:143-172)."""
        if seq_type == SeqType.START_OF_ANIMATION:
            image_id = _create_id()
            _create_id()  # reserve flip-buffer id
            self._animation_id = image_id
            self._flip_buffer = 0
            return image_id
        if seq_type == SeqType.ANIMATION_FRAME:
            self._flip_buffer += 1
            return self._animation_id + (self._flip_buffer % 2)
        return _create_id()

    def send(self, x: int, dy: int, frame: np.ndarray, seq_type: SeqType,
             end_of_frame_ms: float = 0.0) -> None:
        opts = self._options
        if dy < 0:
            self.move_cursor_dy(self.cell_height_for_pixels(dy))
        self.move_cursor_dx(x // opts.cell_x_px)

        image_id = self._pick_id(seq_type)
        h, w = frame.shape[:2]
        cols = w // opts.cell_x_px
        rows = -self.cell_height_for_pixels(-h)
        indent = x // opts.cell_x_px
        wrap = self._tmux
        prefix = self.consume_prefix()

        def encode() -> bytes:
            png = encode_png(frame, opts.compress_pixel_level,
                             with_alpha=not opts.local_alpha_handling)
            return self._frame_payload(prefix, png, image_id, wrap,
                                       indent, rows, cols)

        if self._executor is not None:
            self._sequencer.write_buffer(self._executor.submit(encode),
                                         seq_type, end_of_frame_ms)
        else:
            self._sequencer.write_buffer(encode(), seq_type, end_of_frame_ms)

    def _frame_payload(self, prefix: bytes, png: bytes, image_id: int,
                       wrap: bool, indent: int, rows: int,
                       cols: int) -> bytes:
        out = bytearray(prefix)

        def esc(c: bytes) -> bytes:
            return (b"\033\033" if wrap else b"\033") + c

        if wrap:
            out += TMUX_START
        out += esc(b"_")
        out += b"Ga=T,i=%d,q=2,f=100,m=%d" % (image_id,
                                              1 if len(png) > _BYTE_CHUNK else 0)
        if wrap:
            out += b",U=1,c=%d,r=%d" % (cols, rows)
        out += b";"

        pos = 0
        while pos < len(png):
            chunk = png[pos:pos + _BYTE_CHUNK]
            pos += len(chunk)
            out += base64.b64encode(chunk)
            if pos < len(png):
                out += esc(b"\\")
                if wrap:
                    out += TMUX_END + TMUX_START
                out += esc(b"_")
                out += b"Gq=2,m=%d;" % (1 if len(png) - pos > _BYTE_CHUNK else 0)
        out += esc(b"\\")

        if wrap:
            out += TMUX_END
            out += _placeholder_tiles(image_id, indent, rows, cols)
        else:
            out += b"\n"
        return bytes(out)
