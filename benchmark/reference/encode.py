"""Escape bytes: the ANSI stream of block cells, as timg
src/unicode-block-canvas.cc writes a whole frame (a copy of the
program's Python twin of its C emitter, with every cell written): per
cell row, 24-bit SGR colors with elision, ``ESC[0m`` and a newline.
"""

from __future__ import annotations

import numpy as np

_GLYPH_BYTES = [g.encode("utf-8") for g in
                (" ", "▘", "▝", "▖", "▗", "▌",
                 "▚", "▄", "▀")]
_END_OF_LINE = b"\033[0m\n"
_DEC = [b"%d;" % v for v in range(256)]


def ansi_blocks(glyph: np.ndarray, fg: np.ndarray, bg: np.ndarray) -> bytes:
    """One frame of block cells, every cell written -> its bytes."""
    out = bytearray()
    for grow, frow, brow in zip(glyph.tolist(), fg.tolist(), bg.tolist()):
        last_fg = None
        last_bg = None
        for g, f, b in zip(grow, frow, brow):
            color = False
            if g != 0 and f != last_fg:
                out += b"\033[38;2;" + _DEC[f[0]] + _DEC[f[1]] + _DEC[f[2]]
                color = True
                last_fg = f
            if b != last_bg:
                if not color:
                    out += b"\033["
                if b[3] < 0x60:
                    out += b"49;"
                else:
                    out += b"48;2;" + _DEC[b[0]] + _DEC[b[1]] + _DEC[b[2]]
                color = True
            if color:
                out[-1] = 0x6D                       # the last ';' -> 'm'
            out += _GLYPH_BYTES[g]
            last_bg = b
        out += _END_OF_LINE
    return bytes(out)
