"""TerminalCanvas base: prefix coalescing and cursor/screen control.

Behavioral spec: ref src/terminal-canvas.{h,cc}. Cursor moves, titles and
screen clears are buffered as a *prefix* that is prepended to the next
frame write so they land in the same write() as the frame (ref
terminal-canvas.cc:53-64); CursorOn is flushed immediately as a
ControlWrite for Ctrl-C safety (ref :92-100).
"""

from __future__ import annotations

from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType

CURSOR_ON = b"\033[?25h"
CURSOR_OFF = b"\033[?25l"
SCREEN_CLEAR = b"\033c"


def cursor_up(rows: int) -> bytes:
    return b"\033[%dA" % rows


def cursor_down(rows: int) -> bytes:
    return b"\033[%dB" % rows


def cursor_right(cols: int) -> bytes:
    return b"\033[%dC" % cols


def cursor_left(cols: int) -> bytes:
    return b"\033[%dD" % cols


class TerminalCanvas:
    """Abstract canvas. Subclasses implement send() and
    cell_height_for_pixels()."""

    def __init__(self, sequencer: BufferedWriteSequencer):
        self._sequencer = sequencer
        self._prefix = bytearray()

    # -- prefix mechanism (ref terminal-canvas.cc:53-64) --
    def add_prefix_next_send(self, data: bytes) -> None:
        if data:
            self._prefix.extend(data)

    def consume_prefix(self) -> bytes:
        out = bytes(self._prefix)
        self._prefix.clear()
        return out

    def move_cursor_dy(self, rows: int) -> None:
        if rows == 0:
            return
        self.add_prefix_next_send(
            cursor_up(-rows) if rows < 0 else cursor_down(rows)
        )

    def move_cursor_dx(self, cols: int) -> None:
        if cols == 0:
            return
        self.add_prefix_next_send(
            cursor_left(-cols) if cols < 0 else cursor_right(cols)
        )

    def clear_screen(self) -> None:
        self.add_prefix_next_send(SCREEN_CLEAR)

    def cursor_off(self) -> None:
        self.add_prefix_next_send(CURSOR_OFF)

    def cursor_on(self) -> None:
        # Immediate ControlWrite (ref terminal-canvas.cc:92-100).
        self._sequencer.write_buffer(CURSOR_ON, SeqType.CONTROL_WRITE)

    def close(self) -> None:
        """Flush any leftover prefix (ref terminal-canvas.cc:45-52)."""
        if self._prefix:
            self._sequencer.write_buffer(self.consume_prefix(), SeqType.CONTROL_WRITE)

    # -- to implement --
    def cell_height_for_pixels(self, pixels: int) -> int:
        raise NotImplementedError

    def send(self, x: int, dy: int, frame, seq_type, end_of_frame_ms: float = 0.0):
        """Emit one framebuffer. ``x``: absolute pixel column; ``dy``:
        relative pixel rows (negative: re-position over previous frame)."""
        raise NotImplementedError
