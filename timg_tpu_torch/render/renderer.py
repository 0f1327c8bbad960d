"""Single- and multi-column (grid / "contact sheet") layout.

Behavioral spec: ref src/renderer.cc. The multi-column renderer advances a
column per image source, moves the cursor up to the start of the row,
x-offsets by column * column_width, and equalizes row heights.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.render.canvas import TerminalCanvas
from timg_tpu_torch.render.sequencer import SeqType

# Callback signature: (x, dy, frame, seq_type, end_of_frame_ms)
WriteFramebufferFun = Callable[[int, int, object, SeqType, float], None]


def trim_title(title: str, requested_width: int, center: bool) -> str:
    """ref renderer.cc:29-42."""
    result = title
    if len(result) > requested_width:
        result = "..." + result[len(result) - requested_width + 3:]
    elif center:
        start_spaces = (requested_width - len(result)) // 2
        result = " " * start_spaces + result
    return result + "\n"


class Renderer:
    def __init__(self, canvas: TerminalCanvas, options: DisplayOptions):
        self._canvas = canvas
        self._options = options

    @staticmethod
    def create(
        canvas: TerminalCanvas,
        options: DisplayOptions,
        cols: int,
        rows: int,
        wait_between_images_ms: float = 0.0,
        wait_between_rows_ms: float = 0.0,
    ) -> "Renderer":
        """ref renderer.cc:197-209."""
        if cols > 1:
            return MultiColumnRenderer(
                canvas, options, cols, rows,
                wait_between_images_ms, wait_between_rows_ms)
        return SingleColumnRenderer(
            canvas, options, max(wait_between_images_ms, wait_between_rows_ms))

    def render_cb(self, title: str) -> WriteFramebufferFun:
        raise NotImplementedError

    def maybe_wait_between_image_sources(self) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        """Cursor cleanup at end of a grid row (ref renderer.cc:94-101)."""


class SingleColumnRenderer(Renderer):
    """ref renderer.cc:46-76."""

    def __init__(self, canvas, options, wait_time_ms: float):
        super().__init__(canvas, options)
        self._wait_time_ms = wait_time_ms

    def render_cb(self, title: str) -> WriteFramebufferFun:
        if self._options.show_title:
            tout = trim_title(
                title,
                self._options.width // self._options.cell_x_px,
                self._options.center_horizontally,
            )
            self._canvas.add_prefix_next_send(tout.encode("utf-8"))

        def write(x, dy, frame, seq_type, end_of_frame_ms=0.0):
            self._canvas.send(x, dy, frame, seq_type, end_of_frame_ms)

        return write

    def maybe_wait_between_image_sources(self) -> None:
        if self._wait_time_ms > 0:
            time.sleep(self._wait_time_ms / 1000.0)


class MultiColumnRenderer(Renderer):
    """ref renderer.cc:81-189."""

    def __init__(self, canvas, options, cols: int, rows: int,
                 wait_between_images_ms: float, wait_between_rows_ms: float):
        super().__init__(canvas, options)
        self._columns = cols
        self._column_width = options.width
        self._wait_images_ms = wait_between_images_ms
        self._wait_rows_ms = wait_between_rows_ms
        self._title: Optional[str] = None
        self._first_render_call = True
        self._current_column = -1
        self._highest_fb_column_height = 0
        self._last_fb_height = 0

    def _advance_column(self) -> bool:
        """ref renderer.cc:165-177. True when wrapping to a new row."""
        self._current_column += 1
        if self._current_column >= self._columns:
            down = self._highest_fb_column_height - self._last_fb_height
            if down > 0:
                self._canvas.move_cursor_dy(down)
            self._current_column = 0
            self._highest_fb_column_height = 0
            return True
        return False

    def render_cb(self, title: str) -> WriteFramebufferFun:
        self._advance_column()
        if self._options.show_title:
            self._title = trim_title(
                title,
                self._column_width // self._options.cell_x_px,
                self._options.center_horizontally,
            )
        self._first_render_call = True

        def write(x, dy, frame, seq_type, end_of_frame_ms=0.0):
            if self._first_render_call:
                y_offset = -self._last_fb_height if self._current_column > 0 else 0
            elif dy != 0:
                y_offset = dy  # animation jumping back
            else:
                y_offset = 0 if self._advance_column() else -self._last_fb_height

            x_offset = self._current_column * self._column_width
            if self._options.show_title and self._first_render_call:
                # Headline handling (ref renderer.cc:125-140).
                if y_offset:
                    y_move = self._canvas.cell_height_for_pixels(y_offset)
                    self._canvas.move_cursor_dy(y_move - 1)
                self._canvas.move_cursor_dx(x_offset // self._options.cell_x_px)
                if self._title:
                    self._canvas.add_prefix_next_send(self._title.encode("utf-8"))
                y_offset = 0

            self._canvas.send(x + x_offset, y_offset, frame, seq_type,
                              end_of_frame_ms)
            self._last_fb_height = frame.shape[0]
            if self._last_fb_height > self._highest_fb_column_height:
                self._highest_fb_column_height = self._last_fb_height
            self._first_render_call = False

        return write

    def maybe_wait_between_image_sources(self) -> None:
        if self._wait_images_ms > 0:
            time.sleep(self._wait_images_ms / 1000.0)
        if (self._current_column == self._columns - 1
                and self._wait_rows_ms > 0):
            time.sleep(self._wait_rows_ms / 1000.0)

    def finish(self) -> None:
        """ref renderer.cc:94-101 (~MultiColumnRenderer)."""
        if self._current_column != 0:
            down = self._highest_fb_column_height - self._last_fb_height
            if down > 0:
                self._canvas.move_cursor_dy(down // self._options.cell_y_px)
