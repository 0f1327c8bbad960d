"""iTerm2 inline-image canvas (OSC 1337) of the port: its own copy of
timg_tpu/render/iterm2.py, the imports rewritten.

Behavioral spec: ref src/iterm2-canvas.cc:42-96.
"""

from __future__ import annotations

import base64

import numpy as np

from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.render.canvas import TerminalCanvas
from timg_tpu_torch.render.png import encode_png
from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType


class ITerm2Canvas(TerminalCanvas):
    def __init__(self, sequencer: BufferedWriteSequencer,
                 options: DisplayOptions, executor=None):
        super().__init__(sequencer)
        self._options = options
        # async encode pattern (ref iterm2-canvas.cc:55-77)
        self._executor = executor

    def cell_height_for_pixels(self, pixels: int) -> int:
        """ref iterm2-canvas.cc:92-96."""
        assert pixels <= 0
        return -((-pixels + self._options.cell_y_px - 1)
                 // self._options.cell_y_px)

    def send(self, x: int, dy: int, frame: np.ndarray, seq_type: SeqType,
             end_of_frame_ms: float = 0.0) -> None:
        opts = self._options
        if dy < 0:
            self.move_cursor_dy(self.cell_height_for_pixels(dy))
        self.move_cursor_dx(x // opts.cell_x_px)

        h, w = frame.shape[:2]
        prefix = self.consume_prefix()

        def encode() -> bytes:
            png = encode_png(frame, opts.compress_pixel_level,
                             with_alpha=not opts.local_alpha_handling)
            out = bytearray(prefix)
            out += b"\033]1337;File=size=%d;width=%dpx;height=%dpx;" \
                b"inline=1:" % (len(png), w, h)
            out += base64.b64encode(png)
            out += b"\007\n"
            return bytes(out)

        if self._executor is not None:
            self._sequencer.write_buffer(self._executor.submit(encode),
                                         seq_type, end_of_frame_ms)
        else:
            self._sequencer.write_buffer(encode(), seq_type, end_of_frame_ms)
