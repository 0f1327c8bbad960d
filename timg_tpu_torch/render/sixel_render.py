"""Sixel canvas of the port (counterpart of
timg_tpu/render/sixel_render.py:SixelCanvas).

Everything but ``send`` is inherited: cursor placement, band rounding,
the compression pool and the C sixel assembler (timg_tpu's native
helper, with its pure-Python twin when the helper is not built).
``send`` pops the port's SIXEL_PLANES, which the video window primed on
the device in ``cube``, ``libsixel`` or ``adaptive`` mode.  Every frame
of the ported slices comes from such a window; frames from elsewhere
(stills, animations) are not yet ported.
"""

from __future__ import annotations

from timg_tpu_torch.ops.sixel import cube_palette
from timg_tpu.render import sixel_render as _ref
from timg_tpu.render.sequencer import SeqType
from timg_tpu_torch.render.plane_cache import SIXEL_PLANES, not_ported


class SixelCanvas(_ref.SixelCanvas):

    def send(self, x: int, dy: int, frame, seq_type: SeqType,
             end_of_frame_ms: float = 0.0) -> None:
        if self._dither not in ("cube", "libsixel", "adaptive"):
            raise not_ported(f"--dither={self._dither}")
        if dy < 0:
            self.move_cursor_dy(self.cell_height_for_pixels(dy))
        self.move_cursor_dx(x // self._options.cell_x_px)

        primed = SIXEL_PLANES.pop(frame)
        if primed is None:
            raise not_ported("a sixel frame outside a primed video window")
        indices, palette, quantizer = primed
        if palette is None:
            palette = cube_palette()
        else:
            # the JAX canvas keeps the window's tree (adaptive) or None
            self._quantizer = quantizer
        self._enqueue(indices, palette, seq_type, end_of_frame_ms)
