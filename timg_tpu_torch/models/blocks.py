"""Unicode block protocol models, half and quarter (counterpart of
timg_tpu/models/blocks.py).

A model runs the block pipeline on its ``torch.device`` (``cuda`` unless
the caller passes ``device=`` or sets TIMG_TPU_TORCH_DEVICE=cpu): the
stb-exact resize, the alpha compose against an opaque background, then
the block cells (the CUDA kernel on the card, ops/blocks.py); the planes
come back to the host, where the ANSI bytes are written
(render/ansi.py: the C emitter, or its Python twin).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from timg_tpu_torch.options import RGBA


class _BlockModel:
    use_quarter = True

    def __init__(self, out_h: int, out_w: int,
                 bg_color: Optional[RGBA] = (0, 0, 0, 255),
                 use_upper_half_block: bool = False,
                 use_256_color: bool = False, device=None):
        from timg_tpu_torch.ops import backend

        if out_h % 2:
            out_h += 1  # block cells are 2 pixels tall
        if self.use_quarter and out_w % 2:
            out_w += 1
        self.out_h, self.out_w = out_h, out_w
        self.bg_color = bg_color
        self.use_upper_half_block = use_upper_half_block
        self.use_256_color = use_256_color
        self.device = (torch.device(device) if device is not None
                       else backend.device())

    def process_batch(self, frames
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[B, H, W, 4] uint8 frames (numpy or a tensor) -> (glyph, fg,
        bg) numpy planes, computed on the model's device."""
        from timg_tpu_torch.ops import pipeline

        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        fn = (pipeline.quarter_pipeline if self.use_quarter
              else pipeline.half_pipeline)
        glyph, fg, bg = fn(frames.to(self.device), self.out_h, self.out_w,
                           bg_color=self.bg_color,
                           use_upper_half_block=self.use_upper_half_block)
        return glyph.cpu().numpy(), fg.cpu().numpy(), bg.cpu().numpy()

    def render_batch(self, frames) -> List[bytes]:
        """[B, H, W, 4] -> per-frame ANSI escape payloads (no cursor
        moves)."""
        from timg_tpu_torch.render.ansi import (UnicodeBlockCanvas,
                                                _emit_frame_native,
                                                _native_lib)

        glyph, fg, bg = self.process_batch(frames)
        native = _native_lib()
        out = []
        for i in range(len(glyph)):
            if native is not None:
                out.append(_emit_frame_native(
                    native, glyph[i], fg[i], bg[i], None, 0,
                    self.use_256_color))
            else:
                canvas = UnicodeBlockCanvas.__new__(UnicodeBlockCanvas)
                canvas.use_256_color = self.use_256_color
                out.append(canvas._emit_frame_py(
                    glyph[i], fg[i], bg[i], None, 0))
        return out


class QuarterBlockModel(_BlockModel):
    use_quarter = True


class HalfBlockModel(_BlockModel):
    use_quarter = False
