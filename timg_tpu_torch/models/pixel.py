"""Pixel-direct protocol models of the port (counterpart of
timg_tpu/models/pixel.py): the sixel model so far.

A model holds an explicit ``torch.device`` (``cuda`` unless the caller
passes ``device=`` or sets TIMG_TPU_TORCH_DEVICE=cpu, ops/backend.py)
and runs its device pipeline there: the stb-exact resize and the alpha
compose (``render_batch``), or the 4:2:0 convert and the lean video
resize (``render_batch_yuv``), then the FS dither of the model's mode on
the frames' first three channels.  Median-cut trees are built on the
host (ops/sixel_np.py), the index planes come back as uint8, and the
sixel bytes are assembled on the host (render/sixel_render.py).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from timg_tpu_torch.options import RGBA


class _PixelModel:
    def __init__(self, out_h: int, out_w: int,
                 bg_color: Optional[RGBA] = (0, 0, 0, 255),
                 compress_level: int = 1, device=None):
        from timg_tpu_torch.ops import backend

        self.out_h, self.out_w = out_h, out_w
        self.bg_color = bg_color
        self.compress_level = compress_level
        self.device = (torch.device(device) if device is not None
                       else backend.device())

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _resized(self, frames) -> torch.Tensor:
        """[B, H, W, 4] uint8 -> [B, out_h, out_w, 4] uint8 on the
        device: stb-exact resize, then compose against the background."""
        from timg_tpu_torch.ops.pipeline import resize_compose

        return resize_compose(self._to_device(frames), self.out_h,
                              self.out_w, self.bg_color or (0, 0, 0, 0),
                              (0, 0, 0, 0))

    def _resized_yuv(self, y, u, v, full_range: bool) -> torch.Tensor:
        """Raw 4:2:0 planes -> resized RGBA frames on the device (the
        video-rate transport: 1.5 B/px host->device).  Opaque by
        construction, so no compose."""
        from timg_tpu_torch.ops.resize import resize_video_words
        from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words

        words = yuv420_to_rgba_words(self._to_device(y), self._to_device(u),
                                     self._to_device(v), bool(full_range))
        words = resize_video_words(words, self.out_h, self.out_w)
        b = words.shape[0]
        return words.contiguous().view(torch.uint8).reshape(
            b, self.out_h, self.out_w, 4)


class SixelModel(_PixelModel):
    def __init__(self, *args, dither: str = "adaptive",
                 adaptive_reuse: bool = False, **kw):
        """``adaptive_reuse``: build the median-cut palette once from
        the first frame seen and reuse it across frames and batches --
        the CLI video path's semantics (palette per animation, not per
        frame)."""
        super().__init__(*args, **kw)
        self.dither = dither  # "adaptive" | "cube"
        self.adaptive_reuse = adaptive_reuse
        self._quantizer = None

    def reset_palette(self) -> None:
        """Drop the reused adaptive palette (e.g. at a scene cut or a
        new animation start, like the CLI does)."""
        self._quantizer = None

    def render_batch(self, frames) -> List[bytes]:
        """[B, H, W, 4] uint8 frames (numpy or a tensor) -> one sixel
        payload per frame."""
        return self._render_resized(self._resized(frames))

    def render_batch_yuv(self, y, u, v,
                         full_range: bool = True) -> List[bytes]:
        """[B,H,W] y + [B,ceil(H/2),ceil(W/2)] u/v uint8 planes (e.g.
        straight from a video decoder) -> sixel streams.  Ships 2.67x
        fewer bytes to the device than RGBA input."""
        return self._render_resized(self._resized_yuv(y, u, v, full_range))

    def _render_resized(self, x: torch.Tensor) -> List[bytes]:
        from timg_tpu_torch.ops import sixel as sixel_op
        from timg_tpu_torch.render.sixel_render import encode_sixel_stream

        if self.dither == "cube":
            palette = sixel_op.cube_palette()
            indices = sixel_op.fs_dither_cube(x, out_u8=True).cpu().numpy()
            return [encode_sixel_stream(idx, palette) for idx in indices]
        if self.adaptive_reuse:
            if self._quantizer is None:
                self._quantizer = sixel_op.median_cut_tree(
                    x[0, ..., :3].cpu().numpy())
            palette, levels, leaves = self._quantizer
            indices = sixel_op.fs_dither_tree(
                x, levels, leaves, out_u8=True).cpu().numpy()  # one launch
            return [encode_sixel_stream(idx, palette) for idx in indices]
        host = x[..., :3].cpu().numpy()
        out = []
        for i, frame in enumerate(host):
            palette, levels, leaves = sixel_op.median_cut_tree(frame)
            idx = sixel_op.fs_dither_tree(x[i:i + 1], levels, leaves,
                                          out_u8=True)[0].cpu().numpy()
            out.append(encode_sixel_stream(idx, palette))
        return out
