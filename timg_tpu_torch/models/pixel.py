"""Pixel-direct protocol models of the port (counterpart of
timg_tpu/models/pixel.py): sixel, kitty and iTerm2.

A model holds an explicit ``torch.device`` (``cuda`` unless the caller
passes ``device=`` or sets TIMG_TPU_TORCH_DEVICE=cpu, ops/backend.py)
and runs its device pipeline there: the stb-exact resize and the alpha
compose (``render_batch``), or the 4:2:0 convert and the lean video
resize (``render_batch_yuv``), then the FS dither of the model's mode on
the frames' first three channels.  Median-cut trees are built on the
host (ops/sixel_np.py), the index planes come back as uint8, and the
sixel bytes are assembled on the host (render/sixel_render.py).  The
kitty and iTerm2 models fetch the resized and composed frames in one
copy and encode each as a PNG on the host (render/png.py), as the JAX
package does.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from timg_tpu_torch import tracing
from timg_tpu_torch.ops import staging
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
        self._staging = staging.Ring(self.device)

    def _to_device(self, a) -> torch.Tensor:
        return self._staging.to_device(a)

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
        with tracing.span("lib.batch", len(frames)):
            return self._render_resized(self._resized(frames))

    def render_batch_yuv(self, y, u, v,
                         full_range: bool = True) -> List[bytes]:
        """[B,H,W] y + [B,ceil(H/2),ceil(W/2)] u/v uint8 planes (e.g.
        straight from a video decoder) -> sixel streams.  Ships 2.67x
        fewer bytes to the device than RGBA input."""
        with tracing.span("lib.batch", len(y)):
            return self._render_resized(
                self._resized_yuv(y, u, v, full_range))

    def _render_resized(self, x: torch.Tensor) -> List[bytes]:
        """Resized [B, h, w, 4] frames on the device -> payloads: the
        dither of the model's mode (``lib.dither``, pixels), the index
        planes' fetch (``lib.fetch``, bytes) and the assembly of every
        payload (``lib.emit``, payloads) over the host's threads
        (``lib.assemble`` each, on its thread); a median-cut tree is
        built on the host (``lib.palette``), once a stream with
        ``adaptive_reuse``, else once a frame.  On a card ``lib.dither``
        times the kernel's launch alone: the host waits for the kernel
        in ``lib.fetch``, and the device trace holds its time."""
        from timg_tpu_torch.ops import sixel as sixel_op
        from timg_tpu_torch.render.sixel_render import encode_sixel_streams

        b, h, w = x.shape[:3]
        if self.dither == "cube":
            palette = sixel_op.cube_palette()
            with tracing.span("lib.dither", b * h * w):
                indices = sixel_op.fs_dither_cube(x, out_u8=True)
            planes = [(idx, palette) for idx in _fetch(indices)]
        elif self.adaptive_reuse:
            if self._quantizer is None:
                self._quantizer = _tree(x[0])
            palette, levels, leaves = self._quantizer
            with tracing.span("lib.dither", b * h * w):
                indices = sixel_op.fs_dither_tree(  # one launch
                    x, levels, leaves, out_u8=True)
            planes = [(idx, palette) for idx in _fetch(indices)]
        else:
            planes = []
            for i in range(b):
                palette, levels, leaves = _tree(x[i])
                with tracing.span("lib.dither", h * w):
                    idx = sixel_op.fs_dither_tree(x[i:i + 1], levels,
                                                  leaves, out_u8=True)
                planes.append((_fetch(idx)[0], palette))
        with tracing.span("lib.emit", len(planes)):
            return encode_sixel_streams(planes)


def _tree(frame: torch.Tensor):
    """The median-cut tree of one resized [h, w, 4] frame, built on the
    host from its first three channels: the ``lib.palette`` span (count:
    its pixels), the frame's copy to the host included."""
    from timg_tpu_torch.ops import sixel as sixel_op

    with tracing.span("lib.palette", frame.shape[0] * frame.shape[1]):
        return sixel_op.median_cut_tree(frame[..., :3].cpu().numpy())


def _fetch(indices: torch.Tensor):
    """[B, h, w] uint8 index planes -> numpy, where the host waits for
    the card's work: the ``lib.fetch`` span (count: bytes)."""
    with tracing.span("lib.fetch", indices.numel()):
        return indices.cpu().numpy()


class KittyModel(_PixelModel):
    def render_batch(self, frames) -> List[bytes]:
        """[B, H, W, 4] uint8 frames (numpy or a tensor) -> one kitty
        graphics payload per frame, image ids 1 .. B."""
        import base64

        from timg_tpu_torch.render.png import encode_png

        out = []
        for i, frame in enumerate(self._resized(frames).cpu().numpy()):
            png = encode_png(frame, self.compress_level, with_alpha=True)
            payload = bytearray(b"\033_Ga=T,i=%d,q=2,f=100,m=0;" % (i + 1))
            payload += base64.b64encode(png)
            payload += b"\033\\"
            out.append(bytes(payload))
        return out


class ITerm2Model(_PixelModel):
    def render_batch(self, frames) -> List[bytes]:
        """[B, H, W, 4] uint8 frames (numpy or a tensor) -> one iTerm2
        inline-image payload per frame."""
        import base64

        from timg_tpu_torch.render.png import encode_png

        out = []
        for frame in self._resized(frames).cpu().numpy():
            png = encode_png(frame, self.compress_level, with_alpha=True)
            h, w = frame.shape[:2]
            head = b"\033]1337;File=size=%d;width=%dpx;height=%dpx;inline=1:" \
                % (len(png), w, h)
            out.append(head + base64.b64encode(png) + b"\007")
        return out
