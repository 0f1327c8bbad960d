"""Linear-space alpha composition and checkerboard fill in torch ops
(counterpart of timg_tpu/ops/compose.py).

Behavioral spec: ref src/framebuffer.cc:108-150 (AlphaComposeBackground) and
src/framebuffer.h:138-174 (LinearColor). The reference approximates gamma 2.2
with x^2: linearize c -> c*c (float), blend
``(c*a + bg*(255-a)) / 255``, repack with sqrtf truncated to uint8.

The JAX package emulates a correctly rounded ``/`` and ``sqrt``
(ops/exact.py) because the TPU's are approximate; torch's ``/`` and
``sqrt`` round correctly on the CPU and on CUDA, so they are used as
they are.  Every product and sum is its own op, in the reference's
association ``src_lin * a + bg * (255 - a)``, then ``/ 255``, so no
step can be contracted into an FMA.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _f32(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def alpha_compose_background(
    frames: torch.Tensor,            # [B, H, W, 4] uint8
    bg_color: Sequence[int],         # 4 ints (alpha==0 -> no-op)
    pattern_color: Sequence[int],    # 4 ints (alpha==0 -> solid bg only)
    pattern_w: int = 1,
    pattern_h: int = 1,
    start_row: int = 0,
) -> torch.Tensor:
    """Blend transparent pixels against bg (or bg/pattern checkerboard).

    ref framebuffer.cc:108-150. Pixels with a == 255 are untouched; pattern
    cell selection is ``((x // pw) + (y // ph)) % 2``.
    """
    _, h, w, _ = frames.shape
    dev = frames.device
    bg = [int(c) for c in bg_color]
    pat = [int(c) for c in pattern_color]
    if bg[3] == 0:                   # ref :121: nothing to blend against
        return frames
    use_pattern = (pat[3] != 0 and pat != bg and pattern_w > 0
                   and pattern_h > 0)

    def lin(c):
        f = torch.tensor(c[:3], dtype=torch.float32, device=dev)
        return f * f

    chosen_bg = lin(bg).expand(h, w, 3)
    if use_pattern:
        ys = torch.arange(h, device=dev).view(h, 1)
        xs = torch.arange(w, device=dev).view(1, w)
        checker = ((xs // pattern_w) + (ys // pattern_h)) % 2   # [H, W]
        chosen_bg = torch.where((checker == 1)[..., None], lin(pat),
                                chosen_bg)

    a = frames[..., 3:4].to(torch.float32)
    src = frames[..., :3].to(torch.float32)
    src_lin = src * src
    inv = _f32(255.0, dev) - a
    blended = (src_lin * a + chosen_bg[None] * inv) / _f32(255.0, dev)
    blended_u8 = torch.clamp(torch.sqrt(blended), max=255.0).to(torch.uint8)

    do_blend = frames[..., 3:4] != 255
    if start_row > 0:                # start_row optimization hook
        rows = torch.arange(h, device=dev).view(1, h, 1, 1)
        do_blend = do_blend & (rows >= start_row)
    rgb = torch.where(do_blend, blended_u8, frames[..., :3])
    alpha = torch.where(do_blend[..., 0], torch.full_like(frames[..., 3], 255),
                        frames[..., 3])
    return torch.cat([rgb, alpha[..., None]], dim=-1)
