"""Sixel dither entry points on [B, H, W, >=3] uint8 frames and the cube
palette constants (counterpart of timg_tpu/ops/sixel.py).

The 6x7x6 quantizer maps an f32 channel value v to
``q = rint(v * STEPS[c])`` and back to ``rint(q * INV_STEPS[c])``; the
palette index is ``(q_r * 7 + q_g) * 6 + q_b``.  The constants are the
f32 roundings of the reference's double quotients.

``fs_dither_cube`` and ``fs_dither_tree`` take the frames' first three
channels as the reference's do (it slices ``[..., :3]``; here the
kernels read them in place).  On the card they launch the byte entries
of csrc/fs_dither_cube.cu (K9's port, and the tree quantizer on the same
input); on the CPU they run the plain versions.  The median-cut tree is
built on the host (ops/sixel_np.py).
"""

from __future__ import annotations

import numpy as np
import torch

from timg_tpu_torch.ops.sixel_np import (_CUBE_LEVELS, cube_palette,  # noqa: F401
                                         median_cut_tree)

STEPS = tuple(float(np.float32((n - 1) / 255.0)) for n in _CUBE_LEVELS)
INV_STEPS = tuple(float(np.float32(255.0 / (n - 1))) for n in _CUBE_LEVELS)


def fs_dither_cube(frames_rgb: torch.Tensor,
                   out_u8: bool = False) -> torch.Tensor:
    """[B, H, W, >=3] uint8 -> [B, H, W] cube-palette FS indices (int32,
    or uint8 with ``out_u8``), on the frames' device."""
    from timg_tpu_torch.ops.sixel_kernel import fs_dither_cube_rgb

    _, h, w = frames_rgb.shape[:3]
    return fs_dither_cube_rgb(frames_rgb, h, w, out_u8)


def fs_dither_tree(frames_rgb: torch.Tensor, levels, leaves,
                   out_u8: bool = False) -> torch.Tensor:
    """[B, H, W, >=3] uint8 + median_cut_tree tables (numpy or tensors)
    -> [B, H, W] indices (int32, or uint8 with ``out_u8``)."""
    from timg_tpu_torch.ops.sixel_kernel import fs_dither_tree_rgb

    _, h, w = frames_rgb.shape[:3]
    return fs_dither_tree_rgb(frames_rgb, torch.as_tensor(levels),
                              torch.as_tensor(leaves), h, w, out_u8)
