"""Inter-frame cell diffing (counterpart of timg_tpu/ops/diff.py).

Behavioral spec: ref src/unicode-block-canvas.cc:129-152: a cell is
skipped when all its pixels equal the backing store of the previous
frame.  For a window the masks of consecutive frames are one reduction
(the mask of frame i against frame i-1).  This is the plain PyTorch
version; on CUDA the block kernel (csrc/block_cells.cu) computes the
same masks beside the glyphs (ops/blocks.py ``quarter_cells``,
``half_cells``).
"""

from __future__ import annotations

import torch


def window_cell_diff(padded: torch.Tensor, cell_w: int) -> torch.Tensor:
    """padded: [B, H, W, 4] uint8 (H even).  Returns eq [B-1, H/2,
    W/cell_w] bool: eq[i] compares frame i+1 against frame i per
    2 x cell_w cell."""
    b, h, w, _ = padded.shape
    cells = padded.reshape(b, h // 2, 2, w // cell_w, cell_w, 4)
    return (cells[1:] == cells[:-1]).all(dim=5).all(dim=4).all(dim=2)
