"""What one payload of the library cell has to be.

The entries a traffic mix names under ``reference`` take ``inputs``,
which holds the cell's ``config`` and ``traffic`` (as loaded) and
``frame(key)``: the decoded input of answer ``key`` (an [H, W, 4] RGBA
frame of a library payload), made by the benchmark from the seed and
handed to the program alike.
"""

from __future__ import annotations

import numpy as np

from reference import cells, encode, pixels
from reference.precision import F32, Precision


def library_quarter(inputs, key: int, prec: Precision = F32) -> bytes:
    cfg = inputs.config
    return library_quarter_payload(inputs.frame(key), int(cfg["out_h"]),
                                   int(cfg["out_w"]), tuple(cfg["bg_color"]),
                                   prec)


def library_quarter_payload(frame: np.ndarray, out_h: int, out_w: int,
                            bg: tuple, prec: Precision = F32) -> bytes:
    """One payload of the quarter block model: the stb resize, the
    compose over ``bg`` (skipped when ``bg`` is transparent), the cells,
    all cells written."""
    x = pixels.stb_resize(frame, out_h, out_w, prec)
    if bg is not None and bg[3] != 0:
        x = pixels.compose_background(x, bg, prec)
    return encode.ansi_blocks(*cells.quarter_cells(x, prec))
