"""Cube-palette constants of the sixel dither (counterpart of the cube
part of timg_tpu/ops/sixel.py).

The 6x7x6 quantizer maps an f32 channel value v to
``q = rint(v * STEPS[c])`` and back to ``rint(q * INV_STEPS[c])``; the
palette index is ``(q_r * 7 + q_g) * 6 + q_b``.  The constants are the
f32 roundings of the reference's double quotients.
"""

from __future__ import annotations

import numpy as np

from timg_tpu.ops.sixel_np import _CUBE_LEVELS, cube_palette  # noqa: F401

STEPS = tuple(float(np.float32((n - 1) / 255.0)) for n in _CUBE_LEVELS)
INV_STEPS = tuple(float(np.float32(255.0 / (n - 1))) for n in _CUBE_LEVELS)
