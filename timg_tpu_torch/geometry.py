"""Scale-to-fit geometry math.

Pure-host function determining output dimensions. Must be *exact* — it
decides the output geometry for every frame, so any deviation breaks
byte-parity with the reference viewer. Behavioral spec:
ref src/image-source.cc:47-153 (CalcScaleToFitDisplay).

All float math intentionally mirrors the reference's single-precision C
``float`` arithmetic via numpy.float32 so rounding decisions agree.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from timg_tpu_torch.options import DisplayOptions

_MAX_STRETCH = 5.0  # kMaxAcceptFactor, ref image-source.cc:60


def _f32(x) -> np.float32:
    return np.float32(x)


def calc_scale_to_fit(
    img_width: int,
    img_height: int,
    options: DisplayOptions,
    fit_in_rotated: bool = False,
) -> Tuple[int, int, bool]:
    """Return (target_width, target_height, needs_scaling).

    ref image-source.cc:47-153. The width/height in `options` are in pixels
    of the chosen canvas; cell_x_px==2 flags quarter-block width doubling.
    """
    width = options.width
    height = options.height
    fill_width = options.fill_width
    fill_height = options.fill_height
    width_stretch = _f32(options.width_stretch)

    if fit_in_rotated:  # ref :52-56
        width, height = height, width
        fill_width, fill_height = fill_height, fill_width
        width_stretch = _f32(1.0) / _f32(options.width_stretch)

    # Clamp stretch (ref :58-63)
    if width_stretch > _MAX_STRETCH:
        width_stretch = _f32(_MAX_STRETCH)
    if width_stretch < 1.0 / _MAX_STRETCH:
        width_stretch = _f32(1.0 / _MAX_STRETCH)

    # Pretend to have less space in the stretched direction (ref :65-70).
    # These are C int ops: float multiply, truncate toward zero on store.
    if width_stretch > 1.0:
        width = int(_f32(width) / width_stretch)
    else:
        height = int(_f32(height) * width_stretch)

    width_fraction = _f32(width) / _f32(img_width)
    height_fraction = _f32(height) / _f32(img_height)

    # Image smaller than screen and no upscale requested (ref :74-86).
    if (
        not options.upscale
        and (fill_height or width_fraction > 1.0)
        and (fill_width or height_fraction > 1.0)
    ):
        target_width = img_width
        target_height = img_height
        if options.cell_x_px == 2:
            # Quarter block: double width for the 2x1 aspect (ref :79-84).
            return target_width * 2, target_height, True
        return target_width, target_height, False

    target_width = width
    target_height = height

    if fill_width and fill_height:  # ref :91-100
        larger = max(width_fraction, height_fraction)
        target_width = int(_roundf(larger * _f32(img_width)))
        target_height = int(_roundf(larger * _f32(img_height)))
    elif fill_height:  # ref :101-106
        target_width = int(_roundf(height_fraction * _f32(img_width)))
    elif fill_width:  # ref :107-110
        target_height = int(_roundf(width_fraction * _f32(img_height)))
    else:  # ref :111-118
        smaller = min(width_fraction, height_fraction)
        target_width = int(_roundf(smaller * _f32(img_width)))
        target_height = int(_roundf(smaller * _f32(img_height)))

    # Undo the stretch pretend-space (ref :120-125). C semantics:
    # `*target_width *= width_stretch` is int = int * float -> truncation.
    if width_stretch > 1.0:
        target_width = int(_f32(target_width) * width_stretch)
    else:
        target_height = int(_f32(target_height) / width_stretch)

    # Floor to full character cells in block modes (ref :127-133).
    if 0 < options.cell_x_px <= 2 and 0 < options.cell_y_px <= 2:
        target_width = target_width // options.cell_x_px * options.cell_x_px
        target_height = target_height // options.cell_y_px * options.cell_y_px

    if target_width <= 0:
        target_width = 1
    if target_height <= 0:
        target_height = 1

    # Integer-step upscale -U i (ref :139-150).
    if (
        options.upscale_integer
        and target_width > img_width
        and target_height > img_height
    ):
        aspect_correct = _f32(2.0 if options.cell_x_px == 2 else 1.0)
        wf = _f32(1.0) * _f32(target_width) / aspect_correct / _f32(img_width)
        hf = _f32(1.0) * _f32(target_height) / _f32(img_height)
        smaller_factor = wf if wf < hf else hf
        if smaller_factor > 1.0:
            target_width = int(
                aspect_correct * _f32(math.floor(smaller_factor)) * _f32(img_width)
            )
            target_height = int(_f32(math.floor(smaller_factor)) * _f32(img_height))

    needs_scale = target_width != img_width or target_height != img_height
    return target_width, target_height, needs_scale


def _roundf(x: np.float32) -> float:
    """C roundf(): round half away from zero (not banker's rounding)."""
    return math.floor(float(x) + 0.5) if x >= 0 else math.ceil(float(x) - 0.5)
