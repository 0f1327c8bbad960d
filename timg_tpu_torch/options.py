"""Session configuration structs.

Behavioral contract follows the reference's two plain config structs:
``DisplayOptions`` (per-image processing; ref: src/display-options.h:34-105)
and ``PresentationOptions`` (session arrangement; ref: src/timg.cc:127-146).
Config flows as plain data; no registry, no config files.

Plain classes (not dataclasses): this module sits on the one-shot CLI's
cold-import path and dataclasses pulls ~17 ms of inspect machinery; the
reference's equivalents are plain C structs too.
"""

from __future__ import annotations

import enum
import os

# Sentinel for a not-initialized command-line value
# (ref: src/display-options.h:30).
NOT_INITIALIZED = -(2**31)

# RGBA: tuple of r, g, b, a in 0..255; a: 0=transparent.
RGBA = tuple
TRANSPARENT = (0, 0, 0, 0)


class Pixelation(enum.Enum):
    """Output protocol choice (ref: src/timg.cc:108-117)."""

    NOT_CHOSEN = "not-chosen"
    HALF_BLOCK = "half"
    QUARTER_BLOCK = "quarter"
    KITTY = "kitty"
    ITERM2 = "iterm2"
    SIXEL = "sixel"


class ClearScreen(enum.Enum):
    """When to clear the draw area (ref: src/timg.cc:119-123)."""

    NOT = 0
    BEFORE_FIRST_IMAGE = 1
    BEFORE_EACH_IMAGE = 2


def is_pixel_direct(p: Pixelation) -> bool:
    """Protocols that transfer high-res pixels (ref: src/timg.cc:465-472)."""
    return p in (Pixelation.KITTY, Pixelation.ITERM2, Pixelation.SIXEL)


def is_pixel_direct_with_alpha(p: Pixelation) -> bool:
    """Protocols with terminal-side alpha blending (ref: src/timg.cc:461-464)."""
    return p in (Pixelation.KITTY, Pixelation.ITERM2)


class SixelOptions:
    """Per-terminal sixel quirks (ref: src/term-query.h:46-49)."""

    def __init__(self) -> None:
        self.known_broken_cursor_placement = False
        self.full_cell_jump = False


class DisplayOptions:
    """Options influencing per-image processing.

    Field-for-field behavioral parity with ref src/display-options.h:34-105.
    ``bgcolor_getter`` is a callable for asynchronous background queries.
    """

    def __init__(self, **overrides) -> None:
        self.width = -1   # Output size in *pixels* (not cells).
        self.height = -1

        self.cell_x_px = 1  # Pixels shown in one character cell.
        self.cell_y_px = 2

        self.compress_pixel_level = 1  # PNG deflate level, kitty/iterm2.

        self.width_stretch = 1.0  # Font aspect-ratio correction.

        self.upscale = False
        self.upscale_integer = False
        self.fill_width = False
        self.fill_height = False
        self.antialias = True
        self.center_horizontally = False
        self.crop_border = 0
        self.auto_crop = False
        self.exif_rotate = True
        self.show_title = False

        # Title format: %f filename, %b basename, %w width, %h height,
        # %D decoder. Env-var default (ref: display-options.h:35-38).
        self.title_format = os.environ.get("TIMG_DEFAULT_TITLE") or "%f"

        # Scrolling
        self.scroll_animation = False
        self.scroll_dx = 1
        self.scroll_dy = 0
        self.scroll_delay_ms = 50.0

        self.allow_frame_skipping = False

        # Background for transparency. Returns solid color to blend, or
        # alpha=0 to indicate no blending (ref: display-options.h:84-97).
        self.local_alpha_handling = True
        self.bgcolor_getter = None
        self.bg_pattern_color = TRANSPARENT
        self.pattern_size = 1

        # Session renders sixel ("cube" | "adaptive"): sources prime
        # batched dither planes for animation/video windows (timg-tpu
        # extension; None for non-sixel sessions).
        self.sixel_batch_dither = None

        # Cross-image grid batching (sources/batch.py): set by the CLI
        # for contact-sheet sessions; still sources register their
        # device work here and same-geometry cells share one dispatch.
        self.batch_collector = None

        # Video resampling: "auto" = device pipeline; "sws" = host
        # swscale SWS_BILINEAR at display size (reference video-leg
        # parity, ref video-source.cc:352-354).
        self.resample = "auto"

        for key, value in overrides.items():  # dataclass-style kwargs
            if not hasattr(self, key):
                raise TypeError(f"DisplayOptions.__init__() got an "
                                f"unexpected keyword argument '{key}'")
            setattr(self, key, value)


class PresentationOptions:
    """Options configuring how images/videos are arranged and presented
    (ref: src/timg.cc:127-146)."""

    def __init__(self) -> None:
        self.pixelation = Pixelation.NOT_CHOSEN
        self.sixel_options = SixelOptions()
        # timg-tpu extension: libsixel (ref-exact, default) | adaptive
        # | cube
        self.sixel_dither = "libsixel"
        self.tmux_workaround = False
        self.terminal_use_upper_block = False
        self.use_256_color = False

        self.grid_cols = 1
        self.grid_rows = 1

        self.duration_per_image_ms = float("inf")
        self.loops = NOT_INITIALIZED
        self.hide_cursor = True
        self.clear_screen = ClearScreen.NOT
        self.duration_between_images_ms = 0.0
        self.duration_for_row_ms = 0.0
