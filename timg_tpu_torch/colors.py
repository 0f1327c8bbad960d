"""Color parsing and terminal color-cube mapping.

Behavioral spec: ref src/framebuffer.h:26-60 (rgba_t, As256TermColor) and
src/framebuffer.cc:27-50 (ParseColor with the HTML/X11 name table from
src/html-colors.inc). The standard CSS3/X11 name table is vendored in
_css3_colors.py (a PIL module-level import here would put ~150 ms of
PIL on the one-shot CLI's cold-start path).
"""

from __future__ import annotations

import re
import sys

from timg_tpu_torch._css3_colors import CSS3_COLORS as _css3_names
from timg_tpu_torch.options import RGBA, TRANSPARENT

# sscanf("#%02x%02x%02x") semantics: exactly-2-digit fields, trailing
# characters ignored.
_HEX_RE = re.compile(r"^#([0-9a-fA-F]{2})([0-9a-fA-F]{2})([0-9a-fA-F]{2})")
_RGB_RE = re.compile(r"^rgb\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)$")
_RGBX_RE = re.compile(
    r"^rgb\(\s*0x([0-9a-fA-F]+)\s*,\s*0x([0-9a-fA-F]+)\s*,\s*0x([0-9a-fA-F]+)\s*\)$"
)


def parse_color(color: str | None) -> RGBA:
    """Parse '#rrggbb', 'rgb(r, g, b)', 'rgb(0x.., ..)' or an HTML name.

    Returns alpha=255 on success, all-transparent (0,0,0,0) if undecodable
    (ref framebuffer.cc:27-50). 'none' is an allowed non-color.
    """
    if not color:
        return TRANSPARENT
    lowered = color.lower()
    named = _css3_names.get(lowered)
    if named:
        color = named

    m = _HEX_RE.match(color)
    if m:
        r, g, b = (int(m.group(i), 16) for i in (1, 2, 3))
        return (min(r, 255), min(g, 255), min(b, 255), 0xFF)
    m = _RGB_RE.match(color)
    if m:
        r, g, b = (int(m.group(i)) for i in (1, 2, 3))
        return (min(r, 255), min(g, 255), min(b, 255), 0xFF)
    m = _RGBX_RE.match(color)
    if m:
        r, g, b = (int(m.group(i), 16) for i in (1, 2, 3))
        return (min(r, 255), min(g, 255), min(b, 255), 0xFF)

    if lowered != "none":
        print(f"Couldn't parse color '{color}'", file=sys.stderr)
    return TRANSPARENT


def as_256_term_color(r: int, g: int, b: int) -> int:
    """Map RGB to the xterm 256-color id: gray ramp or 6x6x6 cube.

    ref framebuffer.h:37-52; cut-offs are midpoints between cube levels
    {0x00, 0x5f, 0x87, 0xaf, 0xd7, 0xff}.
    """
    if r == g == b:
        return 232 + (r * 23 // 255)

    def v2cube(v: int) -> int:
        if v < 0x5F // 2:
            return 0
        if v < (0x5F + 0x87) // 2:
            return 1
        if v < (0x87 + 0xAF) // 2:
            return 2
        if v < (0xAF + 0xD7) // 2:
            return 3
        if v < (0xD7 + 0xFF) // 2:
            return 4
        return 5

    return 16 + 36 * v2cube(r) + 6 * v2cube(g) + v2cube(b)
