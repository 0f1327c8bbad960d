"""Terminal introspection: size, cell geometry, protocol & color queries.

Behavioral spec: ref src/term-query.{h,cc}. Queries find a real tty among
stdout/stderr/stdin (ref term-query.cc:84-91), use TIOCGWINSZ including
the xpixel/ypixel plausibility check with an escape-query fallback
(ref :369-406), and detect the supported graphics protocol from
TERM/TERM_PROGRAM hints plus a ``CSI >q`` device-attributes round trip
(ref :226-345). Every query has a time budget.
"""

from __future__ import annotations

import os
import re
import select
import termios
import tty
from typing import Optional

from timg_tpu_torch.options import SixelOptions
from timg_tpu_torch.utils import get_int_env

_verbose_log = False


def enable_query_logging(on: bool) -> None:
    global _verbose_log
    _verbose_log = on


class TermSizeResult:
    """ref term-query.h / term-query.cc:369-406.

    The font defaults are the reference's exact trick (term-query.h:
    29-30): negative when unavailable, but -2/-1 keeps the 1:2 cell
    ratio so the width-stretch formula 0.5*h/w still yields 1.0.

    (Plain class, not a dataclass: this module sits on the one-shot
    CLI's cold-import path and dataclasses pulls ~17 ms of inspect.)"""

    def __init__(self) -> None:
        self.cols = -1
        self.rows = -1
        self.font_width_px = -1
        self.font_height_px = -2

    def __repr__(self) -> str:  # diagnostics in --verbose logs
        return (f"TermSizeResult(cols={self.cols}, rows={self.rows}, "
                f"font_width_px={self.font_width_px}, "
                f"font_height_px={self.font_height_px})")


class GraphicsInfo:
    """ref term-query.h:40-52."""

    def __init__(self) -> None:
        self.preferred_graphics = "none"  # none|kitty|iterm2|sixel
        self.in_tmux = False
        self.sixel = SixelOptions()


def _find_tty_fd() -> Optional[int]:
    """First of stdout/stderr/stdin that is a tty (ref :84-91).

    Checks the raw descriptors 1/2/0 like the reference (the python
    stream objects may be captured pseudofiles, e.g. under pytest)."""
    for fd in (1, 2, 0):
        try:
            if os.isatty(fd):
                return fd
        except Exception:
            continue
    return None


def query_terminal(query: bytes, timeout_s: float,
                   response_found=None) -> bytes:
    """Raw-mode escape-sequence round trip with deadline
    (ref term-query.cc:77-153).

    ``response_found`` is the reference's incremental-parse callback:
    called with the accumulated buffer after every read; truthy return
    ends the read early.  Reads otherwise continue to the deadline (the
    terminal 'types' its answer, so spurious user keystrokes can arrive
    interleaved and must not truncate detection)."""
    fd = _find_tty_fd()
    if fd is None:
        return b""
    try:
        old = termios.tcgetattr(fd)
    except termios.error:
        return b""
    buf = b""
    try:
        # The reference's raw mode (term-query.cc:99-106): VMIN/VTIME 0,
        # iflag cleared, ICANON|ECHO off -- but OPOST and ISIG stay ON,
        # unlike tty.setraw's full cfmakeraw: the query may run
        # concurrently with frame output (the async OSC 11 bg query),
        # which must not staircase, and Ctrl-C must keep working.
        raw = termios.tcgetattr(fd)
        raw[0] = 0                                   # c_iflag
        raw[3] &= ~(termios.ICANON | termios.ECHO)   # c_lflag
        raw[6][termios.VMIN] = 0
        raw[6][termios.VTIME] = 0
        termios.tcsetattr(fd, termios.TCSANOW, raw)
        os.write(fd, query)
        import time
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            r, _, _ = select.select([fd], [], [], remaining)
            if not r:
                break
            chunk = os.read(fd, 512)
            if not chunk:
                break
            buf += chunk
            if response_found is not None and response_found(buf):
                break
    finally:
        # TCSAFLUSH like the reference's clean_up_terminal (:40-45):
        # drop reply bytes that arrive after the deadline instead of
        # leaking them to the shell prompt or into the image stream.
        termios.tcsetattr(fd, termios.TCSAFLUSH, old)
    return buf


def determine_term_size() -> TermSizeResult:
    """ref term-query.cc:369-406."""
    result = TermSizeResult()
    fd = _find_tty_fd()
    if fd is None:
        return result
    try:
        import fcntl
        import struct
        data = fcntl.ioctl(fd, termios.TIOCGWINSZ, b"\0" * 8)
        rows, cols, xpixel, ypixel = struct.unpack("HHHH", data)
    except OSError:
        return result
    result.cols, result.rows = cols, rows
    if rows > 0 and cols > 0 and xpixel >= 2 * cols and ypixel >= 4 * rows:
        # Plausible pixel values: a font is at least 2x4 px (ref :386-392).
        result.font_width_px = xpixel // cols
        result.font_height_px = ypixel // rows
    else:
        # Fallback: cell size query CSI 16t, 50ms budget (ref :347-366).
        resp = query_terminal(
            b"\033[16t", 0.05,
            lambda b: re.search(rb"\033\[6;\d+;\d+t", b))
        m = re.search(rb"\033\[6;(\d+);(\d+)t", resp)
        if m:
            result.font_height_px = int(m.group(1))
            result.font_width_px = int(m.group(2))
    return result


def query_background_color() -> Optional[str]:
    """OSC 11 background query; 1.5s budget (ref term-query.cc:165-224).

    The finder mirrors the reference's (:201-206): done once "rgb:"
    has appeared AND a terminating backslash follows it -- a lone
    user-typed backslash before the response must not end the read."""
    def found(buf: bytes) -> bool:
        i = buf.find(b"rgb:")
        return i >= 0 and buf.find(b"\\", i) >= 0

    resp = query_terminal(b"\033]11;?\033\\", 1.5, found)
    m = re.search(
        rb"\033\]11;rgb:([0-9a-fA-F]+)/([0-9a-fA-F]+)/([0-9a-fA-F]+)", resp)
    if not m:
        return None

    def scale(component: bytes) -> int:
        # the reference takes the first two hex digits of each
        # component verbatim (high byte of the 16-bit value, ref
        # term-query.cc:210-220: memcpy of 2 chars into "#rrggbb") --
        # NOT a rounded 16->8-bit rescale, and parity binds to it
        # (rgb:8000/... must become 0x80, not round(0x8000*255/65535))
        two = (component + b"0")[:2]
        return int(two, 16)

    r, g, b = (scale(m.group(i)) for i in (1, 2, 3))
    return f"#{r:02x}{g:02x}{b:02x}"


def query_supported_graphics_protocol() -> GraphicsInfo:
    """Detect kitty/iterm2/sixel support (ref term-query.cc:226-345)."""
    info = GraphicsInfo()
    term = os.environ.get("TERM", "")
    term_program = os.environ.get("TERM_PROGRAM", "")
    # Quirk env override seeds the INITIAL values (ref :229-231);
    # terminal detection below can still turn the quirks on.
    quirk = get_int_env("TIMG_SIXEL_NEWLINE_WORKAROUND", 0)
    info.sixel.known_broken_cursor_placement = bool(quirk & 1)
    info.sixel.full_cell_jump = bool(quirk & 2)
    # Deviation from the reference (documented): the reference learns
    # about tmux ONLY from the CSI >q response (ref :308), so output
    # redirected to a file while inside tmux misses the passthrough
    # wrapping.  The TMUX / TERM env guess is a strictly-additive
    # signal that keeps `timg-tpu -o file` + `cat` working in tmux.
    # (TERM=screen* alone is NOT a signal: that is GNU screen, which
    # has no passthrough -- tmux sets $TMUX and/or TERM=tmux-*.)
    info.in_tmux = bool(os.environ.get("TMUX")) or term.startswith("tmux")

    # Environment-variable hints, exact matches only (ref :239-260:
    # "Only testing environment variables with very specific content").
    if term in ("xterm-kitty", "xterm-ghostty"):
        info.preferred_graphics = "kitty"
        # Fall through: still have to determine if we're in tmux.
    if term_program == "vscode":
        info.preferred_graphics = "iterm2"
        # in case the user chooses sixel (ref :250-254)
        info.sixel.known_broken_cursor_placement = True
    elif term_program == "WarpTerminal":
        info.preferred_graphics = "iterm2"

    # CSI >q term version query (ref :277-318).  Like the reference,
    # this runs even when an env hint already picked a protocol: the
    # response is also how a tmux pane is detected, and a response
    # match overrides the env guess.  The read ends on the DSR-5 reply
    # "CSI 0" (ref :317), never on a mid-response byte.
    resp = query_terminal(b"\033[>q\033[5n", 0.25,
                          lambda b: b"\033[0" in b)
    txt = resp.decode("latin-1", "replace")
    # Sequential case-sensitive matchers in the reference's order
    # (ref :283-316): a response naming several terminals resolves
    # exactly as the reference resolves it.
    if "iTerm2" in txt or "Konsole 2" in txt:
        info.preferred_graphics = "iterm2"
    if "WezTerm" in txt:
        info.preferred_graphics = "iterm2"
        info.sixel.known_broken_cursor_placement = True
    if "kitty" in txt:
        info.preferred_graphics = "kitty"
    if "ghostty" in txt:
        info.preferred_graphics = "kitty"
    if "mlterm" in txt:
        info.preferred_graphics = "sixel"
    if "XTerm" in txt:
        # don't know yet if it supports sixel (DA1 below decides), but
        # the cursor-placement quirk applies regardless (ref :300-303)
        info.sixel.known_broken_cursor_placement = True
    if "foot" in txt:
        info.preferred_graphics = "sixel"
        info.sixel.known_broken_cursor_placement = True
    if "tmux" in txt:
        info.in_tmux = True
    if "WindowsTerminal" in txt:             # ref :310-316
        info.sixel.known_broken_cursor_placement = True
        info.sixel.full_cell_jump = True
    # DA1 sixel capability fallback whenever the protocol is still
    # unknown -- the reference probes unconditionally, also covering
    # terminals that answer nothing recognizable to CSI >q
    # (ref :320-343; the ";4" must follow the "CSI ?" response intro;
    # the read ends once "CSI ?" has appeared, like the reference's
    # finder).
    if info.preferred_graphics == "none":
        da1 = query_terminal(b"\033[c", 0.25,
                             lambda b: b"\033[?" in b)
        if re.search(rb"\033\[\?[0-9;]*?;4[;c]", da1):
            info.preferred_graphics = "sixel"
    return info
