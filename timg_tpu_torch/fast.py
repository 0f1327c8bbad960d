"""One-shot still fastpath of the port (counterpart of timg_tpu/fast.py):
the interactive `timg-tpu-torch image.png` case when the caller asks
for the CPU.

The port's entry points run on the card unless the caller asks for the
CPU, so this host-only path is the CPU route made fast: it is taken only
when TIMG_TPU_TORCH_DEVICE=cpu is set (read by utils.device_name)
and TIMG_TPU_NO_FASTPATH is not.  With the default device it returns
None at once, and the launcher sends the invocation to the resident
server or runs the CLI on the card: a still on the card's host always
runs on the card.

The full session path (cli.py) imports numpy and torch -- hundreds of
ms of cold import that the reference's compiled binary does not pay
(9.5 ms in all).  This module renders the common one-shot case entirely
through the native still pipeline (native/timg_still.cc: PNG decode,
scale-to-fit, stb taps + polyphase resize, alpha compose, block glyph
selection, ANSI emit) with **zero numpy/PIL/torch imports**, and *bails*
(returns None) for anything outside its envelope so the launcher falls
back to cli.main.

Byte parity: for every eligible invocation, output (stdout bytes,
stderr text, exit code) is identical to cli.main on the CPU and to
timg_tpu/fast.py's -- enforced by tests/test_torch_fastpath_cli.py over
an option matrix. The rendering below
therefore mirrors cli.py/_present_images, renderer.SingleColumnRenderer,
render/ansi.UnicodeBlockCanvas and sources/pil_source semantics for the
still/block-mode subset (behavioral spec: ref src/timg.cc:726-1005,
src/image-source.cc, src/renderer.cc:46-76,
src/unicode-block-canvas.cc).

Envelope (everything else bails):
  * all positional/-f inputs are regular-file stills: PNGs in the
    native decoder's subset (8-bit, non-interlaced, not APNG, no eXIf
    when rotation is on) decode in C with zero Python-library imports;
    JPEG/GIF/BMP/WebP stills decode through PIL (the full path's own
    decoder — parity by construction, ~155 ms of import paid only when
    one appears; torch/numpy still never load) — or nonexistent/
    unreadable (that error path is replicated exactly);
  * pixelation resolves to quarter/half blocks or to any of the three
    pixel-direct protocols: iTerm2 (OSC 1337 PNG), kitty (APC chunked
    PNG; bails inside tmux — passthrough needs the full canvas) and
    sixel (reference-exact libsixel quant.c pipeline + RLE assembly,
    both C; bails for --dither=cube/adaptive which run through the
    numpy/device quantizers);
  * no grid, scroll, auto-crop, frame limits, verbose stats, video
    flags, --devices or --serve;
  * no flag values that would print a warning (the full path would
    re-print it after a fallback, so warn-y invocations bail first).
"""

from __future__ import annotations

import ctypes
import os
import re
import signal
import stat as stat_mod
import sys
import time
from typing import List, Optional, Tuple

# Exit codes (ref timg.cc:98-106; cli.py mirrors).
EXIT_SUCCESS = 0
EXIT_IMAGE_READ_ERROR = 1
EXIT_PARAMETER_ERROR = 2
EXIT_NOT_A_TERMINAL = 3
EXIT_CANT_OPEN_OUTPUT = 4
EXIT_FILELIST_PROBLEM = 5

_CURSOR_ON = b"\033[?25h"
_CURSOR_OFF = b"\033[?25l"
_SCREEN_CLEAR = b"\033c"

_PIX = {"h": "half", "q": "quarter", "k": "kitty", "i": "iterm2",
        "s": "sixel"}

_interrupted = False


def _sig_handler(signo, frame):  # noqa: ARG001
    global _interrupted
    _interrupted = True


def _atof(text: str) -> float:
    """C atof (cli._atof mirror)."""
    m = re.match(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", text)
    return float(m.group(0)) if m else 0.0


def _atoi(text: str) -> int:
    """C atoi (cli._atoi mirror)."""
    m = re.match(r"\s*[+-]?\d+", text)
    return int(m.group(0)) if m else 0


_HEX_RE = re.compile(r"^#([0-9a-fA-F]{2})([0-9a-fA-F]{2})([0-9a-fA-F]{2})")
_RGB_RE = re.compile(r"^rgb\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)$")
_RGBX_RE = re.compile(
    r"^rgb\(\s*0x([0-9a-fA-F]+)\s*,\s*0x([0-9a-fA-F]+)\s*,"
    r"\s*0x([0-9a-fA-F]+)\s*\)$")


def _color_would_warn(color: Optional[str]) -> bool:
    """True when colors.parse_color(color) would print its warning
    (silent pre-check so a later fallback cannot double-print)."""
    if not color:
        return False
    from timg_tpu_torch._css3_colors import CSS3_COLORS
    lowered = color.lower()
    if lowered == "none" or lowered in CSS3_COLORS:
        return False
    return not (_HEX_RE.match(color) or _RGB_RE.match(color)
                or _RGBX_RE.match(color))


def _trim_title(title: str, requested_width: int, center: bool) -> str:
    """renderer.trim_title mirror (ref renderer.cc:29-42)."""
    result = title
    if len(result) > requested_width:
        result = "..." + result[len(result) - requested_width + 3:]
    elif center:
        start_spaces = (requested_width - len(result)) // 2
        result = " " * start_spaces + result
    return result + "\n"


def _format_title(fmt: str, filename: str, w: int, h: int) -> str:
    """sources.base.format_from_parameters mirror for the pil decoder
    role (ref image-source.cc:272-295)."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch != "%" or i >= len(fmt) - 1:
            out.append(ch)
            i += 1
            continue
        i += 1
        spec = fmt[i]
        if spec == "f":
            out.append(filename)
        elif spec == "b":
            out.append(os.path.basename(filename))
        elif spec == "w":
            out.append(str(w))
        elif spec == "h":
            out.append(str(h))
        elif spec == "D":
            # PILSource.decoder_name: the full-path decoder this
            # fastpath shadows.
            out.append("pil")
        else:
            out.append(spec)
        i += 1
    return "".join(out)


def _reliable_write(fd: int, buffer: bytes) -> None:
    """sequencer._reliable_write mirror (partial-write retry; stop on
    broken pipe like the reference's write()<=0 bail)."""
    view = memoryview(buffer)
    while view:
        try:
            n = os.write(fd, view)
        except (BrokenPipeError, OSError):
            return
        if n <= 0:
            return
        view = view[n:]


class _Bail(Exception):
    """Internal: invocation is outside the fastpath envelope."""


def _sniff_still(sig: bytes) -> Optional[str]:
    """Magic-signature classification: "png" decodes in C, "pil"
    decodes through PIL (JPEG/GIF/BMP/WebP stills); None bails to the
    full path (videos, TGA's magic-less format, everything exotic —
    in the full path PNG/JPEG/GIF/BMP/WebP with these signatures all
    land in PILSource, so the decoder choice matches)."""
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        return "png"
    if sig.startswith(b"\xff\xd8\xff"):
        return "pil"  # JPEG
    if sig.startswith((b"GIF87a", b"GIF89a")):
        return "pil"
    if sig.startswith(b"BM"):
        return "pil"
    if sig.startswith(b"RIFF") and sig[8:12] == b"WEBP":
        return "pil"
    return None


class _NativeStill:
    """Decode + scale + compose + block-select one still natively.

    PNGs decode in C (timg_still.cc, zero Python-library imports);
    other still formats (JPEG/GIF/BMP/WebP) decode through PIL — the
    *same* decoder the full path uses, so parity is by construction —
    and everything after the RGBA bytes runs in C either way.  PIL
    costs ~155 ms of import paid only when a non-PNG file appears;
    torch/numpy are never imported."""

    def __init__(self, lib, filename: str, kind: str):
        self.lib = lib
        self.filename = filename
        self.kind = kind  # "png" | "pil"
        self.orig_w = 0
        self.orig_h = 0
        self._true_orig: Optional[Tuple[int, int]] = None

    def render_planes(self, disp: dict, bg_getter) -> Tuple:
        if self.kind == "pil":
            return self._render_pil(disp, bg_getter)
        lib = self.lib
        try:
            with open(self.filename, "rb") as f:
                data = f.read()
        except OSError:
            raise _Bail("vanished between gate and decode")
        out = ctypes.c_void_p()
        w = ctypes.c_int()
        h = ctypes.c_int()
        flags = ctypes.c_int()
        rc = lib.timg_png_decode(data, len(data), ctypes.byref(out),
                                 ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(flags))
        if rc != 0:
            # outside the decoder's subset, or no deflate library loads
            raise _Bail("decode subset")
        try:
            if flags.value & 1:  # acTL: APNG, video-decoder territory
                raise _Bail("apng")
            if disp["exif_rotate"] and (flags.value & 2):
                raise _Bail("exif")
            return self._scale_and_blocks(out, w.value, h.value, disp,
                                          bg_getter)
        finally:
            lib.timg_buf_free(out)

    def _render_pil(self, disp: dict, bg_getter) -> Tuple:
        """PIL decode mirroring sources/pil_source.py's still path
        (EXIF orientation, JPEG DCT-domain draft, convert("RGBA")) —
        numpy-free: pixel work continues in C on the raw bytes."""
        try:
            from PIL import Image, ImageOps
        except ImportError:
            # the launcher boots `python -S`: the (venv) site-packages
            # directory is not on sys.path; derive it from the
            # executable (sys.prefix is the base prefix under -S, so
            # sysconfig would point at the wrong tree for venvs)
            ver = "python%d.%d" % sys.version_info[:2]
            exe_prefix = os.path.dirname(
                os.path.dirname(os.path.abspath(sys.executable)))
            for prefix in (exe_prefix, sys.prefix):
                cand = os.path.join(prefix, "lib", ver, "site-packages")
                if os.path.isdir(cand) and cand not in sys.path:
                    sys.path.append(cand)
            try:
                from PIL import Image, ImageOps
            except ImportError:
                raise _Bail("no PIL")
        try:
            img = Image.open(self.filename)
        except Exception:
            raise _Bail("pil cannot open")
        if getattr(img, "n_frames", 1) > 1 or getattr(img, "format",
                                                      "") == "ICO":
            raise _Bail("animation / multi-image container")
        if img.mode in ("I", "I;16", "I;16L", "I;16B", "I;16N"):
            raise _Bail("high-bit-depth (numpy mirror semantics)")
        if getattr(img, "format", None) == "BMP" and img.mode == "RGB" \
                and getattr(img, "tile", None):
            # the 32-bit BI_RGB alpha rewire lives in the numpy path
            args = img.tile[0][3] if img.tile else ()
            if args and args[0] == "BGRX":
                raise _Bail("BMP BGRX alpha rewire")

        true_size = img.size
        orientation = 1
        if disp["exif_rotate"]:
            try:
                orientation = int(img.getexif().get(0x0112) or 1)
            except Exception:
                orientation = 1
        # DCT-domain downscale for large JPEGs (pil_source mirror of
        # ref jpeg-source.cc:184-195; same guards)
        if img.format == "JPEG" and orientation == 1:
            tw = ctypes.c_int()
            th = ctypes.c_int()
            self.lib.timg_calc_scale(
                true_size[0], true_size[1], disp["width"], disp["height"],
                int(disp["fill_width"]), 0, disp["width_stretch"],
                int(disp["upscale"]), int(disp["upscale_integer"]),
                disp["cell_x_px"], disp["cell_y_px"], 0,
                ctypes.byref(tw), ctypes.byref(th))
            if (tw.value > 0 and th.value > 0
                    and true_size[0] >= 2 * tw.value
                    and true_size[1] >= 2 * th.value):
                img.draft(None, (tw.value, th.value))
                if img.size != true_size:
                    self._true_orig = true_size
        if disp["exif_rotate"] and orientation != 1:
            img = ImageOps.exif_transpose(img)
        try:
            rgba = img.convert("RGBA")
        except Exception:
            raise _Bail("pil convert")
        w, h = rgba.size
        data = rgba.tobytes()
        buf = ctypes.create_string_buffer(data, len(data))
        planes = self._scale_and_blocks(buf, w, h, disp, bg_getter)
        if self._true_orig is not None:
            # drafted decode: titles report the file's real dimensions
            self.orig_w, self.orig_h = self._true_orig
        return planes

    def _scale_and_blocks(self, src_p, iw: int, ih: int, disp: dict,
                          bg_getter):
        lib = self.lib
        self.orig_w, self.orig_h = iw, ih
        tw = ctypes.c_int()
        th = ctypes.c_int()
        lib.timg_calc_scale(
            iw, ih, disp["width"], disp["height"], int(disp["fill_width"]),
            0, disp["width_stretch"], int(disp["upscale"]),
            int(disp["upscale_integer"]), disp["cell_x_px"],
            disp["cell_y_px"], 0, ctypes.byref(tw), ctypes.byref(th))
        target_w, target_h = tw.value, th.value
        if disp["quarter"] and target_w % 2:
            # degenerate 1-px-wide quarter target: the full path
            # replicates the reference's odd-width overrun semantics
            # (ansi.widen_odd_quarter); outside the fastpath envelope
            raise _Bail("odd quarter width")

        if (ih, iw) != (target_h, target_w):
            dst = ctypes.create_string_buffer(target_h * target_w * 4)
            if not disp["antialias"]:
                lib.timg_resize_nearest(src_p, ih, iw, dst, target_h,
                                        target_w)
            else:
                starts_v = ctypes.c_void_p()
                coeffs_v = ctypes.c_void_p()
                widest_v = lib.timg_build_taps(ih, target_h, 0,
                                               ctypes.byref(starts_v),
                                               ctypes.byref(coeffs_v))
                starts_h = ctypes.c_void_p()
                coeffs_h = ctypes.c_void_p()
                widest_h = lib.timg_build_taps(iw, target_w, 1,
                                               ctypes.byref(starts_h),
                                               ctypes.byref(coeffs_h))
                rc = -1
                if widest_v >= 1 and widest_h >= 1:
                    vfirst = lib.timg_plan_passes(ih, iw, target_h,
                                                  target_w, 1)
                    rc = lib.timg_resize_polyphase(
                        src_p, 1, ih, iw, dst, target_h, target_w,
                        starts_v, coeffs_v, widest_v,
                        starts_h, coeffs_h, widest_h, vfirst, 1)
                for p in (starts_v, coeffs_v, starts_h, coeffs_h):
                    lib.timg_buf_free(p)
                if rc != 0:
                    raise _Bail("resize")
            frame = dst
        else:
            frame = ctypes.create_string_buffer(
                ctypes.string_at(src_p, ih * iw * 4), ih * iw * 4)

        # Lazy background compose (pil_source._process_frames mirror;
        # ref framebuffer.cc:113-121 lazy bgcolor query).
        if lib.timg_has_translucency(frame, target_h * target_w):
            bg = bg_getter()
            if bg[3] != 0:
                pw = disp["pattern_size"] * disp["cell_x_px"]
                ph = disp["pattern_size"] * disp["cell_y_px"] // 2
                lib.timg_alpha_over_bg(frame, target_h, target_w,
                                       bytes(bg),
                                       bytes(disp["bg_pattern_color"]),
                                       pw, ph, 0)

        if disp["pixelation"] in ("iterm2", "kitty", "sixel"):
            # pixel-direct: hand back the processed RGBA frame; the
            # emitter turns it into a PNG / sixel DCS stream
            # (iterm2.py / kitty.py / sixel_render.py mirrors)
            return ("frame", frame, target_w, target_h)

        # Odd-height empty-line shift (ansi.pad_frame mirror,
        # ref unicode-block-canvas.cc:356-365).
        buf = frame.raw[:target_h * target_w * 4]
        padded_h = target_h
        if target_h % 2:
            empty = b"\x00" * (target_w * 4)
            buf = (buf + empty) if disp["use_upper"] else (empty + buf)
            padded_h += 1

        hcells = padded_h // 2
        wcells = target_w // 2 if disp["quarter"] else target_w
        glyph = ctypes.create_string_buffer(hcells * wcells * 4)
        fg = ctypes.create_string_buffer(hcells * wcells * 4)
        bgp = ctypes.create_string_buffer(hcells * wcells * 4)
        fn = (lib.timg_quarter_blocks if disp["quarter"]
              else lib.timg_half_blocks)
        fn(buf, padded_h, target_w, int(disp["use_upper"]), glyph, fg, bgp)
        return ("blocks", glyph, fg, bgp, hcells, wcells, target_w)


# Kitty image ids (render/kitty._create_id mirror, ref
# kitty-canvas.cc:48-53).  Time-seeded, so ids necessarily differ
# run-to-run (the parity tests pin both modules' seeds).
_B64_CHUNK = 4096          # max allowed by the protocol (ref :43)
_BYTE_CHUNK = _B64_CHUNK // 4 * 3
_kitty_id_start: Optional[int] = None
_kitty_id_counter = 0


def _kitty_create_id() -> int:
    global _kitty_id_start, _kitty_id_counter
    if _kitty_id_start is None:
        _kitty_id_start = (int(time.time()) << 7) & 0xFFFFFFFF
    _kitty_id_counter += 1
    return (_kitty_id_start + _kitty_id_counter) & 0xFFFFFFFF


def _kitty_payload(lib, frame_buf, target_w: int, target_h: int,
                   compress_level: int, with_alpha: bool) -> bytes:
    """Kitty APC framing for one still (render/kitty._frame_payload
    mirror, wrap=False; ref kitty-canvas.cc:178-235)."""
    import base64

    channels = 4 if with_alpha else 3
    raw = ctypes.create_string_buffer(target_h * (1 + target_w * channels))
    lib.timg_png_sub_filter(frame_buf, target_h, target_w, channels, raw)
    from timg_tpu_torch.render.png_core import encode_png_from_filtered
    png = encode_png_from_filtered(raw.raw, target_w, target_h,
                                   compress_level, with_alpha=with_alpha)
    image_id = _kitty_create_id()
    out = bytearray()
    out += b"\033_Ga=T,i=%d,q=2,f=100,m=%d;" % (
        image_id, 1 if len(png) > _BYTE_CHUNK else 0)
    pos = 0
    while pos < len(png):
        chunk = png[pos:pos + _BYTE_CHUNK]
        pos += len(chunk)
        out += base64.b64encode(chunk)
        if pos < len(png):
            out += b"\033\\\033_Gq=2,m=%d;" % (
                1 if len(png) - pos > _BYTE_CHUNK else 0)
    out += b"\033\\\n"
    return bytes(out)


def _sixel_payload(lib, frame_buf, target_w: int, target_h: int,
                   bg_getter) -> bytes:
    """Sixel DCS stream for one still: height padded to a multiple of 6
    with a background-composed strip (sixel_render.SixelCanvas.send
    mirror, ref sixel-canvas.cc:91-120), then the reference-exact
    libsixel quant.c pipeline + RLE assembly, both in C."""
    w, h = target_w, target_h
    padded_h = (h + 5) - (h + 5) % 6
    buf = frame_buf.raw[:h * w * 4]
    if padded_h > h:
        bg = bg_getter()
        if bg[3] != 0:
            px = bytes((bg[0], bg[1], bg[2], 255))
            buf += px * ((padded_h - h) * w)
        else:
            buf += b"\x00" * ((padded_h - h) * w * 4)
    pal = ctypes.create_string_buffer(256 * 3)
    idx = ctypes.create_string_buffer(padded_h * w)
    rc = lib.timg_libsixel_quant(buf, padded_h, w, w * 4, 256, pal, idx)
    if rc < 0:
        raise _Bail("libsixel quant")
    ncolors = rc & 0xFFFF
    n_bands = (padded_h + 5) // 6
    cap = n_bands * ncolors * (w + 12) + ncolors * 20 + 256
    out = ctypes.create_string_buffer(cap)
    n = lib.timg_sixel_encode(idx, padded_h, w, w, pal, ncolors, out)
    if n < 0:
        raise _Bail("sixel assembly")
    return ctypes.string_at(out, n)


def try_fast_main(argv: Optional[List[str]] = None) -> Optional[int]:
    """Render argv through the native fastpath; None = fall back."""
    global _interrupted
    _interrupted = False
    argv = argv if argv is not None else sys.argv[1:]

    from timg_tpu_torch.utils import device_name

    env = os.environ
    if env.get("TIMG_TPU_NO_FASTPATH") or device_name(env) != "cpu":
        # the host path is the CPU asked for; any other device runs on
        # the card (through the server or the CLI)
        return None

    from timg_tpu_torch.args import (_BARE, _getopt_optional_args,
                                     build_arg_parser)
    parser = build_arg_parser()
    try:
        args = parser.parse_args(_getopt_optional_args(argv))
    except SystemExit:
        # argparse already printed the message; cli.main's handler maps
        # this to the same code, so do not fall back (it would reprint).
        return EXIT_PARAMETER_ERROR

    if (args.version or args.long_help or args.short_help or args.verbose
            or args.grid or args.scroll or args.delta_move or args.auto_crop
            or args.video_only or args.frame_offset != 0
            or args.frames != -(2 ** 31) or args.devices or args.serve):
        return None

    # Warn-y flag values bail BEFORE anything prints (see module doc).
    if args.pixelation and args.pixelation[0].lower() not in _PIX:
        return None
    for v in args.upscale or ():
        if v != _BARE and v[:1].lower() != "i":
            return None
    if args.bg_color.lower() != "auto" and _color_would_warn(args.bg_color):
        return None
    if _color_would_warn(args.bg_pattern_color):
        return None

    from timg_tpu_torch.native import runtime
    lib = runtime.load_still()
    if lib is None:
        return None

    from timg_tpu_torch import term, utils
    tsize = term.determine_term_size()

    # Resolve pixelation; block modes and all three pixel-direct
    # protocols stay in the fastpath.
    pixelation = None  # NOT_CHOSEN
    env_pix = env.get("TIMG_PIXELATION")
    if env_pix:
        pixelation = _PIX.get(env_pix[0].lower())
    if args.pixelation:
        pixelation = _PIX.get(args.pixelation[0].lower()) or pixelation
    # cli.py's cell-size sieve runs against the explicit/env choice
    # (NOT_CHOSEN is never pixel-direct there), so compute it before
    # the auto-resolution below (ref timg.cc:742-767).
    cell_unknown_pixel_mode = (
        pixelation in ("iterm2", "kitty", "sixel")
        and (tsize.font_width_px < 0 or tsize.font_height_px < 0))
    sixel_opts = None
    if pixelation is None:
        pixelation = "quarter"
        if tsize.font_width_px > 0 and tsize.font_height_px > 0:
            # same graphics-protocol query the full path runs
            # (ref timg.cc:770-793)
            ginfo = term.query_supported_graphics_protocol()
            if ginfo.preferred_graphics == "iterm2":
                pixelation = "iterm2"
            elif ginfo.preferred_graphics == "kitty":
                if ginfo.in_tmux:
                    # tmux passthrough + placeholder tiles: full path
                    return None
                pixelation = "kitty"
            elif ginfo.preferred_graphics == "sixel":
                pixelation = "sixel"
                sixel_opts = ginfo.sixel
    elif pixelation == "kitty":
        # ref timg.cc:891-893 / cli.py: the explicit kitty choice still
        # queries the terminal for the tmux workaround
        if term.query_supported_graphics_protocol().in_tmux:
            return None
    elif pixelation == "sixel":
        sixel_opts = term.query_supported_graphics_protocol().sixel
    if pixelation not in ("quarter", "half", "iterm2", "kitty", "sixel"):
        return None
    if pixelation == "sixel" and args.dither != "libsixel":
        # cube/adaptive dither run through the numpy/device quantizers
        return None

    # ---- flag handling (cli.py mirror of ref timg.cc:521-718) ----
    geometry_width = tsize.cols - 2
    geometry_height = tsize.rows - 2
    if args.geometry:
        gw, _, gh = args.geometry.partition("x")
        try:
            if gw:
                geometry_width = int(gw)
            if gh:
                geometry_height = int(gh)
        except ValueError:
            print(f"Invalid size spec '{args.geometry}'", file=sys.stderr)
            return EXIT_PARAMETER_ERROR

    duration_between_images_ms = 0.0
    duration_for_row_ms = 0.0
    if args.wait:
        if args.wait.startswith("r"):
            duration_for_row_ms = round(_atof(args.wait[1:]) * 1000.0)
        else:
            duration_between_images_ms = round(_atof(args.wait) * 1000.0)

    duration_per_image_ms = float("inf")
    if args.duration is not None:
        duration_per_image_ms = round(args.duration * 1000.0)

    # --loops is inert for stills (send_frames forces loops=1).
    clear_screen = 0  # 0 NOT, 1 BEFORE_FIRST, 2 BEFORE_EACH
    for v in args.clear or ():
        if v == _BARE:
            clear_screen = 1
        elif len(v) <= 5 and "every".startswith(v.lower()):
            clear_screen = 2
        else:
            print(f"Parameter for --clear can be 'every', got {v}",
                  file=sys.stderr)
            return EXIT_PARAMETER_ERROR

    antialias = not args.no_antialias
    bg_color = args.bg_color
    center = args.center
    upscale = bool((len(args.upscale or ()) + args.upscale_short) % 2)
    upscale_integer = any(v != _BARE and v[:1].lower() == "i"
                          for v in args.upscale or ())
    exif_rotate = args.rotate.lower() != "off"
    if args.rotate.lower() not in ("exif", "off"):
        print(f"--rotate={args.rotate}: expected 'exif' or 'off'",
              file=sys.stderr)
        return EXIT_PARAMETER_ERROR

    show_title = bool(len(args.title or ()) % 2)
    title_format = env.get("TIMG_DEFAULT_TITLE") or "%f"
    for v in args.title or ():
        if v != _BARE:
            title_format = v

    try:
        output_fd = sys.stdout.fileno()
    except Exception:
        output_fd = 1
    opened_fd = False
    if args.outfile:
        try:
            output_fd = os.open(args.outfile,
                                os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o664)
            opened_fd = True
        except OSError as e:
            print(f"{args.outfile}: {e.strerror}", file=sys.stderr)
            return EXIT_CANT_OPEN_OUTPUT

    def _finish(code_or_none):
        if opened_fd:
            os.close(output_fd)
        return code_or_none

    compress_level = 1  # ref display-options.h:52 default
    for v in args.compress or ():
        level = 1 if v == _BARE else _atoi(v)
        # out-of-range silently falls back to 1 (ref timg.cc:694-701)
        compress_level = level if 0 <= level <= 9 else 1
    use_256 = args.color8
    hide_cursor = not args.no_hide_cursor

    # Filelists (cli.append_to_filelist mirror, ref timg.cc:288-309).
    filelist: List[str] = []

    def append_to_filelist(filelist_file: str, relative: bool) -> bool:
        path = "/dev/stdin" if filelist_file == "-" else filelist_file
        try:
            with open(path, "r") as f:
                lines = f.read().splitlines()
        except OSError as e:
            print(f"{filelist_file}: {e.strerror}", file=sys.stderr)
            return False
        prefix = filelist_file[: filelist_file.rfind("/") + 1]
        for name in lines:
            if not name:
                continue
            if relative and not name.startswith("/") and prefix:
                name = prefix + name
            filelist.append(name)
        return True

    for fl in args.filelist:
        if not append_to_filelist(fl, False):
            return _finish(EXIT_FILELIST_PROBLEM)
    for fl in args.filelist_rel:
        if not append_to_filelist(fl, True):
            return _finish(EXIT_FILELIST_PROBLEM)

    # ---- sanity sieve (cli.py mirror of ref timg.cc:726-905) ----
    if geometry_width < 1 or geometry_height < 1:
        if tsize.cols < 0 or tsize.rows < 0:
            print("Failed to read size from terminal; "
                  "Please supply -g<width>x<height> directly.",
                  file=sys.stderr)
        else:
            print(f"{geometry_width}x{geometry_height} is a rather "
                  "unusual size", file=sys.stderr)
        return _finish(EXIT_NOT_A_TERMINAL)

    pixel_direct = pixelation in ("iterm2", "kitty", "sixel")
    if pixelation in ("iterm2", "kitty") and bg_color.lower() == "auto":
        bg_color = "none"  # ref timg.cc:810-813 (terminal-side alpha)
    local_alpha = bg_color.lower() != "none"  # ref timg.cc:818-820

    fw, fh = tsize.font_width_px, tsize.font_height_px
    if pixel_direct:
        stretch_correct = 1.0
    else:
        stretch_correct = 0.5 * fh / fw if fw != 0 else float("inf")
    width_stretch = utils.get_float_env("TIMG_FONT_WIDTH_CORRECT",
                                        stretch_correct)
    if pixelation == "half":
        cell_x, cell_y = 1, 2
    elif pixelation == "quarter":
        width_stretch *= 2
        cell_x, cell_y = 2, 2
    else:  # pixel-direct: real font cell pixels (ref timg.cc:489-493)
        cell_x, cell_y = 1, 2  # DisplayOptions defaults
        if cell_unknown_pixel_mode:
            cell_x, cell_y = 9, 18  # ref timg.cc:742-767
            compress_level = 1
        else:
            if tsize.font_width_px > 0:
                cell_x = tsize.font_width_px
            if tsize.font_height_px > 0:
                cell_y = tsize.font_height_px

    width = geometry_width * cell_x
    height = geometry_height * cell_y

    filelist.extend(args.files)
    if not filelist:
        print("Expected image filename(s) on command line or via -f",
              file=sys.stderr)
        return _finish(EXIT_IMAGE_READ_ERROR)

    if show_title:
        height -= cell_y  # grid_rows == 1 (ref timg.cc:902-905)

    from timg_tpu_torch.colors import parse_color
    bg_cache: dict = {}

    def bg_getter():
        if "v" not in bg_cache:
            if bg_color.lower() == "auto":
                bg_cache["v"] = parse_color(term.query_background_color())
            else:
                bg_cache["v"] = parse_color(bg_color)
        return bg_cache["v"]

    bg_pattern_color = parse_color(args.bg_pattern_color)
    use_upper = utils.get_bool_env("TIMG_USE_UPPER_BLOCK")

    # ---- input gate: every file either an eligible still (by magic
    # signature) or cleanly missing (error diagnosis replicated) ----
    missing: dict = {}
    kinds: dict = {}
    for fname in filelist:
        if fname == "-":
            return _finish(None)
        if not os.path.exists(fname):
            missing[fname] = f"{fname}: No such file or directory"
            continue
        if os.path.isdir(fname):
            missing[fname] = f"{fname}: is a directory"
            continue
        if not os.access(fname, os.R_OK):
            missing[fname] = f"{fname}: Permission denied"
            continue
        try:
            if not stat_mod.S_ISREG(os.stat(fname).st_mode):
                return _finish(None)
            with open(fname, "rb") as f:
                sig = f.read(16)
        except OSError:
            return _finish(None)
        kind = _sniff_still(sig)
        if kind is None:
            return _finish(None)
        kinds[fname] = kind

    disp = {
        "width": width, "height": height, "cell_x_px": cell_x,
        "cell_y_px": cell_y, "width_stretch": width_stretch,
        "upscale": upscale, "upscale_integer": upscale_integer,
        "fill_width": args.fit_width, "antialias": antialias,
        "exif_rotate": exif_rotate, "pattern_size": args.pattern_size,
        "bg_pattern_color": bg_pattern_color,
        "quarter": pixelation == "quarter", "use_upper": use_upper,
        "pixelation": pixelation,
    }

    # Decode/render pass: any _Bail aborts before a byte is written.
    rendered: List[Optional[Tuple]] = []
    sources: List[Optional[_NativeStill]] = []
    try:
        for fname in filelist:
            if fname in missing:
                rendered.append(None)
                sources.append(None)
                continue
            src = _NativeStill(lib, fname, kinds[fname])
            planes = src.render_planes(disp, bg_getter)
            if pixelation == "sixel" and planes[0] == "frame":
                # build the full DCS stream now so a quant failure
                # bails before the first byte is written
                _, frame_buf, tw, th = planes
                planes = ("sixelstream",
                          _sixel_payload(lib, frame_buf, tw, th,
                                         bg_getter), tw, th)
            rendered.append(planes)
            sources.append(src)
    except _Bail:
        return _finish(None)

    # ---- emission (cli._present_images mirror for stills) ----
    errors: List[str] = []
    load_failed = False
    prefix = bytearray()
    is_first = True
    wait_time_ms = max(duration_between_images_ms, duration_for_row_ms)
    emit_buf = None
    emit_cap = 0

    for fname, planes, src in zip(filelist, rendered, sources):
        if _interrupted:
            break
        if planes is None:
            load_failed = True
            errors.append(missing[fname])
            continue
        signal.signal(signal.SIGINT, _sig_handler)
        signal.signal(signal.SIGTERM, _sig_handler)
        if hide_cursor:
            prefix.extend(_CURSOR_OFF)
        if clear_screen == 2 or (clear_screen == 1 and is_first):
            prefix.extend(_SCREEN_CLEAR)
        if show_title:
            title = _format_title(title_format, fname, src.orig_w,
                                  src.orig_h)
            prefix.extend(
                _trim_title(title, width // cell_x, center).encode("utf-8"))
        # send_frames duration cutoff (base.ImageSource.send_frames):
        # the single frame is emitted iff the budget is positive.
        if 0.0 < duration_per_image_ms:
            if planes[0] == "frame":
                _, frame_buf, target_w, target_h = planes
                indent = int((width - target_w) / 2) if center else 0
                dx_cells = indent // cell_x
                if dx_cells > 0:  # canvas.move_cursor_dx
                    prefix.extend(b"\033[%dC" % dx_cells)
                if pixelation == "iterm2":
                    # iTerm2 OSC 1337 (render/iterm2.py mirror,
                    # ref iterm2-canvas.cc:42-96)
                    import base64
                    channels = 4 if not local_alpha else 3
                    raw = ctypes.create_string_buffer(
                        target_h * (1 + target_w * channels))
                    lib.timg_png_sub_filter(frame_buf, target_h,
                                            target_w, channels, raw)
                    from timg_tpu_torch.render.png_core import \
                        encode_png_from_filtered
                    png = encode_png_from_filtered(
                        raw.raw, target_w, target_h, compress_level,
                        with_alpha=not local_alpha)
                    body = (b"\033]1337;File=size=%d;width=%dpx;"
                            b"height=%dpx;inline=1:"
                            % (len(png), target_w, target_h))
                    body += base64.b64encode(png) + b"\007\n"
                elif pixelation == "kitty":
                    body = _kitty_payload(lib, frame_buf, target_w,
                                          target_h, compress_level,
                                          with_alpha=not local_alpha)
                else:
                    raise AssertionError(pixelation)  # sixel pre-built
            elif planes[0] == "sixelstream":
                # sixel cursor-placement quirk framing (ref
                # sixel-canvas.cc:66-79; sixel_render.SixelCanvas)
                _, stream, target_w, _th = planes
                indent = int((width - target_w) / 2) if center else 0
                dx_cells = indent // cell_x
                if dx_cells > 0:
                    prefix.extend(b"\033[%dC" % dx_cells)
                if sixel_opts.known_broken_cursor_placement:
                    body = (b"\033[80l\033[?7730l\033[?8452h"
                            + stream + b"\n")
                else:
                    body = (b"\033[80h\033[?7730h\033[?8452l"
                            + stream + b"\r")
            else:
                _, glyph, fg, bgp, hcells, wcells, target_w = planes
                indent = int((width - target_w) / 2) if center else 0
                x = indent // 2 if pixelation == "quarter" else indent
                cap = hcells * (wcells * 48 + 24) + 64
                if cap > emit_cap:
                    emit_buf = ctypes.create_string_buffer(cap)
                    emit_cap = cap
                n = lib.timg_ansi_emit(glyph, fg, bgp, None, hcells,
                                       wcells, x, int(use_256), emit_buf)
                body = ctypes.string_at(emit_buf, n)
            _reliable_write(output_fd, bytes(prefix) + body)
            prefix.clear()
        if hide_cursor:
            _reliable_write(output_fd, _CURSOR_ON)
        signal.signal(signal.SIGINT, signal.SIG_DFL)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        if wait_time_ms > 0:
            time.sleep(wait_time_ms / 1000.0)
        is_first = False

    if prefix:  # canvas.close(): leftover prefix flushed as a control
        _reliable_write(output_fd, bytes(prefix))

    exit_code = EXIT_SUCCESS
    if errors or load_failed:
        exit_code = EXIT_IMAGE_READ_ERROR
    for err in errors[:4]:
        print(err, file=sys.stderr)
    if len(errors) >= 4:
        print(f"... total of {len(errors)} errors", file=sys.stderr)

    if _interrupted:
        print(f"\033[0m\033[{max(tsize.rows, 1)}B", file=sys.stderr)
        sys.stderr.flush()

    return _finish(exit_code)

