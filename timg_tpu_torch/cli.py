"""timg-tpu-torch command line (twin of timg_tpu/cli.py:main).

Same flag surface, option resolution, pacing and exit codes as the JAX
package's CLI; the sources and the canvas are the port's, and the
jax-only parts (compile cache, forced-host pinning, JAX profiler hook,
wedged-device exit) are gone.  The ported slices run opaque 4:2:0
video in ``-p sixel`` with every ``--dither`` mode (cube, libsixel,
adaptive, and auto, which resolves to one of the latter two as the JAX
CLI resolves it) and in ``-p quarter`` / ``-p half``; anything else
(kitty, iTerm2, images) exits with a "not yet ported" message.
The device is ``cuda`` unless TIMG_TPU_TORCH_DEVICE=cpu.
"""

from __future__ import annotations

import math
import os
import signal
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from timg_tpu_torch import utils
from timg_tpu_torch.args import _BARE, _getopt_optional_args, build_arg_parser
from timg_tpu_torch.colors import parse_color
from timg_tpu_torch.options import (NOT_INITIALIZED, ClearScreen,
                                    DisplayOptions, Pixelation,
                                    PresentationOptions, is_pixel_direct)
from timg_tpu_torch.render.sequencer import BufferedWriteSequencer

# Exit codes (ref timg.cc:98-106).
EXIT_SUCCESS = 0
EXIT_IMAGE_READ_ERROR = 1
EXIT_PARAMETER_ERROR = 2
EXIT_NOT_A_TERMINAL = 3
EXIT_CANT_OPEN_OUTPUT = 4
EXIT_FILELIST_PROBLEM = 5

_PIXELATION_BY_CHAR = {
    "h": Pixelation.HALF_BLOCK,
    "q": Pixelation.QUARTER_BLOCK,
    "k": Pixelation.KITTY,
    "i": Pixelation.ITERM2,
    "s": Pixelation.SIXEL,
}

interrupt_received = False


def _interrupt_handler(signo, frame):  # noqa: ARG001
    global interrupt_received
    interrupt_received = True


def _arm_signals(handler) -> None:
    """Arm SIGINT/SIGTERM only while showing (ref timg.cc:360-374).
    CPython restricts signal.signal to the main thread; a request run
    off the main thread (serve-mode tests) relies on the socket-side
    interrupt watcher instead."""
    import threading

    if threading.current_thread() is not threading.main_thread():
        return
    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)


def _parse_pixelation(text: Optional[str]) -> Optional[Pixelation]:
    if not text:
        return None
    return _PIXELATION_BY_CHAR.get(text[0].lower())


def _atof(text: str) -> float:
    """C atof: parse a leading float, 0.0 when nothing parses."""
    import re
    m = re.match(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", text)
    return float(m.group(0)) if m else 0.0


def _atoi(text: str) -> int:
    """C atoi: parse a leading integer, 0 when nothing parses."""
    import re
    m = re.match(r"\s*[+-]?\d+", text)
    return int(m.group(0)) if m else 0


def _pixelation_name(p: Pixelation) -> str:
    """ref timg.cc:412-424 PixelationToString."""
    return {
        Pixelation.HALF_BLOCK: "half block",
        Pixelation.QUARTER_BLOCK: "quarter block",
        Pixelation.KITTY: "kitty graphics",
        Pixelation.ITERM2: "iterm2 graphics",
        Pixelation.SIXEL: "sixel graphics",
    }.get(p, "(none)")


def _default_thread_count() -> int:
    return max(1, 3 * (os.cpu_count() or 1) // 4)  # ref timg.cc:153-154


def append_to_filelist(filelist_file: str, relative_to_filelist: bool,
                       filelist: List[str]) -> bool:
    """ref timg.cc:288-309."""
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
        if relative_to_filelist and not name.startswith("/") and prefix:
            name = prefix + name
        filelist.append(name)
    return True


def _not_ported(what: str) -> int:
    print(f"timg-tpu-torch: {what} is not yet ported to timg_tpu_torch "
          "(this build runs -p sixel on 4:2:0 video)",
          file=sys.stderr)
    return EXIT_PARAMETER_ERROR


def main(argv: Optional[List[str]] = None) -> int:
    global interrupt_received
    interrupt_received = False
    argv = argv if argv is not None else sys.argv[1:]

    parser = build_arg_parser()
    try:
        args = parser.parse_args(_getopt_optional_args(argv))
    except SystemExit:
        return EXIT_PARAMETER_ERROR

    if args.serve:
        return _not_ported("--serve")
    if args.version:
        import torch

        from timg_tpu_torch import __version__
        cuda = torch.version.cuda or "none"
        print(f"timg-tpu-torch {__version__}; torch {torch.__version__}, "
              f"CUDA {cuda}")
        return EXIT_SUCCESS
    if args.long_help:
        from timg_tpu_torch.help import invoke_help_pager
        return invoke_help_pager()
    if args.short_help:
        parser.print_help()
        return EXIT_SUCCESS
    if args.devices:
        return _not_ported("--devices")
    if args.resample != "auto":
        return _not_ported(f"--resample={args.resample}")

    from timg_tpu_torch.ops import backend
    try:
        backend.device()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return EXIT_PARAMETER_ERROR

    from timg_tpu_torch import term

    term.enable_query_logging(args.verbose)
    transport_base = None
    if args.verbose:
        from timg_tpu_torch.ops.sixel_runs import STATS
        transport_base = dict(STATS)
    tsize = term.determine_term_size()

    display = DisplayOptions()
    present = PresentationOptions()
    present.terminal_use_upper_block = utils.get_bool_env("TIMG_USE_UPPER_BLOCK")
    display.allow_frame_skipping = utils.get_bool_env("TIMG_ALLOW_FRAME_SKIP")

    geometry_width = tsize.cols - 2
    geometry_height = tsize.rows - 2

    env_pix = _parse_pixelation(os.environ.get("TIMG_PIXELATION"))
    if env_pix:
        present.pixelation = env_pix

    # ---- flag handling (timg_tpu/cli.py:239-377) ----
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

    if args.wait:
        if args.wait.startswith("r"):
            present.duration_for_row_ms = round(_atof(args.wait[1:]) * 1000.0)
        else:
            present.duration_between_images_ms = round(
                _atof(args.wait) * 1000.0)

    if args.duration is not None:
        present.duration_per_image_ms = round(args.duration * 1000.0)

    if args.loops:
        v = args.loops[-1]
        present.loops = -1 if v == _BARE else _atoi(v)

    for v in args.clear or ():
        if v == _BARE:
            present.clear_screen = ClearScreen.BEFORE_FIRST_IMAGE
        elif len(v) <= 5 and "every".startswith(v.lower()):
            present.clear_screen = ClearScreen.BEFORE_EACH_IMAGE
        else:
            print(f"Parameter for --clear can be 'every', got {v}",
                  file=sys.stderr)
            return EXIT_PARAMETER_ERROR

    frame_offset = args.frame_offset
    max_frames = args.frames
    display.antialias = not args.no_antialias
    bg_color = args.bg_color
    display.pattern_size = args.pattern_size
    if args.scroll:
        display.scroll_animation = True
        for v in args.scroll:
            if v != _BARE:
                display.scroll_delay_ms = float(_atoi(v))
    if args.delta_move:
        parts = args.delta_move.split(":")
        try:
            display.scroll_dx = int(parts[0])
            if len(parts) > 1:
                display.scroll_dy = int(parts[1])
        except ValueError:
            print(f"--delta-move={args.delta_move}: invalid", file=sys.stderr)
            return EXIT_PARAMETER_ERROR
    display.center_horizontally = args.center
    for v in list(args.upscale or []) + [_BARE] * args.upscale_short:
        display.upscale = not display.upscale
        if v != _BARE:
            if v[:1].lower() == "i":
                display.upscale_integer = True
            else:
                print("Invalid parameter to --upscale", file=sys.stderr)
    if args.auto_crop:
        display.auto_crop = True
        for v in args.auto_crop:
            if v != _BARE:
                display.crop_border = _atoi(v)
    display.exif_rotate = args.rotate.lower() != "off"
    if args.rotate.lower() not in ("exif", "off"):
        print(f"--rotate={args.rotate}: expected 'exif' or 'off'",
              file=sys.stderr)
        return EXIT_PARAMETER_ERROR

    if args.grid:
        gw, _, gh = args.grid.partition("x")
        try:
            present.grid_cols = int(gw)
            present.grid_rows = int(gh) if gh else present.grid_cols
        except ValueError:
            print(f"Invalid grid spec '{args.grid}'", file=sys.stderr)
            return EXIT_PARAMETER_ERROR

    for v in args.title or ():
        display.show_title = not display.show_title
        if v != _BARE:
            display.title_format = v

    try:
        output_fd = sys.stdout.fileno()
    except Exception:  # redirected pseudo-file (e.g. under pytest)
        output_fd = 1
    if args.outfile:
        try:
            output_fd = os.open(args.outfile,
                                os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o664)
        except OSError as e:
            print(f"{args.outfile}: {e.strerror}", file=sys.stderr)
            return EXIT_CANT_OPEN_OUTPUT

    if args.pixelation:
        pix = _parse_pixelation(args.pixelation)
        if pix:
            present.pixelation = pix
        else:
            print(f"Unknown --pixelation/-p parameter '{args.pixelation}'",
                  file=sys.stderr)

    for v in args.compress or ():
        level = 1 if v == _BARE else _atoi(v)
        display.compress_pixel_level = level if 0 <= level <= 9 else 1
    present.use_256_color = args.color8
    present.hide_cursor = not args.no_hide_cursor
    present.sixel_dither = args.dither

    filelist: List[str] = []
    for fl in args.filelist:
        if not append_to_filelist(fl, False, filelist):
            return EXIT_FILELIST_PROBLEM
    for fl in args.filelist_rel:
        if not append_to_filelist(fl, True, filelist):
            return EXIT_FILELIST_PROBLEM

    # ---- sanity sieve & refinement (timg_tpu/cli.py:379-507) ----
    if geometry_width < 1 or geometry_height < 1:
        if tsize.cols < 0 or tsize.rows < 0:
            print("Failed to read size from terminal; "
                  "Please supply -g<width>x<height> directly.", file=sys.stderr)
        else:
            print(f"{geometry_width}x{geometry_height} is a rather unusual size",
                  file=sys.stderr)
        return EXIT_NOT_A_TERMINAL

    cell_size_unknown_in_pixel_mode = (
        (tsize.font_width_px < 0 or tsize.font_height_px < 0)
        and is_pixel_direct(present.pixelation)
    )
    cell_size_warning_needed = False
    if cell_size_unknown_in_pixel_mode:
        cell_size_warning_needed = present.grid_cols > 1
        max_frames = 1
        display.cell_x_px = 9
        display.cell_y_px = 18
        display.compress_pixel_level = 1
        present.grid_cols = 1

    if present.pixelation == Pixelation.NOT_CHOSEN:
        present.pixelation = Pixelation.QUARTER_BLOCK
        if tsize.font_width_px > 0 and tsize.font_height_px > 0:
            from timg_tpu_torch.term import query_supported_graphics_protocol
            ginfo = query_supported_graphics_protocol()
            present.tmux_workaround = ginfo.in_tmux
            if ginfo.preferred_graphics == "iterm2":
                present.pixelation = Pixelation.ITERM2
            elif ginfo.preferred_graphics == "kitty":
                present.pixelation = Pixelation.KITTY
            elif ginfo.preferred_graphics == "sixel":
                present.pixelation = Pixelation.SIXEL
                present.sixel_options = ginfo.sixel
    elif present.pixelation == Pixelation.SIXEL:
        from timg_tpu_torch.term import query_supported_graphics_protocol
        present.sixel_options = query_supported_graphics_protocol().sixel
    if present.pixelation in (Pixelation.KITTY, Pixelation.ITERM2):
        return _not_ported(f"-p {_pixelation_name(present.pixelation)}")

    if bg_color.lower() == "none":
        display.local_alpha_handling = False

    if is_pixel_direct(present.pixelation):
        stretch_correct = 1.0
    else:
        # Plain C float math like the reference (timg.cc:825-828); the
        # unknown-cell-size case yields 0.5*(-2)/(-1) = 1.0 via the
        # TermSizeResult defaults (term-query.h:29-30).
        fw, fh = tsize.font_width_px, tsize.font_height_px
        stretch_correct = 0.5 * fh / fw if fw != 0 else float("inf")
    display.width_stretch = utils.get_float_env(
        "TIMG_FONT_WIDTH_CORRECT", stretch_correct)

    if present.pixelation == Pixelation.HALF_BLOCK:
        display.cell_x_px, display.cell_y_px = 1, 2
    elif present.pixelation == Pixelation.QUARTER_BLOCK:
        display.width_stretch *= 2
        display.cell_x_px, display.cell_y_px = 2, 2
    else:
        if tsize.font_width_px > 0:
            display.cell_x_px = tsize.font_width_px
        if tsize.font_height_px > 0:
            display.cell_y_px = tsize.font_height_px
    display.width = geometry_width * display.cell_x_px
    display.height = geometry_height * display.cell_y_px
    if present.pixelation == Pixelation.SIXEL:
        # lets the video window dither its frames in the session's mode
        display.sixel_batch_dither = present.sixel_dither
    display.resample = args.resample

    filelist.extend(args.files)
    if not filelist:
        print("Expected image filename(s) on command line or via -f",
              file=sys.stderr)
        return EXIT_IMAGE_READ_ERROR

    if display.scroll_dx == 0 and display.scroll_dy == 0 and display.scroll_animation:
        print("Scrolling chosen, but dx:dy = 0:0. "
              "Just showing image, no scroll.", file=sys.stderr)
        display.scroll_animation = False

    if (present.clear_screen == ClearScreen.BEFORE_EACH_IMAGE
            and (present.grid_cols != 1 or present.grid_rows != 1)):
        present.clear_screen = ClearScreen.BEFORE_FIRST_IMAGE

    display.fill_width = display.fill_width or args.fit_width or (
        display.scroll_animation and display.scroll_dy != 0)
    display.fill_height = (display.scroll_animation
                           and display.scroll_dx != 0)

    if max_frames == 1:
        present.loops = 1
    if (len(filelist) > 1 and present.loops == NOT_INITIALIZED
            and math.isinf(present.duration_per_image_ms)):
        present.loops = 1

    if display.show_title:
        display.height -= display.cell_y_px * present.grid_rows

    if bg_color.lower() == "auto":
        from timg_tpu_torch.term import query_background_color
        pool0 = ThreadPoolExecutor(max_workers=1)
        bg_future = pool0.submit(
            lambda: parse_color(query_background_color()))
        cache: dict = {}

        def getter():
            if "v" not in cache:
                cache["v"] = bg_future.result()
            return cache["v"]

        display.bgcolor_getter = getter
    else:
        bg = parse_color(bg_color)
        display.bgcolor_getter = (lambda: bg)

    display.bg_pattern_color = parse_color(args.bg_pattern_color)

    display.width //= present.grid_cols
    display.height //= present.grid_rows

    # ---- async decode fan-out (timg_tpu/cli.py:509-553) ----
    from timg_tpu_torch.sources.base import create_source

    thread_count = args.threads or _default_thread_count()
    pool = ThreadPoolExecutor(
        max_workers=max(1, min(thread_count, len(filelist) + 1)))
    errors: List[str] = []
    exit_code = EXIT_SUCCESS
    load_failed = False

    def load(filename: str):
        nonlocal load_failed
        if interrupt_received:
            return None
        src, err = create_source(
            filename, display, frame_offset, max_frames,
            attempt_image_loading=not args.video_only,
            attempt_video_loading=not args.image_only,
        )
        if src is None:
            load_failed = True
            if err:
                errors.append(err)
        return src

    loaded = [pool.submit(load, f) for f in filelist]

    sequencer = BufferedWriteSequencer(
        output_fd,
        allow_frame_skipping=(display.allow_frame_skipping
                              and is_pixel_direct(present.pixelation)),
        max_queue_len=4,
        debug_no_frame_delay=args.debug_no_frame_delay,
        interrupt_flag=lambda: interrupt_received,
    )

    start_show = time.monotonic()
    successful, any_animations = _present_images(
        loaded, display, present, sequencer)
    duration = time.monotonic() - start_show
    sequencer.shutdown()

    if cell_size_unknown_in_pixel_mode \
            and (cell_size_warning_needed or any_animations):
        print(
            "Terminal does not support pixel size query, "
            f"but with {_pixelation_name(present.pixelation)} this is "
            "needed to show animations or columns.\n"
            "File an issue with your terminal implementation to implement "
            "ws_xpixel, ws_ypixel on TIOCGWINSZ or \"\\033[16t\" query.\n"
            "Can't show animations or have columns in grid.\n(Suggestion: "
            "switch back to --pixelation=quarter for now)",
            file=sys.stderr)

    if errors or load_failed:
        exit_code = EXIT_IMAGE_READ_ERROR
    for err in errors[:4]:
        print(err, file=sys.stderr)
    if len(errors) >= 4:
        print(f"... total of {len(errors)} errors", file=sys.stderr)

    if interrupt_received:
        print(f"\033[0m\033[{max(tsize.rows, 1)}B", file=sys.stderr)
        sys.stderr.flush()

    if args.verbose:
        _print_verbose_stats(tsize, geometry_width, geometry_height,
                             display, present, sequencer,
                             len(filelist), successful, duration, bg_color,
                             transport_base)
    return exit_code


def _resolve_auto_dither(loaded) -> str:
    """--dither=auto policy (measured-floor fallback, VERDICT r3 #2):
    libsixel is the reference-exact default, but its bucket-table
    kernel runs ~1,771 1080p frames/s/chip on v5e-1 (gather-bound; the
    15-bit lookup has no faster TPU formulation than one [64*b,128]
    lane-gather per wavefront step, see ops/sixel_pallas3.py).  When
    the session's first source is a video whose native rate exceeds
    that floor, resolve to the adaptive median-cut path instead.  One
    resolution per session keeps every frame byte-consistent."""
    import os

    try:
        floor = float(os.environ.get("TIMG_TPU_LIBSIXEL_FLOOR_FPS",
                                     "1700"))
    except ValueError:
        floor = 1700.0
    for fut in loaded:
        src = fut.result() if hasattr(fut, "result") else fut
        if src is None:
            continue
        fps = getattr(src, "_fps", None)
        if fps is not None and fps > floor:
            return "adaptive"
        return "libsixel"
    return "libsixel"


def _present_images(loaded, display, present, sequencer):
    """Twin of timg_tpu/cli.py:_present_images; ``--dither=auto``
    resolves with the JAX CLI's policy, so both CLIs pick the same mode
    for the same session."""
    from timg_tpu_torch.render.renderer import Renderer

    if (present.pixelation == Pixelation.SIXEL
            and present.sixel_dither == "auto"):
        present.sixel_dither = _resolve_auto_dither(loaded)
        display.sixel_batch_dither = present.sixel_dither

    canvas = _make_canvas(sequencer, display, present)
    renderer = Renderer.create(
        canvas, display, present.grid_cols, present.grid_rows,
        present.duration_between_images_ms, present.duration_for_row_ms)

    is_first = True
    valid = 0
    any_animations = False
    for future in loaded:
        if interrupt_received:
            break
        source = future.result()
        if source is None:
            continue
        valid += 1
        any_animations |= source.is_animation_before_frame_limit()
        _arm_signals(_interrupt_handler)
        if present.hide_cursor:
            canvas.cursor_off()
        if (present.clear_screen == ClearScreen.BEFORE_EACH_IMAGE
                or (present.clear_screen == ClearScreen.BEFORE_FIRST_IMAGE
                    and is_first)):
            canvas.clear_screen()
        source.send_frames(
            present.duration_per_image_ms, present.loops,
            lambda: interrupt_received,
            renderer.render_cb(source.format_title(display.title_format)))
        if present.hide_cursor:
            canvas.cursor_on()
        _arm_signals(signal.SIG_DFL)
        renderer.maybe_wait_between_image_sources()
        is_first = False
    renderer.finish()
    canvas.close()
    sequencer.flush()
    return valid, any_animations


def _make_canvas(sequencer, display, present):
    """The port's sixel canvas with a compression pool sized
    queue_len + 1, or its unicode block canvas, like
    timg_tpu/cli.py:_make_canvas."""
    if present.pixelation == Pixelation.SIXEL:
        from timg_tpu_torch.render.sixel_render import SixelCanvas

        return SixelCanvas(sequencer, present.sixel_options, display,
                           dither=present.sixel_dither,
                           executor=ThreadPoolExecutor(
                               max_workers=sequencer.max_queue_len + 1))
    from timg_tpu_torch.render.ansi import UnicodeBlockCanvas

    return UnicodeBlockCanvas(
        sequencer,
        use_quarter=(present.pixelation == Pixelation.QUARTER_BLOCK),
        use_upper_half_block=present.terminal_use_upper_block,
        use_256_color=present.use_256_color,
    )


def _print_verbose_stats(tsize, gw, gh, display, present, sequencer,
                         n_files, successful, duration, bg_color,
                         transport_base=None):
    """ref timg.cc:1007-1104."""
    err = sys.stderr
    print(f"Terminal cells: {tsize.cols}x{tsize.rows}  "
          f"cell-pixels: {tsize.font_width_px}x{tsize.font_height_px}", file=err)
    print(f"Active Geometry: {gw}x{gh}", file=err)
    pix_extra = ""
    if present.pixelation == Pixelation.SIXEL:
        so = present.sixel_options
        pix_extra = (" (%s and %s)" % (
            "with cursor placement workaround"
            if so.known_broken_cursor_placement
            else "with default cursor placement",
            "full cursor cell jump" if so.full_cell_jump
            else "default cursor cell jump"))
    elif present.pixelation == Pixelation.KITTY and present.tmux_workaround:
        pix_extra = " (with tmux workaround)"
    print(f"Effective pixelation: Using {present.pixelation.value}"
          f"{pix_extra}.", file=err)
    print(f"Background color for transparency '{bg_color}'", file=err)
    if display.bg_pattern_color[3] == 0xFF:
        c = display.bg_pattern_color
        print(f"\t-> Checker pattern color RGB "
              f"#{c[0]:02x}{c[1]:02x}{c[2]:02x}", file=err)
    if display.local_alpha_handling:
        print("Alpha-channel merging with background color done by timg.",
              file=err)
    else:
        print("Alpha-channel handled by terminal.", file=err)
    written = sequencer.bytes_total - sequencer.bytes_skipped
    rate = utils.human_readable_byte_value(
        written / duration if duration > 0 else 0)
    print(f"{n_files} file{'s' if n_files != 1 else ''} "
          f"({successful} successful); "
          f"{utils.human_readable_byte_value(written)} written "
          f"({rate}/s) {sequencer.frames_total} frames", file=err)
    if n_files == 1 and sequencer.frames_total > 50 and duration > 0:
        print(f"; {sequencer.frames_total / duration:.1f}fps", file=err)
    # TPU-native extra: device->host transport accounting for sustained
    # sixel sessions (ops/sixel_runs.py). Printed only when the device
    # transport actually moved frames, so one-shot/reference-shaped runs
    # keep the reference's exact verbose text above.
    try:
        from timg_tpu_torch.ops.sixel_runs import STATS as _ts
        base = transport_base or {k: 0 for k in _ts}
        d = {k: _ts[k] - base.get(k, 0) for k in _ts}
        if d["frames_runs"] + d["frames_plane"] > 0:
            shipped = utils.human_readable_byte_value(d["bytes_shipped"])
            equiv = utils.human_readable_byte_value(d["bytes_plane_equiv"])
            ratio = (d["bytes_plane_equiv"] / d["bytes_shipped"]
                     if d["bytes_shipped"] else 0.0)
            print(f"Device->host sixel transport: {d['frames_runs']} "
                  f"frame(s) as run records, {d['frames_plane']} as "
                  f"planes; {shipped} shipped vs {equiv} plane-equivalent "
                  f"({ratio:.1f}x)", file=err)
    except Exception:
        pass
    for env in ("TIMG_PIXELATION", "TIMG_DEFAULT_TITLE",
                "TIMG_ALLOW_FRAME_SKIP", "TIMG_USE_UPPER_BLOCK",
                "TIMG_FONT_WIDTH_CORRECT", "TIMG_SIXEL_NEWLINE_WORKAROUND"):
        value = os.environ.get(env)
        shown = f' = "{value}"' if value else "   (not set)"
        print(f" {env:<29s}{shown}", file=err)


if __name__ == "__main__":
    sys.exit(main())
