"""Command-line flag table (shared by cli.py and fast.py).

Split from cli.py so the one-shot fastpath (fast.py) can parse argv
without importing the full session-orchestration module. Flag surface
parity: ref src/timg.cc:495-524 (getopt long-option table).
"""

from __future__ import annotations

import argparse

#: Marker value for a getopt optional_argument flag given bare.
_BARE = "\x00"

#: Long flags that are optional_argument in the reference's getopt
#: table (timg.cc:495-519): they take a value ONLY when attached with
#: '='; a separate following token is never consumed (it stays a
#: filename -- `timg --title photo.png` shows photo.png with a title).
_OPTIONAL_ATTACHED = ("--auto-crop", "--clear", "--compress", "--loops",
                      "--scroll", "--title", "--upscale")

# Sentinel for a not-initialized command-line value (options.py
# NOT_INITIALIZED; duplicated here so parsing stays import-light).
_NOT_INITIALIZED = -(2 ** 31)


def _getopt_optional_args(argv):
    """Rewrite bare optional_argument flags to an attached marker so
    argparse's nargs='?' cannot consume the next positional."""
    return [a + "=" + _BARE if a in _OPTIONAL_ATTACHED else a
            for a in argv]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="timg-tpu", add_help=False,
        description="A TPU-accelerated terminal image and video viewer.")
    # optional_argument flags collect every occurrence (action=append)
    # so order-dependent getopt semantics (e.g. --title toggling) work.
    _opt = dict(nargs="?", const=_BARE, type=str, default=None,
                action="append")
    p.add_argument("-p", "--pixelation", type=str, default=None)
    p.add_argument("--grid", type=str, default=None)
    p.add_argument("-C", "--center", action="store_true")
    p.add_argument("--title", **_opt)
    p.add_argument("-f", dest="filelist", action="append", default=[])
    p.add_argument("-F", dest="filelist_rel", action="append", default=[])
    p.add_argument("-b", dest="bg_color", type=str, default="auto")
    p.add_argument("-B", dest="bg_pattern_color", type=str, default=None)
    p.add_argument("--pattern-size", type=int, default=1)
    p.add_argument("--auto-crop", **_opt)
    p.add_argument("--rotate", type=str, default="exif")
    p.add_argument("-W", "--fit-width", action="store_true")
    # -U is a plain no-argument toggle in the reference optstring
    # (timg.cc:523 'U', :641-650: each occurrence flips upscale);
    # only --upscale[=i] carries a value.
    p.add_argument("-U", dest="upscale_short", action="count", default=0)
    p.add_argument("--upscale", **_opt)
    p.add_argument("--clear", **_opt)
    p.add_argument("-V", dest="video_only", action="store_true")
    p.add_argument("-I", dest="image_only", action="store_true")
    p.add_argument("-w", dest="wait", type=str, default=None)
    p.add_argument("-a", dest="no_antialias", action="store_true")
    p.add_argument("-g", dest="geometry", type=str, default=None)
    p.add_argument("-o", dest="outfile", type=str, default=None)
    p.add_argument("-E", dest="no_hide_cursor", action="store_true")
    p.add_argument("--compress", **_opt)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--color8", action="store_true")
    p.add_argument("--version", action="store_true")
    p.add_argument("--verbose", action="store_true")
    # `-v` sits in the reference's optstring (timg.cc:523) but no
    # switch case handles it: accepted and silently ignored.
    p.add_argument("-v", action="store_true", dest="_v_ignored",
                   help=argparse.SUPPRESS)
    p.add_argument("-h", dest="short_help", action="store_true")
    p.add_argument("--help", dest="long_help", action="store_true")
    p.add_argument("--scroll", **_opt)
    p.add_argument("-d", "--delta-move", type=str, default=None)
    # -c is required_argument in the optstring ('c:'); argparse's
    # nargs='?' consumes the separate token for the short form, which
    # matches, while the long form is pre-rewritten when bare.
    p.add_argument("--loops", "-c", **_opt)
    p.add_argument("--frames", type=int, default=_NOT_INITIALIZED)
    p.add_argument("--frame-offset", type=int, default=0)
    p.add_argument("-t", dest="duration", type=float, default=None)
    p.add_argument("--debug-no-frame-delay", action="store_true")
    # timg-tpu extension: sixel quantization strategy (default
    # "libsixel", the reference's pipeline class).  "libsixel" =
    # faithful reimplementation of libsixel's quant.c
    # (ref sixel-canvas.cc:134-148): stills run the exact cached
    # quantizer on host; video/animation windows run the per-frame
    # palette + bucket-table integer FS on device (see
    # ops/libsixel_quant.py for the one documented deviation).
    # "adaptive" = per-animation median-cut tree palette; "cube" =
    # fixed 6x7x6 palette, arithmetic quantizer (fastest video path).
    # "auto" resolves per session: libsixel (the reference-exact mode)
    # unless the first source is a video whose native fps exceeds the
    # libsixel device floor (TIMG_TPU_LIBSIXEL_FLOOR_FPS, default 1700
    # -- the measured v5e-1 rate of the bucket-table kernel), in which
    # case the faster adaptive median-cut path plays it.
    p.add_argument("--dither",
                   choices=["adaptive", "cube", "libsixel", "auto"],
                   default="libsixel")
    # timg-tpu extension: video frame resampling. "auto" (default) =
    # device pipeline (raw YUV planes to the TPU, BT.601 + lean MXU
    # resize on device); "sws" = host swscale SWS_BILINEAR straight to
    # display size in one call -- the reference's exact video leg (ref
    # video-source.cc:59-89 + :352-354), byte-matching a full reference
    # build linked against the same libswscale; "sws-bitexact" = the
    # same algorithm as a DEVICE kernel with SWS_BITEXACT semantics
    # (ops/sws_resize.py), keeping the 1.5 B/px YUV transport while
    # producing libswscale's platform-independent bytes.
    p.add_argument("--resample", choices=["auto", "sws", "sws-bitexact"],
                   default="auto")
    # timg-tpu extension: shard sustained frame-batch dispatches (video
    # windows, animations, batched dither planes) over N chips of a
    # ('data',) jax mesh; "auto" = all visible devices. Default 1.
    p.add_argument("--devices", type=str, default=None)
    # timg-tpu extension: resident session server (unix socket at
    # TIMG_TPU_SERVE_SOCKET / $XDG_RUNTIME_DIR/timg-tpu.sock) keeping
    # the jax session + compile cache warm; one-shot clients delegate
    # to it and pay a socket round-trip instead of process boot.
    p.add_argument("--serve", action="store_true")
    p.add_argument("files", nargs="*")
    return p
