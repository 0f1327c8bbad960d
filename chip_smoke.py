#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (timg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++; exits non-zero without them.  Imports
only the port (timg_tpu_torch), never jax or the JAX package.  Phases:

1. set-up: print the card (nvidia-smi name and power limit), build the
   CUDA kernels from timg_tpu_torch/csrc/ (one nvcc per source, in
   parallel) and, beside them, the port's native helper from
   timg_tpu_torch/native/ (g++: the C sixel assembler, which must build,
   and the libav video decoder, which builds only where libav exists);
   print which deflate the PNG writer loaded (libdeflate or the zlib
   fallback);
2. kernels: a seeded window of 32 frames of 1080p 4:2:0 video, converted
   on the card by the convert kernel (byte-equal to its plain version in
   both ranges, timed at 32 and at the CLI's 8 frames, split by
   torch.profiler); the same planes through the swscale-exact kernel of
   --resample=sws-bitexact (byte-equal to its plain version in both
   ranges into 720x1280 at 32 and at 8 frames, into 720x1279, the
   full-chroma path, and at 1080x1920, the unscaled converter; timed by
   CUDA events and in a CUDA graph beside its byte and operation bounds
   and the plain version); the converted words resized to 720x1280 by
   the resize kernel (also
   timed at the CLI's 8-frame window, split by torch.profiler, and checked
   and timed on 8 seeded frames of 2160x3840, which the two-pass route
   also resizes into 16x28 pixels, a geometry no fused tile fits, split by
   torch.profiler into its two passes beside the band matmuls), then
   dithered at 720 rows and at 722 rows padded to 726 with background rows
   by each dither kernel: FS cube on words (K6) and on bytes (K9, 3 and 4
   channels); libsixel (per-frame palettes from the host, with one flat
   frame whose diffuse flag is 0, the bucket-table build, also timed at 8
   frames, and the table dither); and the
   median-cut tree on words (K7) and on bytes; the block kernels
   (quarter and half cells with the window diff) at 720 rows and at 719
   (odd: the blank pad row), with and without a tail, use_upper both
   ways, and at the CLI's block geometry (1080p into -g160x48, B=8);
   quarter cells also on a seeded noise and a flat window of 720x1280
   words, B=32, each timed beside the bound of the operations its
   scan needs; the four transport kernels (run counts a band, the run
   compaction, the DCS band lengths and the DCS emission) on the cube
   dither's 720x1280 index planes at B=32 and B=8, the compaction beside
   torch.masked_select and also on flat planes it does not truncate;
   then, per transport (plane, runs, DCS forced, and the default auto),
   the device->host and host legs of an 8-frame window of flat,
   film-like and noise index planes, whose streams must be equal.
   The wavefront driver is
   also checked and timed at the batches the main paths launch besides 32:
   K6, K7 and K8 at the CLI's 8-frame window, K9 and the byte tree at one
   frame (the library's per-frame loop), and K6, K7 and K8 on 32 rows (one
   warp alone), each with its time a serial step. Each kernel must equal
   its plain PyTorch version byte for byte (the resize's on CPU copies,
   the others' on the card); all are timed with CUDA events over
   back-to-back calls (the bucket build, shorter than its launch on the
   host, also around a CUDA graph of calls) beside their bound (bytes
   over 3.35 TB/s or float instructions over 33.45 T/s, the bucket
   build's and K8's integer operations over 16.7 T/s, whichever is
   larger) and, where one PyTorch call computes the same function, that
   call's time;
3. video main path: 1080p windows through the port's VideoSource window
   (convert -> resize -> dither on the card -> plane fetch ->
   SixelCanvas assembly), as the CLI runs `-g160x48 -ps --dither=MODE
   -b black` on a terminal with 8x16-pixel cells: two 8-frame windows
   with cube, one with libsixel and one with adaptive; then the block
   window (convert -> resize -> block cells and window diff on the card
   -> plane fetch -> UnicodeBlockCanvas), as `-g160x48 -pq|-ph -b
   black` runs it: two 8-frame windows each of quarter and half blocks,
   so the second window's first frame diffs against the first's tail;
   each block mode then runs again, split into its legs a window
   (planes, H2D, convert and resize, cells, the one fetch, emit), and
   must write the same stream.  Each sixel mode (whose default
   transport, auto, counts the runs first) then runs one 8-frame window
   of flat frames (black, a moving white block, a narrow grey ramp)
   under TIMG_TPU_SIXEL_TRANSPORT=plane, runs and dcs: each transport
   must carry all 8 frames (STATS) through its kernels and write the
   plane's stream.  Then two 8-frame windows each of kitty and iTerm2
   (convert -> resize on the card -> each frame fetched lazily in the
   canvas's compression pool -> PNG on the host), as `-g160x48 -pk|-pi
   -b black` runs them (again, once the CPU children are done, split
   into their legs a window: planes, H2D, convert and resize, the
   fetches and the PNGs summed over the pool's workers), and one window
   each of cube sixel, quarter blocks and kitty with
   --resample=sws-bitexact (the sws kernel in place of the convert and
   the resize, which must not launch).  Each mode's stream must equal
   the same windows run with TIMG_TPU_TORCH_DEVICE=cpu in a subprocess
   (kitty ids pinned in both).  Then the RGBA and scaled video windows
   (VideoSource._process_window, as -g160x48 -b black -B gray runs
   them): two 8-frame windows of seeded 1080p RGBA frames in cube,
   libsixel, adaptive, quarter, half and kitty, once as an opaque
   codec's (the lean resize, K1, on RGBA words; the background must
   never be asked for) and once as a transparent-capable file's with an
   alpha ramp and a transparent band (the stb resize, the one-scalar
   probe, the background and the compose; K1 must not launch); then one
   window of display-size frames (--resample=sws's host swscale) in
   cube and quarter, each split into its legs (stack + H2D + fetch,
   resize, probe and compose, primers, emit; host clock and CUDA
   events); each stream must equal its CPU child's;
4. library path: timg_tpu_torch.models.get("sixel") at 720x1280 on 8
   seeded 1080p RGBA frames with a transparent region (bg opaque black),
   in cube, adaptive (a tree per frame) and adaptive with
   adaptive_reuse, and render_batch_yuv on 8 frames of 1080p 4:2:0 in
   cube; the quarter model at 96x320 and the half model at 96x160, and
   the kitty and iterm2 models at 720x1280, on the same RGBA frames.
   The payload lists must equal a CPU subprocess's; the stage times of
   the cube run are printed;
5. stills: the port's CLI in this process, as a user runs it at
   -g160x48 on a pty of 8x16-pixel cells, on files made with PIL from
   the seed: a 4032x3024 photo-like JPEG in each dither, -pq and -ph,
   with --auto-crop and -a; a 1920x1080 RGBA PNG with an alpha ramp and
   a transparent region in blocks with -b none and in cube with a
   checkerboard; a 24-frame GIF in libsixel and -pq; eight 1080p PNGs
   in --grid=4x2, cube and -pq; a 3840x1080 panorama scrolled for two
   windows in libsixel; a 1021x767 still in each forced transport; in
   -pk and -pi the JPEG, the alpha PNG with -b none and with the
   checkerboard, the GIF in -pk (the flip-flop ids) and the grid in
   -pi (kitty ids pinned before every run); the decoders beside Pillow
   and QOI, each in -pq and -ps on files written from the seed: a
   Radiance HDR, a 10-bit DPX, an XWD, a MIFF, a two-layer XCF, a text
   page, and where the host has their library an SVG (librsvg), a
   Letter PDF (poppler-glib) and the page in PostScript (gs); which of
   those libraries the host has is printed.  Each stream must equal the
   same run on the CPU in a child; then the photo's time to first frame
   in libsixel, cube and -pk (the whole run, and by legs), a fresh
   process's start, and the still path's torch ops (stb resize,
   compose, trim bounds, nearest, scroll) by CUDA events beside their
   byte bound.

6. serve: `timg-tpu-torch --serve` on the card on a socket in the
   stills' temp dir, reached by the launcher on a pty: the photo in
   -pq, libsixel and -pk and the HDR in -pq, each equal to the stills
   phase's CPU child (kitty ids renamed to the pinned ones); the cold
   launcher, the first served request and the median of 5 warm ones,
   beside the launcher's own start; a TIMG_TPU_TORCH_DEVICE=cpu
   request answered D on the socket and run by the launcher on the CPU
   with the same bytes; SIGTERM, after which the socket is gone; then
   the serve loop in this process, the caching allocator read after
   each of 6 requests, which must not grow after the second;
7. devices: with two cards or more, --devices N over them; with one,
   the routing's device list cuda:0 four times: an 8-frame window in
   cube, libsixel, adaptive, quarter, kitty and cube sws through the
   sharded window against one card (each kernel of the mode launched,
   each shard's card printed, both times), the photo in -pq and -pk and
   a 2560x2048 PNG (the spatial route) through the CLI with --devices
   against the one-card streams, and parallel/mesh.py's two pipelines
   against the unsharded ops.  `chip_smoke.py --devices-only` runs this
   phase alone (on a host of four cards).

Before each run of phases 3 to 5 and 7 every launch counter is set to
0, and just after it every kernel of that run must have launched.  The C
assembler must have assembled every sixel frame and the C ANSI emitter
written every block frame (the Python twins none).  The CLI itself is
not driven where the video decoder does not build.

Output: progress lines, then one JSON line of per-kernel results, the
card's nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
IN_H, IN_W = 1080, 1920
OUT_H, OUT_W = 720, 1280
N_KERNEL = 32           # frames in the kernel phase's window
N_WINDOW = 8            # frames in the CLI's video window
H_4K, W_4K = 2160, 3840  # 4K-class input of the resize check
PASS_H, PASS_W = 16, 28  # 4K into this many pixels takes the two passes
WARP_ROWS = 32          # rows of one warp of the f32 dither
# frames through the main path per mode (8-frame windows): the sixel
# dithers, quarter and half blocks, kitty and iTerm2, then one window
# each with --resample=sws-bitexact (a mode's name ends in " sws")
N_MAIN = {"cube": 16, "libsixel": 8, "adaptive": 8, "quarter": 16,
          "half": 16, "kitty": 16, "iterm2": 16, "cube sws": 8,
          "quarter sws": 8, "kitty sws": 8}
# the RGBA and scaled video windows: 1080p RGBA frames (an opaque
# codec's, and a transparent-capable file's with an alpha ramp and a
# transparent band) in two 8-frame windows of each mode, and one window
# of display-size frames (--resample=sws) in a sixel and a block mode;
# run name -> (mode, frames, content)
RGBA_MODES = ("cube", "libsixel", "adaptive", "quarter", "half", "kitty")
RGBA_RUNS = {f"{mode} {content}": (mode, n, content)
             for content, modes, n in (("rgba", RGBA_MODES, 16),
                                       ("rgba alpha", RGBA_MODES, 16),
                                       ("scaled", ("cube", "quarter"), 8))
             for mode in modes}
# a mode's kernels on frames that arrive as RGBA (no convert); the
# opaque codec's window adds the lean resize (K1)
RGBA_KERNELS = {"cube": ("dither",), "libsixel": ("bucket", "table"),
                "adaptive": ("tree",), "quarter": ("quarter_cells",),
                "half": ("half_cells",), "kitty": ()}
BG_QUERIES = [0]            # calls of the background getter in a run
PIXEL_MODES = ("kitty", "iterm2")
# the escape that opens each image of a pixel mode's stream
PIXEL_HEADS = {"kitty": b"\033_Ga=T", "iterm2": b"\033]1337;File="}
KITTY_ID_START = 400000     # kitty ids pinned before every run
# the block modes' cells in pixels and the CLI's width_stretch (a
# terminal whose cell size is unknown: 1.0, doubled for quarter blocks)
BLOCK_MODES = {"quarter": (2, 2.0), "half": (1, 1.0)}
GRID_W, GRID_H = 160, 48    # -g160x48
BG_WORD = -(1 << 24)    # opaque black RGBA word, as -b black pads rows
# integer operations the sws function needs (ops/sws_resize.py, counted
# from its arithmetic, one IMAD a tap): each 15-bit intermediate once (a
# source row's taps at each output column of its plane), each output
# row's vertical taps, then about 31 a pixel for the rounding, the
# pair's chroma offsets, the three table lookups and the pack
SWS_CONVERT_OPS_PER_PX = 31
N_LIB = 8               # frames a library-path run renders
# library-path runs: name -> (dither, adaptive_reuse, input)
LIB_RUNS = {"cube": ("cube", False, "rgba"),
            "adaptive": ("adaptive", False, "rgba"),
            "adaptive_reuse": ("adaptive", True, "rgba"),
            "yuv": ("cube", False, "yuv"),
            "quarter": (None, False, "rgba"),
            "half": (None, False, "rgba"),
            "kitty": (None, False, "rgba"),
            "iterm2": (None, False, "rgba")}
# the block models' output pixels (the library's -g160x48 canvas)
LIB_BLOCK_SIZE = {"quarter": (96, 320), "half": (96, 160)}
# the sixel modes run again on flat windows in each forced transport
SIXEL_MODES = ("cube", "libsixel", "adaptive")
TRANSPORTS = ("plane", "runs", "dcs")
N_FLAT = 8              # frames of a transport run (one CLI window)
# kernels a transport launches, beyond its mode's (the default, auto,
# always counts the runs first)
TRANSPORT_KERNELS = {"plane": (), "runs": ("run_counts", "compact_runs"),
                     "dcs": ("dcs_lens", "dcs_emit"),
                     "auto": ("run_counts",)}
# integer operations the transport functions need (not what the kernels
# of csrc/sixel_runs.cu and csrc/sixel_dcs.cu spend): a band's column
# words and their compare with the column before, 12 a column; for the
# DCS, a pixel's presence bit and its colour's mask bit (2 a pixel, one
# scatter builds every colour's mask row), then for each listed colour
# and column the start compare and the byte count (3); one store a body
# byte
RUN_OPS_PER_COLUMN = 12
DCS_OPS_PER_PX = 2
DCS_OPS_PER_COLOUR_COLUMN = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# float32 instructions outside the tensor cores: 128 lanes an SM x 132
# SMs x 1.98 GHz (the data sheet's 67 TFLOP/s counts an FMA as two
# operations; the kernels contract no product and sum, so each counted
# operation is one instruction, an FMA where one is written one too)
F32_ISSUE_PER_S = 132 * 128 * 1.98e9
# int32 min/max and the table dither's (K8) integer work: 64 lanes an SM
# (half the f32 rate) x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# operations a pixel of each dither kernel, counted from
# csrc/fs_dither_cube.cu.  f32 policy: the row-above mix (15), the
# incoming sum and clip (15), the error (3) and the quantizer (cube: 18
# with the index; tree: 3 roundings, 8 levels of 4, the leaf unpack 3 =
# 38).  Integer policy with the table (K8): four truncated shares with
# clamps a channel (60), the key (5), the color unpack and offsets (6),
# the row-above offsets (12).
CUBE_OPS_PER_PX = 51
TREE_OPS_PER_PX = 71
TABLE_OPS_PER_PX = 83
# float operations of the quarter kernel (csrc/block_cells.cu), each one
# instruction, compares included: a cell's fixed part (the 4 linear
# colors with alpha 28, their total 12, the chosen candidate's sums 16,
# two repacks of 4 divisions of 3 and 3 roots of 6: 60) and each
# candidate's cost with the scan's two compares, counted only up to where
# the scan stops (0: the average and avd4, 40; 1-4: avd3 with its
# divisions, 40; 5-7: two pair distances, 20).  Half cells do no float
# math (word compares).
QUARTER_CELL_OPS = 116
QUARTER_CANDIDATE_OPS = (40, 40, 40, 40, 40, 20, 20, 20)
# bytes a cell: its words in (read once), glyph, fg, bg and eq out
QUARTER_BYTES_PER_CELL = 16 + 10
HALF_BYTES_PER_CELL = 8 + 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def yuv_frames(n: int, seed: int, h: int = IN_H, w: int = IN_W):
    """Seeded 4:2:0 planes (1080p unless given): moving gradients plus a
    noise band, so both smooth areas and every dither state occur."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ch, cw = h // 2, w // 2
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = np.mgrid[0:ch, 0:cw]
    ys = np.empty((n, h, w), np.uint8)
    us = np.empty((n, ch, cw), np.uint8)
    vs = np.empty((n, ch, cw), np.uint8)
    for i in range(n):
        base = 16 + (xx * 180 // w + yy * 40 // h + 7 * i) % 220
        noise = rng.integers(0, 24, (h, w))
        band = slice(h // 3, h // 2)
        noise[band] = rng.integers(0, 256, (h // 2 - h // 3, w))
        ys[i] = np.clip(base + noise - 12, 0, 255)
        us[i] = 64 + (cx * 128 // cw + 3 * i) % 128
        vs[i] = np.clip(60 + cy * 140 // ch
                        + rng.integers(0, 16, (ch, cw)), 0, 255)
    return ys, us, vs


def flat_yuv_frames(n: int):
    """4:2:0 planes that every transport carries: black (Y 16) with a
    white (Y 235) block moving 40 pixels a frame and a grey ramp (Y 100
    to 140) across a strip of 108 rows, neutral chroma.  Black and white
    are palette colours in every dither mode and the ramp holds few
    greys, so a band holds few colours (DCS) and few column runs (runs)."""
    import numpy as np

    ys = np.full((n, IN_H, IN_W), 16, np.uint8)
    ramp = (100 + np.arange(IN_W) * 40 // (IN_W - 1)).astype(np.uint8)
    for i in range(n):
        ys[i, 540:648] = ramp
        ys[i, 120:420, 200 + 40 * i:800 + 40 * i] = 235
    us = np.full((n, IN_H // 2, IN_W // 2), 128, np.uint8)
    return ys, us, us.copy()


@functools.lru_cache(maxsize=2)
def video_rgba_frames(n: int, seed: int, alpha: bool, h: int = IN_H,
                      w: int = IN_W):
    """Seeded RGBA frames as the video helper's swscale hands them over
    (1080p unless given): gradients plus noise; with ``alpha``, alpha
    falling from 254 to 0 across a moving box and a fully transparent
    band, as an APNG or a GIF carries them.  Made once for the runs of
    every mode (read only)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w, 4), np.uint8)
    for i in range(n):
        for c in range(3):
            out[i, ..., c] = (xx * (70 + 40 * c) // w + yy * (80 - 20 * c)
                              // h + 19 * i + 30 * c
                              + rng.integers(0, 28, (h, w))) % 256
        out[i, ..., 3] = 255
        if alpha:
            bh, bw = h // 2, w // 3
            y0, x0 = h // 8 + 5 * i, w // 8 + 9 * i
            out[i, y0:y0 + bh, x0:x0 + bw, 3] = np.linspace(
                254, 0, bw).astype(np.uint8)[None, :]
            out[i, h - h // 6:, :, 3] = 0
    return out


def block_options(mode: str):
    """The CLI's display options for ``-g160x48 -p quarter|half``."""
    from timg_tpu_torch.options import DisplayOptions

    opts = DisplayOptions()
    cell_x, stretch = BLOCK_MODES[mode]
    opts.cell_x_px, opts.cell_y_px = cell_x, 2
    opts.width_stretch = stretch
    opts.width, opts.height = GRID_W * cell_x, GRID_H * 2
    return opts


BLOCK_LEGS = ("planes", "h2d", "convert_resize", "cells", "fetch", "emit")


@contextlib.contextmanager
def timed_block_legs(legs: dict):
    """While open, the block window's device legs add their host-clock
    seconds (synchronized before and after) to ``legs``: "h2d" (the
    planes' copies in stage_window), "convert_resize" (VideoStage),
    "cells" (the block kernel) and "fetch" (cells_to_host)."""
    import torch

    from timg_tpu_torch.ops import blocks
    from timg_tpu_torch.render import plane_cache

    def timed(keys, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            for key, sign in keys:
                legs[key] += sign * (time.perf_counter() - t0)
            return out
        return run

    patches = [  # stage_window less its VideoStage is the H2D
        (plane_cache, "stage_window", [("h2d", 1)]),
        (plane_cache.VideoStage, "forward", [("convert_resize", 1),
                                             ("h2d", -1)]),
        (blocks, "quarter_cells", [("cells", 1)]),
        (blocks, "half_cells", [("cells", 1)]),
        (blocks, "cells_to_host", [("fetch", 1)])]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, keys in patches:
        setattr(owner, attr, timed(keys, getattr(owner, attr)))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


PIXEL_LEGS = ("planes", "h2d", "convert_resize", "fetch", "png")


@contextlib.contextmanager
def timed_pixel_legs(legs: dict):
    """While open, the pixel window's legs add their seconds to
    ``legs``: "h2d" and "convert_resize" as ``timed_block_legs`` times
    them (host clock, synchronized), "fetch" (each frame's device->host
    copy, DeviceFrame.__array__) and "png" (the Sub filter and the
    deflate) summed over the compression pool's workers."""
    import threading

    from timg_tpu_torch.render import plane_cache, png, png_core

    lock = threading.Lock()

    def summed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            with lock:
                legs[key] += time.perf_counter() - t0
            return out
        return run

    patches = [(plane_cache.DeviceFrame, "__array__", "fetch"),
               (png, "sub_filter_rows", "png"),
               (png_core, "zlib_compress", "png")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, key in patches:
        setattr(owner, attr, summed(key, getattr(owner, attr)))
    try:
        with timed_block_legs(legs):
            yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


RGBA_LEGS = ("frames", "stack", "h2d", "resize", "probe_compose", "fetch",
             "primers", "emit")
# the RGBA window's legs in the order it runs them, each the span between
# two marks of timed_rgba_legs ("device in": the first step on the card,
# the resize, or the probe where the frames come at display size)
RGBA_SPANS = {"stack": ("window in", "stack out"),
              "h2d": ("stack out", "device in"),
              "resize": ("_resize in", "_resize out"),
              "probe_compose": ("_composed in", "_composed out"),
              "fetch": ("_composed out", "_prime_and_list in"),
              "primers": ("_prime_and_list in", "_prime_and_list out")}


@contextlib.contextmanager
def timed_rgba_legs(legs: dict):
    """While open, the RGBA and scaled windows' legs add their seconds to
    ``legs`` on the host clock (synchronized at each mark) and by CUDA
    events (key + " events"): "stack" (np.stack of the window's frames
    on the host), "h2d" (torch.from_numpy and the copy to the card),
    "resize" (VideoSource._resize: K1 or the stb resize), "probe_compose"
    (VideoSource._composed: the one-scalar probe and, where a pixel is
    transparent, the background and the compose), "fetch" (the one
    copy of the frames to the host for the canvas) and "primers" (the
    block or sixel primers on the resident frames)."""
    import numpy as np
    import torch

    from timg_tpu_torch.sources import video_source

    marks = {}

    def mark(name):
        torch.cuda.synchronize()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks[name] = (time.perf_counter(), event)

    def marked(name, fn):
        def run(*args, **kwargs):
            mark(name + " in")
            out = fn(*args, **kwargs)
            mark(name + " out")
            return out
        return run

    def window(fn):
        def run(*args, **kwargs):
            marks.clear()
            out = marked("window", fn)(*args, **kwargs)
            marks["device in"] = marks.get("_resize in",
                                           marks["_composed in"])
            for key, (a, b) in RGBA_SPANS.items():
                if a in marks and b in marks:   # "scaled": no resize
                    (t0, e0), (t1, e1) = marks[a], marks[b]
                    legs[key] += t1 - t0
                    legs[key + " events"] += e0.elapsed_time(e1) / 1e3
            return out
        return run

    class TimedNumpy:       # the window's np.stack ends the "stack" leg
        def __getattr__(self, attr):
            return getattr(np, attr)

        @staticmethod
        def stack(*args, **kwargs):
            out = np.stack(*args, **kwargs)
            mark("stack out")
            return out

    cls = video_source.VideoSource
    attrs = ("_process_window", "_resize", "_composed", "_prime_and_list")
    saved = {attr: getattr(cls, attr) for attr in attrs}
    for key in RGBA_SPANS:
        legs.setdefault(key + " events", 0.0)
    cls._process_window = window(saved["_process_window"])
    for attr in attrs[1:]:
        setattr(cls, attr, marked(attr, saved[attr]))
    video_source.np = TimedNumpy()
    try:
        yield
    finally:
        video_source.np = np
        for attr, fn in saved.items():
            setattr(cls, attr, fn)


def print_legs(mode: str, legs: list) -> None:
    pixel = mode.split(" ")[0] in PIXEL_MODES
    rgba = mode.endswith(("rgba", "rgba alpha", "scaled"))
    for k, leg in enumerate(legs):
        if rgba:
            spans = [key for key in RGBA_SPANS
                     if key != "resize" or not mode.endswith("scaled")]
            print(f"main path: {mode} window {k} legs (host clock, "
                  f"synchronized at each leg: " + ", ".join(
                      f"{key} {leg[key] * 1e3:.3f} ms" for key in spans)
                  + "; CUDA events: " + ", ".join(
                      f"{key} {leg[key + ' events'] * 1e3:.3f} ms"
                      for key in spans if key != "stack")
                  + f"; frames {leg['frames'] * 1e3:.3f} ms, emit "
                  f"{leg['emit'] * 1e3:.3f} ms on the host clock"
                  + (", the pool's PNGs included" if pixel else "") + ")")
            continue
        print(f"main path: {mode} window {k} legs (host clock, synchronized"
              + ("; fetch and png summed over the pool's workers" if pixel
                 else "") + "): " + ", ".join(
                  f"{key} {leg[key] * 1e3:.3f} ms"
                  for key in (PIXEL_LEGS if pixel else BLOCK_LEGS)))


def pin_kitty_ids() -> None:
    """The kitty canvas's image ids are seeded from the clock: pin them
    before each run, in this process and in every CPU child alike."""
    from timg_tpu_torch.render import kitty

    kitty._id_start, kitty._id_counter = KITTY_ID_START, 0


def main_path_stream(mode: str, n: int, legs: list = None,
                     content: str = "seeded") -> bytes:
    """n frames through the port's video window, in 8-frame windows,
    dithered in ``mode`` into the port's SixelCanvas, in quarter or half
    blocks into its UnicodeBlockCanvas, or into its KittyCanvas or
    ITerm2Canvas (each with the CLI's compression pool); a mode ending
    in " sws" runs --resample=sws-bitexact.  ``content``: "seeded"
    (``yuv_frames``) or "flat" (``flat_yuv_frames``) 1080p 4:2:0 planes
    in "yuv" windows; "rgba" (an opaque codec's 1080p RGBA frames) or
    "rgba alpha" (a transparent-capable file's, ``video_rgba_frames``)
    in "rgba" windows; "scaled" (display-size RGBA frames, as
    --resample=sws's host swscale makes them) in "scaled" windows.  The
    RGBA contents run under -b black with a grey checkerboard (-B
    gray); BG_QUERIES counts the background getter's calls.  Returns the
    written stream.  Given a list ``legs`` in a block, pixel or RGBA
    run, appends each window's legs in seconds (BLOCK_LEGS, PIXEL_LEGS
    or RGBA_LEGS: the frames' or planes' making, a window's share;
    ``timed_block_legs``, ``timed_pixel_legs`` or ``timed_rgba_legs``;
    the canvas's emit of its frames)."""
    from concurrent.futures import ThreadPoolExecutor

    from timg_tpu_torch.colors import parse_color
    from timg_tpu_torch.geometry import calc_scale_to_fit
    from timg_tpu_torch.options import DisplayOptions, SixelOptions
    from timg_tpu_torch.render.ansi import UnicodeBlockCanvas
    from timg_tpu_torch.render.iterm2 import ITerm2Canvas
    from timg_tpu_torch.render.kitty import KittyCanvas
    from timg_tpu_torch.render.renderer import Renderer
    from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType
    from timg_tpu_torch.render.sixel_render import SixelCanvas
    from timg_tpu_torch.sources.video_source import _WINDOW, VideoSource

    base, _, resample = mode.partition(" ")
    rgba = content not in ("seeded", "flat")
    if base in BLOCK_MODES:
        opts = block_options(base)
    else:
        opts = DisplayOptions()
        opts.cell_x_px, opts.cell_y_px = 8, 16
        opts.width, opts.height = GRID_W * 8, GRID_H * 16   # -g160x48
        if base not in PIXEL_MODES:
            opts.sixel_batch_dither = base
    bg = parse_color("black")

    def bg_getter():
        BG_QUERIES[0] += 1
        return bg
    opts.bgcolor_getter = bg_getter
    if rgba:
        opts.bg_pattern_color = parse_color("gray")     # -B gray
    tw, th, _ = calc_scale_to_fit(IN_W, IN_H, opts)

    alpha = content == "rgba alpha"
    src = VideoSource("chip-smoke.png" if alpha else "chip-smoke.y4m")
    src._options = opts
    src._target = (tw, th)
    src._full_range = False
    src._sws_device = resample == "sws"
    src._transparent_suffix = alpha
    pin_kitty_ids()
    t0 = time.perf_counter()
    if content == "scaled":
        frames = video_rgba_frames(n, SEED + 7, False, th, tw)
    elif rgba:
        frames = video_rgba_frames(n, SEED + 5, alpha)
    else:
        ys, us, vs = (yuv_frames(n, SEED + 1) if content == "seeded"
                      else flat_yuv_frames(n))
    planes_s = (time.perf_counter() - t0) * _WINDOW / n
    timing = legs is not None and (base in (*BLOCK_MODES, *PIXEL_MODES)
                                   or rgba)
    if rgba:
        leg_names, timer, kind = RGBA_LEGS, timed_rgba_legs, (
            "scaled" if content == "scaled" else "rgba")
    elif base in PIXEL_MODES:
        leg_names, timer, kind = PIXEL_LEGS, timed_pixel_legs, "yuv"
    else:
        leg_names, timer, kind = BLOCK_LEGS, timed_block_legs, "yuv"

    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(max_workers=5) as pool:
        path = os.path.join(tmp, "stream.out")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        sequencer = BufferedWriteSequencer(
            fd, allow_frame_skipping=False, max_queue_len=4,
            debug_no_frame_delay=True, interrupt_flag=lambda: False)
        # the CLI's canvas: compression pool of queue_len + 1 workers
        if base in BLOCK_MODES:
            canvas = UnicodeBlockCanvas(sequencer,
                                        use_quarter=base == "quarter")
        elif base == "kitty":
            canvas = KittyCanvas(sequencer, False, opts, executor=pool)
        elif base == "iterm2":
            canvas = ITerm2Canvas(sequencer, opts, executor=pool)
        else:
            canvas = SixelCanvas(sequencer, SixelOptions(), opts,
                                 dither=base, executor=pool)
        sink = Renderer.create(canvas, opts, 1, 1, 0.0, 0.0).render_cb("")
        last_h = -1
        for k in range(0, n, _WINDOW):
            if rgba:
                window = [frames[i] for i in range(k, k + _WINDOW)]
            else:
                window = [(ys[i], us[i], vs[i])
                          for i in range(k, k + _WINDOW)]
            leg = dict.fromkeys(leg_names, 0.0)
            leg[leg_names[0]] = planes_s
            with (timer(leg) if timing else contextlib.nullcontext()):
                out = src._process_window(window, kind)
                t0 = time.perf_counter()
                for j, frame in enumerate(out):
                    seq = (SeqType.START_OF_ANIMATION if k + j == 0
                           else SeqType.ANIMATION_FRAME)
                    sink(src.indentation, -last_h if last_h > 0 else 0,
                         frame, seq, 40.0 * (k + j + 1))
                    last_h = frame.shape[0]
                if timing and base in PIXEL_MODES:
                    # the window's frames encoded: its fetches and PNGs
                    # counted in this window's legs
                    sequencer.flush()
                leg["emit"] = time.perf_counter() - t0
            if timing:
                legs.append(leg)
        canvas.close()
        sequencer.flush()
        sequencer.shutdown()
        os.close(fd)
        with open(path, "rb") as f:
            return f.read()


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()                                             # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time a call of fn, for a kernel shorter than its launch
    from Python (CUDA events over back-to-back calls would time the
    host): CUDA events around one replay of a CUDA graph of iters
    calls."""
    import torch

    fn()                                             # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                                   # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(a, b) -> int:
    """Largest absolute difference, per byte channel of RGBA words."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.int32:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return int((a.long() - b.long()).abs().max())


def bound(nbytes: float, nops: float, ops_per_s: float = F32_ISSUE_PER_S
          ) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over their peak rate (f32 unless
    given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def check_equal(what: str, got, want) -> int:
    """Fail unless byte-equal; return the max_abs_err (0)."""
    import torch

    got, want = got.cpu(), want.cpu()
    if not torch.equal(got, want):
        fail(f"{what}: kernel != plain in {int((got != want).sum())} "
             "elements")
    return max_abs_err(got, want)


def device_profile(fn, what: str) -> dict:
    """torch.profiler's device time of each kernel and copy in a call of
    fn, per call: the mean over the calls the profiler recorded of 3 (it
    may drop some); prints one line each and returns {name: ms}."""
    import torch

    fn()                                             # warm-up
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and not e.key.startswith("aten::"):   # an aten op's
            split[e.key] = us / max(e.count, 1) / 1000.0   # is its kernels'
    if not split:
        print(f"kernels: {what} profile: torch.profiler saw no device time")
    for key, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"kernels: {what} profile: {ms:.6f} ms a call of device time "
              f"in {key}")
    return split


def convert_phase(planes) -> tuple:
    """The convert kernel on the window's planes: byte-equal to its plain
    version (on the card) in both ranges, timed at B=32 and B=8 beside
    its byte bound and the plain chain, and split by torch.profiler,
    where it must show one kernel.  Returns (limited-range words,
    results)."""
    import torch

    from timg_tpu_torch.ops import yuv_kernel
    from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words_plain

    errs = []
    for full_range in (True, False):
        words = yuv_kernel.yuv420_to_rgba_words_cuda(*planes, full_range)
        torch.cuda.synchronize()
        errs.append(check_equal(
            f"yuv420_to_rgba_words (full_range={full_range})", words,
            yuv420_to_rgba_words_plain(*planes, full_range)))
    print(f"kernels: yuv420_to_rgba_words {IN_H}x{IN_W}, B={N_KERNEL}, both "
          "ranges: equal to plain")

    def nbytes(b):   # Y and both chroma planes in, the words out
        return b * (IN_H * IN_W * 5 + 2 * (IN_H // 2) * (IN_W // 2))

    r = dict(max_abs_err=max(errs),
             ms=cuda_ms(lambda: yuv_kernel.yuv420_to_rgba_words_cuda(
                 *planes, False), 20),
             plain_ms=cuda_ms(lambda: yuv420_to_rgba_words_plain(
                 *planes, False), 3),
             library_ms=None,     # no PyTorch call computes it
             **bound(nbytes(N_KERNEL), 0))
    window = [p[:N_WINDOW] for p in planes]
    ms = cuda_ms(lambda: yuv_kernel.yuv420_to_rgba_words_cuda(
        *window, False), 20)
    plain = cuda_ms(lambda: yuv420_to_rgba_words_plain(*window, False), 3)
    print(f"kernels: yuv420_to_rgba_words at the CLI's window, B={N_WINDOW}:"
          f" {ms:.6f} ms, plain {plain:.6f} ms, bound "
          f"{bound(nbytes(N_WINDOW), 0)['bound_ms']:.6f} ms (bytes)")
    n0 = yuv_kernel.LAUNCHES
    yuv_kernel.yuv420_to_rgba_words_cuda(*window, False)
    if yuv_kernel.LAUNCHES - n0 != 1:
        fail(f"the convert counted {yuv_kernel.LAUNCHES - n0} launches a "
             "call, not one")
    # the process's first profiling session, the one that reliably sees
    # device time on the card's machine: an empty split fails too
    split = device_profile(
        lambda: yuv_kernel.yuv420_to_rgba_words_cuda(*window, False),
        f"yuv420_to_rgba_words, B={N_WINDOW}")
    if len(split) != 1:
        fail(f"the convert ran {len(split)} device kernels a call, not one")
    return words, r


def sws_ops(plan, b: int) -> int:
    """Integer operations the swscale-exact function needs for b frames
    of ``plan``'s geometry (``SWS_CONVERT_OPS_PER_PX``'s count)."""
    fl, fc = plan.h_lum_coef.shape[1], plan.h_chr_coef.shape[1]
    if plan.unscaled:
        return b * plan.dst_h * plan.dst_w * SWS_CONVERT_OPS_PER_PX
    per = (plan.src_h * plan.dst_w * fl
           + plan.dst_h * plan.dst_w * plan.v_lum_size
           + 2 * (plan.chr_src_h * plan.chr_dst_w * fc
                  + plan.dst_h * plan.chr_dst_w * plan.v_chr_size)
           + plan.dst_h * plan.dst_w * SWS_CONVERT_OPS_PER_PX)
    return b * per


def sws_geometries() -> list:
    """The sws phase's timed geometries: (what, input h and w, output h
    and w); the quarter sws window's is the block window's fit of 1080p
    into -g160x48 quarter blocks."""
    from timg_tpu_torch.geometry import calc_scale_to_fit

    qw, qh, _ = calc_scale_to_fit(IN_W, IN_H, block_options("quarter"))
    return [("720x1280", IN_H, IN_W, OUT_H, OUT_W),
            ("720x1279 (full chroma)", IN_H, IN_W, OUT_H, OUT_W - 1),
            ("1080x1920 (unscaled)", IN_H, IN_W, IN_H, IN_W),
            (f"{qh}x{qw} (the quarter sws window)", IN_H, IN_W, qh, qw),
            (f"720x1280 from {H_4K}x{W_4K}", H_4K, W_4K, OUT_H, OUT_W)]


def sws_phase(planes) -> dict:
    """The swscale-exact kernel (--resample=sws-bitexact) on the window's
    1080p planes: byte-equal to its plain version on the card in both
    ranges into 720x1280 at B=32 and at the CLI's B=8, into 720x1279 (an
    odd width: the full-chroma path), at 1080x1920 (equal size, even
    height: the unscaled converter) and into the quarter sws window's
    geometry, and on 8 seeded frames of 2160x3840 into 720x1280; timed
    by CUDA events over calls and in a CUDA graph beside its bound and
    the plain version."""
    import torch

    from timg_tpu_torch.ops import sws_kernel
    from timg_tpu_torch.ops.sws_resize import (
        get_plan, sws_yuv420_to_rgba_words_plain)

    window = [p[:N_WINDOW] for p in planes]
    dev = planes[0].device
    window_4k = [torch.from_numpy(p).to(dev)
                 for p in yuv_frames(N_WINDOW, SEED + 5, H_4K, W_4K)]
    inputs = {IN_H: window, H_4K: window_4k}
    errs = []
    cases = [(f"720x1280, B={N_KERNEL}", (OUT_H, OUT_W), planes)] + [
        (f"{what}, B={N_WINDOW}", (oh, ow), inputs[ih])
        for what, ih, iw, oh, ow in sws_geometries()]
    for what, (oh, ow), batch in cases:
        ih, iw = batch[0].shape[1:]
        for full_range in (False, True):
            plan = get_plan(iw, ih, ow, oh, full_range)
            n0 = sws_kernel.LAUNCHES
            got = sws_kernel.sws_yuv420_to_rgba_words_cuda(*batch, plan)
            torch.cuda.synchronize()
            if sws_kernel.LAUNCHES - n0 != 1:
                fail("the sws kernel counted "
                     f"{sws_kernel.LAUNCHES - n0} launches a call")
            errs.append(check_equal(
                f"sws_yuv420_to_rgba_words {what} (full_range={full_range})",
                got, sws_yuv420_to_rgba_words_plain(*batch, oh, ow,
                                                    full_range)))
        print(f"kernels: sws_yuv420_to_rgba_words {ih}x{iw} -> {what}, "
              f"template {plan.template}, both ranges: equal to plain")

    def nbytes(b, ih, iw, oh, ow):   # the three planes in, the words out
        return b * (ih * iw * 3 // 2 + oh * ow * 4)

    def call(batch, plan):
        return lambda: sws_kernel.sws_yuv420_to_rgba_words_cuda(*batch, plan)

    plan = get_plan(IN_W, IN_H, OUT_W, OUT_H, False)
    r = dict(max_abs_err=max(errs), ms=cuda_ms(call(planes, plan), 20),
             plain_ms=cuda_ms(lambda: sws_yuv420_to_rgba_words_plain(
                 *planes, OUT_H, OUT_W, False), 2),
             library_ms=None,     # no PyTorch call computes it
             **bound(nbytes(N_KERNEL, IN_H, IN_W, OUT_H, OUT_W),
                     sws_ops(plan, N_KERNEL), INT32_OPS_PER_S))
    for what, ih, iw, oh, ow in sws_geometries():
        batch = inputs[ih]
        p = get_plan(iw, ih, ow, oh, False)
        ms = cuda_ms(call(batch, p), 20)
        dev_ms = graph_ms(call(batch, p))
        plain = cuda_ms(lambda: sws_yuv420_to_rgba_words_plain(
            *batch, oh, ow, False), 2)
        nb = nbytes(N_WINDOW, ih, iw, oh, ow)
        bb = bound(nb, 0)["bound_ms"]
        bo = bound(0, sws_ops(p, N_WINDOW), INT32_OPS_PER_S)["bound_ms"]
        print(f"kernels: sws_yuv420_to_rgba_words {ih}x{iw} -> {what} "
              f"at the CLI's window, B={N_WINDOW}: {ms:.6f} ms by events, "
              f"{dev_ms:.6f} ms device (CUDA graph), plain {plain:.6f} ms; "
              f"byte bound {bb:.6f} ms ({nb / 1e6:.2f} MB: "
              f"{N_WINDOW * ih * iw * 3 // 2 / 1e6:.2f} in, "
              f"{N_WINDOW * oh * ow * 4 / 1e6:.2f} out), operation bound "
              f"{bo:.6f} ms ({sws_ops(p, N_WINDOW)} int32)")
    r["graph_ms"] = graph_ms(call(planes, plan))
    print(f"kernels: sws_yuv420_to_rgba_words at B={N_KERNEL}: "
          f"{r['graph_ms']:.6f} ms device (CUDA graph)")
    return r


def resize_4k(dev) -> None:
    """The resize of 4K-class input (the TPU's row-tiled K2 domain):
    B=8 seeded words, 2160x3840 -> 720x1280, byte-equal to the plain
    version on CPU copies, and timed."""
    import numpy as np
    import torch

    from timg_tpu_torch.ops import resize_kernel
    from timg_tpu_torch.ops.resize import resize_video_words_plain

    rng = np.random.default_rng(SEED + 4)
    img = rng.integers(0, 256, (N_WINDOW, H_4K, W_4K, 4), dtype=np.uint8)
    img[..., 3] = 255
    words_cpu = torch.from_numpy(img.view(np.int32).reshape(N_WINDOW, H_4K,
                                                            W_4K))
    del img
    words = words_cpu.to(dev)
    got = resize_kernel.resize_video_words_cuda(words, OUT_H, OUT_W)
    torch.cuda.synchronize()
    check_equal(f"resize {H_4K}x{W_4K} -> {OUT_H}x{OUT_W}", got,
                resize_video_words_plain(words_cpu, OUT_H, OUT_W))
    ms = cuda_ms(lambda: resize_kernel.resize_video_words_cuda(
        words, OUT_H, OUT_W), 20)
    b = bound(N_WINDOW * (H_4K * W_4K + OUT_H * OUT_W) * 4, 0)["bound_ms"]
    print(f"kernels: resize {H_4K}x{W_4K} -> {OUT_H}x{OUT_W}, B={N_WINDOW}: "
          f"equal to plain (CPU); {ms:.6f} ms, bound {b:.6f} ms (bytes)")
    return words, words_cpu


def resize_passes(words, words_cpu) -> dict:
    """The two-pass route, for geometries no fused tile fits: the 4K
    window (B=8) into 16x28 pixels (a terminal area of a few cells),
    byte-equal to the plain version on CPU copies; timed (and split into
    its passes by torch.profiler) beside the plain version and the JAX
    package's formulation (two bf16 band matmuls)."""
    import torch

    from timg_tpu_torch.ops import resize_kernel
    from timg_tpu_torch.ops.resize import (_band_matrix_np, axis_taps,
                                           plan_tiles,
                                           resize_video_words_plain,
                                           vertical_first)

    oh, ow = PASS_H, PASS_W
    if plan_tiles(H_4K, W_4K, oh, ow) is not None:
        fail(f"resize {H_4K}x{W_4K} -> {oh}x{ow} no longer takes the "
             "two-pass route")
    before = resize_kernel.PASS_LAUNCHES
    got = resize_kernel.resize_video_words_cuda(words, oh, ow)
    torch.cuda.synchronize()
    if resize_kernel.PASS_LAUNCHES != before + 1:
        fail("the two-pass resize route did not launch")
    err = check_equal(f"resize (two passes) {H_4K}x{W_4K} -> {oh}x{ow}", got,
                      resize_video_words_plain(words_cpu, oh, ow))
    dev = words.device
    planes = torch.stack([((words >> (8 * c)) & 0xFF) for c in range(3)],
                         dim=1).to(torch.bfloat16)
    mv = torch.from_numpy(_band_matrix_np(H_4K, oh, False)).to(
        dev, torch.bfloat16)
    mw = torch.from_numpy(_band_matrix_np(W_4K, ow, True)).to(
        dev, torch.bfloat16)
    tv = axis_taps(H_4K, oh, False)[1].shape[1]
    th = axis_taps(W_4K, ow, True)[1].shape[1]
    if vertical_first(H_4K, W_4K, oh, ow):
        macs = oh * W_4K * tv + oh * ow * th
    else:
        macs = H_4K * ow * th + oh * ow * tv
    r = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: resize_kernel.resize_video_words_cuda(
            words, oh, ow), 20),
        plain_ms=cuda_ms(lambda: resize_video_words_plain(words, oh, ow), 3),
        library_ms=cuda_ms(lambda: torch.matmul(
            torch.matmul(mv.T, planes), mw), 20),
        **bound(N_WINDOW * (H_4K * W_4K + oh * ow) * 4,
                N_WINDOW * 3 * macs))
    print(f"kernels: resize (two passes) {H_4K}x{W_4K} -> {oh}x{ow}, "
          f"B={N_WINDOW}: equal to plain (CPU); {r['ms']:.6f} ms, bound "
          f"{r['bound_ms']:.6f} ms ({r['bound_by']}), band matmuls "
          f"{r['library_ms']:.6f} ms")
    device_profile(lambda: resize_kernel.resize_video_words_cuda(
        words, oh, ow), f"resize, B={N_WINDOW} -> {oh}x{ow}")
    return r


def scan_depth(words):
    """How many candidates the quarter kernel's scan computes in each cell
    of [B, th, tw] words (th even): up to the first new best below 1, all
    8 without one, none where a transparency override decides the cell.
    From the plain version's costs (ops/blocks.py)."""
    import torch

    from timg_tpu_torch.ops.blocks import _TRANSPARENT_THRESHOLD, _avd, _lin

    b, th, tw = words.shape
    px = words.contiguous().view(torch.uint8).reshape(b, th // 2, 2,
                                                      tw // 2, 2, 4)
    tl, tr, bl, br = (px[:, :, y, :, x] for y in (0, 1) for x in (0, 1))
    transparent = [p[..., 3] < _TRANSPARENT_THRESHOLD for p in
                   (tl, tr, bl, br)]
    decided = (transparent[0] & transparent[1]) | (transparent[2]
                                                   & transparent[3])
    tl, tr, bl, br = _lin(tl), _lin(tr), _lin(bl), _lin(br)

    def pair(x, y, z, w):
        return _avd(x, y)[1] + _avd(z, w)[1]

    cost = torch.stack([_avd(tl, tr, bl, br)[1], _avd(tr, bl, br)[1],
                        _avd(tl, bl, br)[1], _avd(tl, tr, br)[1],
                        _avd(tl, tr, bl)[1], pair(tr, br, tl, bl),
                        pair(tr, bl, tl, br), pair(tl, tr, bl, br)], -1)
    run_min = torch.cat([torch.full_like(cost[..., :1], 1e12),
                         torch.cummin(cost, -1).values[..., :-1]], -1)
    stops = (cost < run_min) & (cost < 1.0)
    depth = torch.where(stops.any(-1),
                        torch.argmax(stops.to(torch.uint8), -1) + 1, 8)
    return torch.where(decided, 0, depth)


def quarter_ops(words) -> tuple:
    """Float operations the quarter kernel does on these words (the
    scan's depth as this data needs it) and the mean depth."""
    import torch

    depth = scan_depth(words)
    ops = depth.numel() * QUARTER_CELL_OPS + sum(
        int((depth > k).sum()) * n for k, n in
        enumerate(QUARTER_CANDIDATE_OPS))
    return ops, float(depth.to(torch.float64).mean())


def block_windows(w720) -> dict:
    """The quarter kernel's other B=32 windows of 720x1280 words beside
    the seeded one: "noise" (seeded uniform bytes, opaque: no cell's scan
    stops early) and "flat" (one opaque color a frame: every scan stops
    at candidate 0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 5)
    noise = rng.integers(0, 256, (N_KERNEL, OUT_H, OUT_W, 4), np.uint8)
    noise[..., 3] = 255
    flat = np.empty_like(noise)
    flat[...] = rng.integers(0, 256, (N_KERNEL, 1, 1, 4), np.uint8)
    flat[..., 3] = 255
    return {"seeded": w720} | {
        name: torch.from_numpy(img.view(np.int32)[..., 0].copy()).to(
            w720.device) for name, img in (("noise", noise), ("flat", flat))}


def block_phase(words, w720) -> dict:
    """The block kernels (quarter_cells, half_cells): byte-equal to their
    plain versions on the card at B=32 on the 720x1280 words (even
    height) and on their first 719 rows (odd: the blank pad row), with
    and without a tail, use_upper both ways; quarter cells also on a
    noise and a flat window (``block_windows``); then at the CLI's
    geometry (1080p into -g160x48, B=8, resized by the resize kernel
    here).  Timed at B=32, 720 rows, with the diff against a tail, beside
    the bound and the plain version, by events over calls (``ms``) and in
    a CUDA graph (``graph_ms``, device time), and so at B=8; quarter
    cells also on each window, with the bound of the operations that
    window's scan needs."""
    import torch

    from timg_tpu_torch.geometry import calc_scale_to_fit
    from timg_tpu_torch.ops import blocks as blocks_op
    from timg_tpu_torch.ops import blocks_kernel, resize_kernel

    odd = w720[:, :OUT_H - 1].contiguous()
    tails = {OUT_H: w720[-1].clone(), OUT_H - 1: odd[0].clone()}
    windows = block_windows(w720)
    cli = {}
    for mode in BLOCK_MODES:
        tw, th, _ = calc_scale_to_fit(IN_W, IN_H, block_options(mode))
        cli[mode] = resize_kernel.resize_video_words_cuda(
            words[:N_WINDOW], th, tw)
    kernels = {"quarter": (blocks_kernel.quarter_cells_cuda,
                           blocks_op.quarter_cells_plain),
               "half": (blocks_kernel.half_cells_cuda,
                        blocks_op.half_cells_plain)}
    results = {}
    for mode, (kern, plain) in kernels.items():
        name = f"{mode}_cells"
        cases = [(w, up, tail) for w in (w720, odd) for up in (False, True)
                 for tail in (None, tails[w.shape[1]])]
        if mode == "quarter":
            cases += [(w, False, w[-1].clone()) for k, w in windows.items()
                      if k != "seeded"]
        cases.append((cli[mode], False, cli[mode][-1].clone()))
        errs = []
        for w, up, tail in cases:
            got = kern(w, up, tail)
            torch.cuda.synchronize()
            want = plain(w, up, tail)
            errs += [check_equal(f"{name} B={w.shape[0]} {w.shape[1]}x"
                                 f"{w.shape[2]} use_upper={up} tail="
                                 f"{tail is not None} ({part})", g, ref)
                     for part, g, ref in zip(("glyph", "fg", "bg", "eq"),
                                             got, want)]
        cells = N_KERNEL * (OUT_H // 2) * (OUT_W // (2 if mode == "quarter"
                                                     else 1))
        nbytes = cells * (QUARTER_BYTES_PER_CELL if mode == "quarter"
                          else HALF_BYTES_PER_CELL) + OUT_H * OUT_W * 4
        nops = quarter_ops(w720)[0] if mode == "quarter" else 0
        tail = tails[OUT_H]
        results[name] = dict(
            max_abs_err=max(errs),
            ms=cuda_ms(lambda: kern(w720, False, tail), 20),
            graph_ms=graph_ms(lambda: kern(w720, False, tail)),
            plain_ms=cuda_ms(lambda: plain(w720, False, tail), 3),
            library_ms=None,     # no PyTorch call computes it
            **bound(nbytes, nops))
        w8, tail8 = cli[mode], cli[mode][-1].clone()
        # the call's host time exceeds its device time here: many calls
        # average the shared host's noise
        ms8 = cuda_ms(lambda: kern(w8, False, tail8), 200)
        graph8 = graph_ms(lambda: kern(w8, False, tail8))
        plain8 = cuda_ms(lambda: plain(w8, False, tail8), 3)
        print(f"kernels: {name} {OUT_H}x{OUT_W} and {OUT_H - 1}x{OUT_W} "
              f"(odd: blank pad row), B={N_KERNEL}, use_upper both ways, "
              f"with and without a tail; {w8.shape[1]}x{w8.shape[2]} "
              f"(1080p into -g{GRID_W}x{GRID_H}), B={N_WINDOW}: equal to "
              f"plain; B={N_KERNEL}: {results[name]['graph_ms']:.6f} ms in "
              f"a CUDA graph; B={N_WINDOW}: {ms8:.6f} ms by events, "
              f"{graph8:.6f} ms in a CUDA graph, plain {plain8:.6f} ms")
        if mode != "quarter":
            continue
        results[name]["windows"] = {}
        for k, w in windows.items():
            ops, depth = quarter_ops(w)
            t = w[-1].clone()
            r = dict(ms=cuda_ms(lambda: kern(w, False, t), 20),
                     graph_ms=graph_ms(lambda: kern(w, False, t)),
                     mean_depth=depth, **bound(nbytes, ops))
            results[name]["windows"][k] = r
            print(f"kernels: quarter_cells {k} window, B={N_KERNEL} "
                  f"{OUT_H}x{OUT_W}: equal to plain; {r['graph_ms']:.6f} ms "
                  f"in a CUDA graph, {r['ms']:.6f} ms by events; "
                  f"{depth:.4f} candidates a cell, {ops} float operations, "
                  f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return results


def kernel_phase(dev):
    import numpy as np
    import torch

    from timg_tpu_torch.ops import libsixel_kernel as lib
    from timg_tpu_torch.ops import libsixel_quant as lsq
    from timg_tpu_torch.ops import resize_kernel, sixel_kernel
    from timg_tpu_torch.ops.resize import (_band_matrix_np, axis_taps,
                                           resize_video_words_plain,
                                           vertical_first)
    from timg_tpu_torch.ops.sixel_np import median_cut_tree

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ys, us, vs = yuv_frames(N_KERNEL, SEED)
    planes = [torch.from_numpy(p).to(dev) for p in (ys, us, vs)]
    results = {}
    words, results["convert"] = convert_phase(planes)
    results["sws"] = sws_phase(planes)
    del planes

    # resize: kernel vs the plain version on CPU copies, 1080p -> 720 and
    # -> 722 rows (the height a 722-row terminal area would ask for)
    words_cpu = words.cpu()
    resized, errs = {}, []
    for oh in (OUT_H, OUT_H + 2):
        got = resize_kernel.resize_video_words_cuda(words, oh, OUT_W)
        torch.cuda.synchronize()
        want = resize_video_words_plain(words_cpu, oh, OUT_W)
        errs.append(check_equal(f"resize at {oh}x{OUT_W}", got, want))
        resized[oh] = got
    print(f"kernels: resize 1080x1920 -> {OUT_H}x{OUT_W} and "
          f"{OUT_H + 2}x{OUT_W}, B={N_KERNEL}: equal to plain (CPU)")
    # the library yardstick: the JAX package's CPU formulation, two band
    # matmuls over bf16 channel planes (extracted outside the timing)
    planes = torch.stack([((words >> (8 * c)) & 0xFF) for c in range(3)],
                         dim=1).to(torch.bfloat16)          # [B, 3, H, W]
    mv = torch.from_numpy(_band_matrix_np(IN_H, OUT_H, False)).to(
        dev, torch.bfloat16)
    mw = torch.from_numpy(_band_matrix_np(IN_W, OUT_W, True)).to(
        dev, torch.bfloat16)
    tv = axis_taps(IN_H, OUT_H, False)[1].shape[1]
    th = axis_taps(IN_W, OUT_W, True)[1].shape[1]
    if vertical_first(IN_H, IN_W, OUT_H, OUT_W):
        macs = OUT_H * IN_W * tv + OUT_H * OUT_W * th
    else:
        macs = IN_H * OUT_W * th + OUT_H * OUT_W * tv
    results["resize"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: resize_kernel.resize_video_words_cuda(
            words, OUT_H, OUT_W), 20),
        plain_ms=cuda_ms(lambda: resize_video_words_plain(
            words, OUT_H, OUT_W), 3),
        library_ms=cuda_ms(lambda: torch.matmul(
            torch.matmul(mv.T, planes), mw), 20),
        **bound(N_KERNEL * (IN_H * IN_W + OUT_H * OUT_W) * 4,
                N_KERNEL * 3 * macs))
    del planes
    window = words[:N_WINDOW].contiguous()
    ms = cuda_ms(lambda: resize_kernel.resize_video_words_cuda(
        window, OUT_H, OUT_W), 20)
    b = bound(N_WINDOW * (IN_H * IN_W + OUT_H * OUT_W) * 4, 0)["bound_ms"]
    print(f"kernels: resize at the CLI's window, B={N_WINDOW}: {ms:.6f} ms, "
          f"bound {b:.6f} ms (bytes)")
    del window
    device_profile(lambda: resize_kernel.resize_video_words_cuda(
        words, OUT_H, OUT_W), f"resize, B={N_KERNEL} -> {OUT_H}x{OUT_W}")
    results["resize_passes"] = resize_passes(*resize_4k(dev))
    results.update(block_phase(words, resized[OUT_H]))

    # the dithers' two inputs: 720 rows (a multiple of 6: no pad), and
    # 722 rows padded to 726 with background rows
    padded = torch.cat([resized[OUT_H + 2],
                        torch.full((N_KERNEL, 4, OUT_W), BG_WORD,
                                   dtype=torch.int32, device=dev)], dim=1)
    inputs = ((resized[OUT_H], OUT_H), (padded, OUT_H + 6))
    w720 = resized[OUT_H]

    errs = []
    for w_in, h in inputs:
        got = sixel_kernel.fs_dither_cube_cuda(w_in, h, OUT_W)
        want = sixel_kernel.fs_dither_cube_plain(w_in, h, OUT_W)
        errs.append(check_equal(f"fs_dither_cube at {h}x{OUT_W}", got, want))
        if int(got.max()) > 251:
            fail("dither index outside the 252-color cube")
    print(f"kernels: fs_dither_cube {OUT_H}x{OUT_W} and {OUT_H + 6}x{OUT_W}"
          f" (bg-padded), B={N_KERNEL}: equal to plain")
    px720 = N_KERNEL * OUT_H * OUT_W
    px726 = N_KERNEL * (OUT_H + 6) * OUT_W
    results["dither"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: sixel_kernel.fs_dither_cube_cuda(
            w720, OUT_H, OUT_W), 10),
        plain_ms=cuda_ms(lambda: sixel_kernel.fs_dither_cube_plain(
            w720, OUT_H, OUT_W), 1),
        library_ms=None,         # a serial recurrence: no PyTorch call
        **bound(px720 * (4 + 1), px720 * CUBE_OPS_PER_PX))

    # K9: the cube dither reading the frames' bytes in place, 3 channels
    # at 720 rows (int32 out, its contract) and 4 channels of the
    # bg-padded 726 rows (uint8 out, as the library path asks)
    rgba720 = w720.view(torch.uint8).reshape(N_KERNEL, OUT_H, OUT_W, 4)
    rgb720 = rgba720[..., :3].contiguous()
    rgba726 = padded.view(torch.uint8).reshape(N_KERNEL, OUT_H + 6, OUT_W,
                                               4)
    rgb_inputs = ((rgb720, OUT_H, False), (rgba726, OUT_H + 6, True))
    errs = []
    for frames, h, u8 in rgb_inputs:
        got = sixel_kernel.fs_dither_cube_rgb_cuda(frames, h, OUT_W, u8)
        want = sixel_kernel.fs_dither_cube_rgb_plain(frames, h, OUT_W, u8)
        errs.append(check_equal(f"fs_dither_cube_rgb at {h}x{OUT_W}x"
                                f"{frames.shape[-1]}", got, want))
    print(f"kernels: fs_dither_cube_rgb (K9) {OUT_H}x{OUT_W}x3 and "
          f"{OUT_H + 6}x{OUT_W}x4 (bg-padded), B={N_KERNEL}: equal to plain")
    results["cube_rgb"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: sixel_kernel.fs_dither_cube_rgb_cuda(
            rgba720, OUT_H, OUT_W, True), 10),
        plain_ms=cuda_ms(lambda: sixel_kernel.fs_dither_cube_rgb_plain(
            rgba720, OUT_H, OUT_W, True), 1),
        library_ms=None,
        **bound(px720 * (3 + 1), px720 * CUBE_OPS_PER_PX))

    # libsixel: palettes of the padded frames from quant.c's histogram
    # samples, as the video window builds them; the last frame is made
    # flat (few buckets), so its diffuse flag is 0
    padded[-1] = 0x00406080 | BG_WORD
    stride = lsq.sample_stride((OUT_H + 6) * OUT_W)
    samples = padded.reshape(N_KERNEL, -1)[:, ::stride].cpu().numpy()
    rgb = np.stack([samples & 0xFF, (samples >> 8) & 0xFF,
                    (samples >> 16) & 0xFF], axis=-1).astype(np.uint8)
    t0 = time.perf_counter()
    made = [lsq.make_palette_from_samples(rgb[i]) for i in range(N_KERNEL)]
    palette_ms = (time.perf_counter() - t0) * 1000.0 / N_KERNEL
    diffs = torch.tensor([int(d) for _, d in made], dtype=torch.int32,
                         device=dev)
    if int(diffs.sum()) != N_KERNEL - 1 or int(diffs[-1]) != 0:
        fail(f"libsixel diffuse flags {diffs.tolist()}: expected every "
             "frame but the flat last one to diffuse")
    pals = torch.from_numpy(lib.pad_palettes([p for p, _ in made])).to(dev)
    print(f"kernels: host libsixel palette (make_palette_from_samples, "
          f"{samples.shape[1]} samples a frame): {palette_ms:.3f} ms per "
          f"frame (host clock, mean of {N_KERNEL})")

    tables = lib.build_bucket_tables_cuda(pals)
    err = check_equal("bucket_tables", tables,
                      lib.build_bucket_tables_plain(pals))
    print(f"kernels: bucket_tables B={N_KERNEL}: equal to plain")
    bases = lib.bucket_bases(dev).to(torch.float32)
    pals_f32 = pals.to(torch.float32)
    # the least work of the function: one int32 min per (key, entry)

    def bucket_bound(b):
        return bound(b * (lib.PALETTE_SIZE * 3 * 4 + lib.N_BUCKETS),
                     b * lib.N_BUCKETS * lib.PALETTE_SIZE, INT32_OPS_PER_S)

    times = bucket_times(pals)
    results["bucket"] = dict(
        max_abs_err=err,
        **times[N_KERNEL],
        plain_ms=cuda_ms(lambda: lib.build_bucket_tables_plain(pals), 3),
        library_ms=cuda_ms(lambda: torch.cdist(
            bases.expand(N_KERNEL, -1, -1), pals_f32).argmin(dim=2), 3),
        **bucket_bound(N_KERNEL))
    print(f"kernels: bucket_tables at the CLI's window, B={N_WINDOW}: "
          f"{times[N_WINDOW]['ms']:.6f} ms by events, "
          f"{times[N_WINDOW]['graph_ms']:.6f} ms in a CUDA graph, bound "
          f"{bucket_bound(N_WINDOW)['bound_ms']:.6f} ms (operations)")

    palw = lib.palette_words(pals)
    errs = []
    for w_in, h in inputs:
        got = lib.fs_dither_table_cuda(w_in, tables, palw, diffs, h, OUT_W)
        want = lib.fs_dither_table_plain(w_in, tables, palw, diffs, h, OUT_W)
        errs.append(check_equal(f"fs_dither_table at {h}x{OUT_W}", got,
                                want))
    print(f"kernels: fs_dither_table (K8) {OUT_H}x{OUT_W} and {OUT_H + 6}x"
          f"{OUT_W} (bg-padded; one diffuse=0 frame), B={N_KERNEL}: equal "
          "to plain")
    results["table"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: lib.fs_dither_table_cuda(
            padded, tables, palw, diffs, OUT_H + 6, OUT_W), 10),
        plain_ms=cuda_ms(lambda: lib.fs_dither_table_plain(
            padded, tables, palw, diffs, OUT_H + 6, OUT_W), 1),
        library_ms=None,
        **bound(px726 * (4 + 1) + N_KERNEL * (lib.N_BUCKETS
                                              + lib.PALETTE_SIZE * 4 + 4),
                px726 * TABLE_OPS_PER_PX, INT32_OPS_PER_S))

    # adaptive: one median-cut tree from the padded window's first frame
    first = padded[0].cpu().numpy().view(np.uint8).reshape(OUT_H + 6,
                                                           OUT_W, 4)
    _, levels_np, leaves_np = median_cut_tree(first[..., :3])
    levels = torch.from_numpy(levels_np).to(dev)
    leaves = torch.from_numpy(leaves_np).to(dev)
    errs = []
    for w_in, h in inputs:
        got = sixel_kernel.fs_dither_tree_cuda(w_in, levels, leaves, h,
                                               OUT_W)
        want = sixel_kernel.fs_dither_tree_plain(w_in, levels, leaves, h,
                                                 OUT_W)
        errs.append(check_equal(f"fs_dither_tree at {h}x{OUT_W}", got, want))
    print(f"kernels: fs_dither_tree {OUT_H}x{OUT_W} and {OUT_H + 6}x{OUT_W}"
          f" (bg-padded), B={N_KERNEL}: equal to plain")
    results["tree"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: sixel_kernel.fs_dither_tree_cuda(
            padded, levels, leaves, OUT_H + 6, OUT_W), 10),
        plain_ms=cuda_ms(lambda: sixel_kernel.fs_dither_tree_plain(
            padded, levels, leaves, OUT_H + 6, OUT_W), 1),
        library_ms=None,
        **bound(px726 * (4 + 1) + (8 * 128 + 256) * 4,
                px726 * TREE_OPS_PER_PX))

    # the tree quantizer on bytes, the library path's adaptive dither
    errs = []
    for frames, h, u8 in rgb_inputs:
        got = sixel_kernel.fs_dither_tree_rgb_cuda(frames, levels, leaves, h,
                                                   OUT_W, u8)
        want = sixel_kernel.fs_dither_tree_rgb_plain(frames, levels, leaves,
                                                     h, OUT_W, u8)
        errs.append(check_equal(f"fs_dither_tree_rgb at {h}x{OUT_W}x"
                                f"{frames.shape[-1]}", got, want))
    print(f"kernels: fs_dither_tree_rgb {OUT_H}x{OUT_W}x3 and {OUT_H + 6}x"
          f"{OUT_W}x4 (bg-padded), B={N_KERNEL}: equal to plain")
    results["tree_rgb"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: sixel_kernel.fs_dither_tree_rgb_cuda(
            rgba720, levels, leaves, OUT_H, OUT_W, True), 10),
        plain_ms=cuda_ms(lambda: sixel_kernel.fs_dither_tree_rgb_plain(
            rgba720, levels, leaves, OUT_H, OUT_W, True), 1),
        library_ms=None,
        **bound(px720 * (3 + 1) + (8 * 128 + 256) * 4,
                px720 * TREE_OPS_PER_PX))

    # the wavefront driver at the other batches the main paths launch:
    # the CLI's 8-frame window (K6 at 720 rows, K7 and K8 at 726) and one
    # frame, as the library's per-frame adaptive loop runs the byte tree
    # (and K9); then one warp alone (32 rows of one frame): a step's
    # latency with no warp edge and no other warp on the SM
    lone = (w720[:1, :WARP_ROWS].contiguous(), WARP_ROWS, OUT_W)
    w8 = N_WINDOW
    shapes = (
        ("fs_dither_cube", N_WINDOW, OUT_H, sixel_kernel.fs_dither_cube_cuda,
         sixel_kernel.fs_dither_cube_plain, (w720[:N_WINDOW], OUT_H, OUT_W)),
        ("fs_dither_tree", N_WINDOW, OUT_H + 6,
         sixel_kernel.fs_dither_tree_cuda, sixel_kernel.fs_dither_tree_plain,
         (padded[:N_WINDOW], levels, leaves, OUT_H + 6, OUT_W)),
        ("fs_dither_cube_rgb", 1, OUT_H, sixel_kernel.fs_dither_cube_rgb_cuda,
         sixel_kernel.fs_dither_cube_rgb_plain,
         (rgba720[:1], OUT_H, OUT_W, True)),
        ("fs_dither_tree_rgb", 1, OUT_H, sixel_kernel.fs_dither_tree_rgb_cuda,
         sixel_kernel.fs_dither_tree_rgb_plain,
         (rgba720[:1], levels, leaves, OUT_H, OUT_W, True)),
        ("fs_dither_cube", 1, WARP_ROWS, sixel_kernel.fs_dither_cube_cuda,
         sixel_kernel.fs_dither_cube_plain, lone),
        ("fs_dither_tree", 1, WARP_ROWS, sixel_kernel.fs_dither_tree_cuda,
         sixel_kernel.fs_dither_tree_plain,
         (lone[0], levels, leaves) + lone[1:]),
        ("fs_dither_table", w8, OUT_H + 6, lib.fs_dither_table_cuda,
         lib.fs_dither_table_plain,
         (padded[:w8], tables[:w8], palw[:w8], diffs[:w8], OUT_H + 6, OUT_W)),
        ("fs_dither_table", 1, WARP_ROWS, lib.fs_dither_table_cuda,
         lib.fs_dither_table_plain,
         (lone[0], tables[:1], palw[:1], diffs[:1]) + lone[1:]))
    for name, b, h, kern, plain, args in shapes:
        check_equal(f"{name} at B={b}, {h}x{OUT_W}", kern(*args),
                    plain(*args))
        ms = cuda_ms(lambda: kern(*args), 20)
        plan = sixel_kernel.plan_bands(b, h, sms)
        print(f"kernels: {name} B={b} {h}x{OUT_W} ({plan.bands} bands of "
              f"{plan.warps} warps): equal to plain; {ms:.6f} ms, "
              f"{ms * 1000 / steps(h):.6f} us a step")

    results.update(transport_phase(w720))

    rows = {"dither": OUT_H, "cube_rgb": OUT_H, "tree": OUT_H + 6,
            "table": OUT_H + 6, "tree_rgb": OUT_H}
    for name, r in results.items():
        lib_ms = r["library_ms"]
        per_step = (f", {r['ms'] * 1000 / steps(rows[name]):.6f} us a step"
                    if name in rows else "")
        print(f"kernels: {name}: kernel {r['ms']:.6f} ms{per_step}, plain "
              f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), library "
              f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'} per "
              f"{N_WINDOW if name == 'resize_passes' else N_KERNEL}-frame "
              "window")
    return results


def transport_phase(w720) -> dict:
    """The four transport kernels on the cube dither's index planes of
    the seeded window (720x1280, as the main path dithers them): each
    byte-equal to its plain version (on the card) at B=32 and at the
    CLI's B=8, timed at both by events and in a CUDA graph (device
    time) beside its bound (bytes, or the integer
    operations the function needs for this data: the listed colours of
    each band) and, for the compaction, torch.masked_select of the
    packed column words by the start mask.  Every seeded frame holds
    more runs than the cap, so the compaction is also checked and timed
    on flat windows (``flat_planes``), which the main path does compact;
    its row in the kernels line is the flat window's.  The compaction is
    timed alone, given the counts."""
    from timg_tpu_torch.ops import sixel_dcs, sixel_kernel, sixel_runs
    from timg_tpu_torch.ops import sixel_runs_kernel as srk

    h, w = OUT_H, OUT_W
    nb = (h + 5) // 6
    planes = sixel_kernel.fs_dither_cube_cuda(w720, h, w)       # uint8
    results = {}
    for b in (N_KERNEL, N_WINDOW):
        p = planes[:b]
        px = b * h * w
        counts = sixel_runs.band_run_counts(p, h, w)
        err = check_equal(f"band_run_counts at B={b}", counts,
                          sixel_runs.band_run_counts_plain(p, h, w))
        seeded = compaction(p, f"the seeded window at B={b}")
        flat = compaction(flat_planes(b, p.device),
                          f"a flat window at B={b}")
        lens, colours = sixel_dcs.batch_band_lens(p, b, h, w)
        want = sixel_dcs.batch_band_lens_plain(p, b, h, w)
        err = max(err, check_equal(f"dcs_band_lens at B={b}", lens,
                                   want[0]),
                  check_equal(f"dcs_band_lens' colours at B={b}", colours,
                              want[1]))
        dcap = sixel_dcs.bucket_cap(int(lens.max()))
        bands, lens2 = sixel_dcs.batch_encode(p, b, h, w, dcap)
        want = sixel_dcs.batch_encode_plain(p, b, h, w, dcap)
        err = max(err, check_equal(f"dcs_emit at B={b}", bands, want[0]),
                  check_equal(f"dcs_emit's lens at B={b}", lens2, want[1]))
        n_runs = int(counts.sum())
        listed = int(colours.clamp(max=sixel_dcs.COLOR_CAP).sum())
        body = int(lens.sum())
        dcs_ops = (px * DCS_OPS_PER_PX
                   + listed * w * DCS_OPS_PER_COLOUR_COLUMN)
        row = {
            "run_counts": dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: srk.band_run_counts_cuda(p, h, w), 50),
                graph_ms=graph_ms(lambda: srk.band_run_counts_cuda(p, h, w)),
                plain_ms=cuda_ms(lambda: sixel_runs.band_run_counts_plain(
                    p, h, w), 3),
                library_ms=None,
                **bound(px + b * nb * 4, b * nb * w * RUN_OPS_PER_COLUMN,
                        INT32_OPS_PER_S)),
            "compact_runs": dict(flat, max_abs_err=max(
                err, flat["max_abs_err"], seeded["max_abs_err"])),
            "dcs_lens": dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: sixel_dcs.batch_band_lens(p, b, h, w),
                           20),
                graph_ms=graph_ms(lambda: sixel_dcs.batch_band_lens(
                    p, b, h, w)),
                plain_ms=cuda_ms(lambda: sixel_dcs.batch_band_lens_plain(
                    p, b, h, w), 1),
                library_ms=None,
                **bound(px + b * nb * 8, dcs_ops, INT32_OPS_PER_S)),
            # its output, written once: the band buffers [B, nb, cap],
            # zero past each band's length, and the lens
            "dcs_emit": dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: sixel_dcs.batch_encode(
                    p, b, h, w, dcap), 20),
                graph_ms=graph_ms(lambda: sixel_dcs.batch_encode(
                    p, b, h, w, dcap)),
                plain_ms=cuda_ms(lambda: sixel_dcs.batch_encode_plain(
                    p, b, h, w, dcap), 1),
                library_ms=None,
                **bound(px + b * nb * (dcap + 4), dcs_ops + body,
                        INT32_OPS_PER_S))}
        seeded_data = (f"cube indices of the seeded window: {n_runs} runs, "
                       f"{listed} listed colours, {body} body bytes, DCS "
                       f"cap {dcap}")
        for name, r, data in (
                ("run_counts", row["run_counts"], seeded_data),
                ("compact_runs", flat, f"a flat window: {flat['runs']} runs"),
                ("compact_runs", seeded,
                 f"{seeded_data}; every frame over the cap, truncated"),
                ("dcs_lens", row["dcs_lens"], seeded_data),
                ("dcs_emit", row["dcs_emit"], seeded_data)):
            lib_ms = r["library_ms"]
            dev_ms = (f" ({r['graph_ms']:.6f} in a CUDA graph)"
                      if "graph_ms" in r else "")
            print(f"kernels: {name} B={b} {h}x{w} ({data}): equal to plain; "
                  f"{r['ms']:.6f} ms{dev_ms}, plain {r['plain_ms']:.6f} ms, "
                  f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library "
                  f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}")
        if b == N_KERNEL:
            results = row
    for r in results.values():
        r.pop("runs", None)
    return results


def compaction(p, what: str) -> dict:
    """The compaction kernel on [B, 720, 1280] u8 planes: byte-equal to
    its plain version and to torch.masked_select of the packed column
    words by the start mask (each frame's records up to the cap), timed
    alone given the counts, by events and in a CUDA graph, beside its
    bound: the planes and the counts read, the records [B, cap, 2] (zero
    past a frame's count, written by the kernel) written."""
    import torch

    from timg_tpu_torch.ops import sixel_runs
    from timg_tpu_torch.ops import sixel_runs_kernel as srk

    h, w = OUT_H, OUT_W
    b, nb = p.shape[0], (h + 5) // 6
    cap = sixel_runs.default_cap(h, w)
    counts = sixel_runs.band_run_counts(p, h, w)
    records, got_counts = sixel_runs.compact_runs(p, h, w, cap)
    want = sixel_runs.compact_runs_plain(p, h, w, cap)
    err = max(check_equal(f"compact_runs on {what}", records, want[0]),
              check_equal(f"compact_runs' counts on {what}", got_counts,
                          want[1]))
    # the yardstick: packed words, start mask made outside the timing
    w0, w1 = sixel_runs._column_words(p, h, w)
    start = sixel_runs._start_mask(w0, w1)
    xs = torch.arange(w, dtype=torch.int32, device=p.device)
    packed = torch.stack([w0, w1 | (xs << 16)], dim=-1)
    mask = start[..., None].expand_as(packed)
    picked = torch.masked_select(packed, mask).view(-1, 2)
    first = 0
    for i, c in enumerate(counts.sum(1).tolist()):
        kept = min(c, records.shape[1])    # the records stop at cap
        if not torch.equal(picked[first:first + kept], records[i, :kept]):
            fail(f"masked_select of the packed words != the records of "
                 f"frame {i} on {what}")
        first += c
    return dict(
        runs=int(counts.sum()), max_abs_err=err,
        ms=cuda_ms(lambda: srk.compact_records_cuda(p, h, w, counts, cap),
                   50),
        graph_ms=graph_ms(lambda: srk.compact_records_cuda(p, h, w, counts,
                                                           cap)),
        plain_ms=cuda_ms(lambda: sixel_runs.compact_runs_plain(
            p, h, w, cap), 3),
        library_ms=cuda_ms(lambda: torch.masked_select(packed, mask), 20),
        **bound(b * h * w + b * nb * 4 + records.numel() * 4,
                b * nb * w * RUN_OPS_PER_COLUMN, INT32_OPS_PER_S))


def flat_planes(b: int, dev):
    """b frames of 720x1280 index planes of UI-like content: a black
    field, a moving rectangle, a box of one index a frame and a bar."""
    import torch

    flat = torch.zeros((b, OUT_H, OUT_W), dtype=torch.uint8, device=dev)
    for i in range(b):
        flat[i, 40:300, 100 + 20 * (i % 8):700 + 20 * (i % 8)] = 17
        flat[i, 400:680, 300:1200] = 40 + i % 8
        flat[i, 500:520, :] = 3
    return flat


def transport_windows(b: int, dev) -> dict:
    """b frames each of 720x1280 index planes: a flat window
    (``flat_planes``), a film-like one (the cube dither of smooth
    gradients) and a noise one (the cube dither of seeded noise)."""
    import torch

    from timg_tpu_torch.ops import sixel_kernel

    h, w = OUT_H, OUT_W
    gen = torch.Generator(device=dev).manual_seed(SEED)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    words = torch.stack([
        (xx * 255 // (w - 1) + 3 * i).clamp(max=255)
        | ((yy * 255 // (h - 1)) << 8)
        | (((xx + yy + 5 * i) * 255 // (w + h)).clamp(max=255) << 16)
        for i in range(b)]).to(torch.int32) | BG_WORD
    noise_words = torch.randint(0, 1 << 24, (b, h, w), generator=gen,
                                device=dev, dtype=torch.int32) | BG_WORD
    return {"flat": flat_planes(b, dev),
            "film-like": sixel_kernel.fs_dither_cube_cuda(words, h, w),
            "noise": sixel_kernel.fs_dither_cube_cuda(noise_words, h, w)}


def transport_legs(dev) -> None:
    """Per window (the CLI's 8 frames of 720x1280 index planes) and per
    forced transport, the host clock of the device->host leg (the
    transport's kernels, its host syncs and copies: fetch_planes_or_runs)
    and of the host leg (C assembly of planes or records, or the DCS
    splice), on a flat window (UI-like rectangles), a film-like gradient
    (the cube dither of smooth gradients) and a noise window (the cube
    dither of noise); then the same under the default, auto, from a
    fresh session's verdict (``_DCS_FASTER`` unset): what auto ships and
    what its decision costs where it falls back to the plane.  The
    transports' streams must be equal."""
    import torch

    from timg_tpu_torch.ops import sixel_runs
    from timg_tpu_torch.ops.sixel_np import cube_palette
    from timg_tpu_torch.render import sixel_render

    h, w, b = OUT_H, OUT_W, N_WINDOW
    pal = cube_palette()
    encoders = {"ndarray": sixel_render.encode_sixel_stream,
                "SixelRuns": sixel_render.encode_sixel_stream_runs,
                "SixelDcs": sixel_render.encode_sixel_stream_dcs}
    verdict = sixel_runs._DCS_FASTER
    try:
        for name, planes in transport_windows(b, dev).items():
            streams = {}
            for transport in TRANSPORTS + ("auto",):
                os.environ["TIMG_TPU_SIXEL_TRANSPORT"] = transport
                sixel_runs._DCS_FASTER = None
                d2h, host = [], []
                for rep in range(4):               # the first warms up
                    s0 = dict(sixel_runs.STATS)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    entries = sixel_runs.fetch_planes_or_runs(planes, b, h,
                                                              w)
                    t1 = time.perf_counter()
                    out = [encoders[type(e).__name__](e, pal)
                           for e in entries]
                    t2 = time.perf_counter()
                    if rep:
                        d2h.append((t1 - t0) * 1e3)
                        host.append((t2 - t1) * 1e3)
                moved = {k: sixel_runs.STATS[k] - s0[k] for k in s0}
                streams[transport] = out
                kind = type(entries[0]).__name__.replace("ndarray", "planes")
                print(f"transport legs: {name} window, B={b} {h}x{w}, "
                      f"{transport}: shipped as {kind}, "
                      f"{moved['bytes_shipped']} B ({h * w * b} B of "
                      f"planes); device and D2H {min(d2h):.3f}-"
                      f"{max(d2h):.3f} ms, host {min(host):.3f}-"
                      f"{max(host):.3f} ms a window (host clock, "
                      f"{len(d2h)} runs)" + (
                          f"; DCS verdict {sixel_runs._DCS_FASTER}"
                          if transport == "auto" else ""))
            if any(streams[t] != streams["plane"] for t in streams):
                fail(f"transport legs: the {name} window's streams differ "
                     "between transports")
    finally:
        os.environ.pop("TIMG_TPU_SIXEL_TRANSPORT", None)
        sixel_runs._DCS_FASTER = verdict


def bucket_times(pals) -> dict:
    """The bucket build of the imported timg_tpu_torch on [32, 256, 3]
    CUDA palettes at B=8 and B=32: byte-equal to its plain version and
    timed two ways, by CUDA events over back-to-back calls (``ms``, as
    every kernel; the wrapper's issue time when it exceeds the kernel's)
    and by ``graph_ms`` (the device time).  A driver that puts another
    checkout first on sys.path times that checkout's build with it.
    Returns {B: {"ms": ..., "graph_ms": ...}}."""
    from timg_tpu_torch.ops import libsixel_kernel as lib

    where = os.path.dirname(os.path.dirname(os.path.dirname(lib.__file__)))
    times = {}
    for b in (N_WINDOW, N_KERNEL):
        p = pals[:b].contiguous()
        check_equal(f"bucket_tables B={b}", lib.build_bucket_tables_cuda(p),
                    lib.build_bucket_tables_plain(p))
        times[b] = dict(ms=cuda_ms(lambda: lib.build_bucket_tables_cuda(p),
                                   20),
                        graph_ms=graph_ms(
                            lambda: lib.build_bucket_tables_cuda(p)))
        print(f"kernels: bucket_tables of {where}, B={b}: equal to plain; "
              f"{times[b]['ms']:.6f} ms a call by events, "
              f"{times[b]['graph_ms']:.6f} ms in a CUDA graph")
    return times


def steps(h: int) -> int:
    """Serial steps of an FS wavefront of h rows at the output width."""
    return OUT_W + 2 * (h - 1)


def rgba_frames(n: int, seed: int):
    """Seeded 1080p RGBA: gradients plus noise, with a transparent region
    (alpha falling from 254 to 0 across a box) that the compose blends."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IN_H, 0:IN_W]
    out = np.empty((n, IN_H, IN_W, 4), np.uint8)
    for i in range(n):
        for c in range(3):
            out[i, ..., c] = (xx * (60 + 50 * c) // IN_W
                              + yy * (90 - 20 * c) // IN_H + 23 * i + 40 * c
                              + rng.integers(0, 32, (IN_H, IN_W))) % 256
        out[i, ..., 3] = 255
        bh, bw = IN_H // 2, IN_W // 3
        y0, x0 = IN_H // 6 + 3 * i, IN_W // 6 + 5 * i
        ramp = np.linspace(254, 0, bw).astype(np.uint8)
        out[i, y0:y0 + bh, x0:x0 + bw, 3] = ramp[None, :]
    return out


def library_payloads(run: str) -> list:
    """One library-path run: 8 seeded 1080p frames through
    timg_tpu_torch.models.get("sixel"), "kitty" or "iterm2" at
    720x1280, or through the quarter or half block model at
    LIB_BLOCK_SIZE -> the payloads."""
    from timg_tpu_torch import models

    dither, reuse, kind = LIB_RUNS[run]
    if run in PIXEL_MODES:
        model = models.get(run)(out_h=OUT_H, out_w=OUT_W,
                                bg_color=(0, 0, 0, 255))
        return model.render_batch(rgba_frames(N_LIB, SEED + 3))
    if run in LIB_BLOCK_SIZE:
        oh, ow = LIB_BLOCK_SIZE[run]
        model = models.get(run)(out_h=oh, out_w=ow, bg_color=(0, 0, 0, 255))
        return model.render_batch(rgba_frames(N_LIB, SEED + 3))
    model = models.get("sixel")(out_h=OUT_H, out_w=OUT_W,
                                bg_color=(0, 0, 0, 255), dither=dither,
                                adaptive_reuse=reuse)
    if kind == "yuv":
        ys, us, vs = yuv_frames(N_LIB, SEED + 2)
        return model.render_batch_yuv(ys, us, vs, full_range=False)
    return model.render_batch(rgba_frames(N_LIB, SEED + 3))


def first_difference(a: bytes, b: bytes) -> str:
    """Where two streams part: the first differing byte, the frame and
    cell row it falls in (rows end in ESC[0m newline), the count of
    differing bytes and a few bytes of each side around it."""
    n = min(len(a), len(b))
    i = next((k for k in range(n) if a[k] != b[k]), n)
    rows = a[:i].count(b"\033[0m\n")
    lo, hi = max(0, i - 24), i + 24
    return (f"first differing byte {i} (after {rows} rows of cells), "
            f"{sum(x != y for x, y in zip(a, b))} bytes differ; "
            f"cuda {a[lo:hi]!r}, cpu {b[lo:hi]!r}")


def digests(payloads: list) -> list:
    return [hashlib.sha256(p).hexdigest() for p in payloads]


def library_stages(dev) -> None:
    """Stage times of the library path's cube run on the card (CUDA
    events; host clock for the tree build and the assembly)."""
    import torch

    from timg_tpu_torch.ops import sixel as sixel_op
    from timg_tpu_torch.ops.compose import alpha_compose_background
    from timg_tpu_torch.ops.resize import resize_batch
    from timg_tpu_torch.render import sixel_render

    frames = rgba_frames(N_LIB, SEED + 3)
    h2d = cuda_ms(lambda: torch.from_numpy(frames).to(dev), 3)
    x = torch.from_numpy(frames).to(dev)
    resize = cuda_ms(lambda: resize_batch(x, OUT_H, OUT_W), 3)
    r = resize_batch(x, OUT_H, OUT_W)
    bg = (0, 0, 0, 255)
    compose = cuda_ms(lambda: alpha_compose_background(r, bg, (0, 0, 0, 0)),
                      5)
    c = alpha_compose_background(r, bg, (0, 0, 0, 0))
    dither = cuda_ms(lambda: sixel_op.fs_dither_cube(c, out_u8=True), 5)
    d2h = cuda_ms(lambda: sixel_op.fs_dither_cube(c, out_u8=True).cpu(), 3) \
        - dither
    idx = sixel_op.fs_dither_cube(c, out_u8=True).cpu().numpy()
    host = c[..., :3].cpu().numpy()
    t0 = time.perf_counter()
    for f in host:
        sixel_op.median_cut_tree(f)
    tree = (time.perf_counter() - t0) * 1000.0 / N_LIB
    before = dict(sixel_render.ASSEMBLED)
    t0 = time.perf_counter()
    for plane in idx:
        sixel_render.encode_sixel_stream(plane, sixel_op.cube_palette())
    assemble = (time.perf_counter() - t0) * 1000.0 / N_LIB
    which = "C" if sixel_render.ASSEMBLED["c"] > before["c"] else "Python"
    print(f"library path: stages of the cube run, {N_LIB} frames 1080p -> "
          f"{OUT_H}x{OUT_W}: H2D {h2d:.6f} ms, resize {resize:.6f} ms, "
          f"compose {compose:.6f} ms, cube dither {dither:.6f} ms, D2H "
          f"{d2h:.6f} ms (CUDA events, per batch); host tree build "
          f"{tree:.3f} ms and {which} assembly {assemble:.3f} ms per frame "
          "(host clock)")


PATH_KERNELS = {"cube": ("convert", "resize", "dither"),
                "libsixel": ("convert", "resize", "bucket", "table"),
                "adaptive": ("convert", "resize", "tree"),
                "quarter": ("convert", "resize", "quarter_cells"),
                "half": ("convert", "resize", "half_cells"),
                "kitty": ("convert", "resize"),
                "iterm2": ("convert", "resize"),
                "cube sws": ("sws", "dither"),
                "quarter sws": ("sws", "quarter_cells"),
                "kitty sws": ("sws",)}
# the library's kitty and iTerm2 models run the stb resize and the
# compose, torch ops, and no hand kernel
LIB_KERNELS = {"cube": ("cube_rgb",), "adaptive": ("tree_rgb",),
               "adaptive_reuse": ("tree_rgb",),
               "yuv": ("convert", "resize", "cube_rgb"),
               "quarter": ("quarter_cells",), "half": ("half_cells",),
               "kitty": (), "iterm2": ()}


# ---------------------------------------------------------------- stills
# The stills phase drives the port's CLI in this process, as a user runs
# it, on a pty whose window gives 8x16-pixel cells at -g160x48; the pty
# answers the CLI's terminal queries at once (a DSR reply to the version
# query, a sixel-capable DA1, a black background), so no run waits out a
# query's timeout.
STILL_WINSIZE = (GRID_H + 2, GRID_W + 2, (GRID_W + 2) * 8,
                 (GRID_H + 2) * 16)
STILL_ANSWERS = {b"\033[5n": b"\033[0n", b"\033[c": b"\033[?62;4c",
                 b"\033]11;?": b"\033]11;rgb:0000/0000/0000\033\\"}
STILL_FLAGS = ["--debug-no-frame-delay", f"-g{GRID_W}x{GRID_H}"]
GRID_FILES = [f"grid{i}.png" for i in range(8)]
# name -> (flags, inputs, environment of the run)
STILL_CASES = {
    "photo cube": (["-ps", "--dither=cube"], ["photo.jpg"], {}),
    "photo adaptive": (["-ps", "--dither=adaptive"], ["photo.jpg"], {}),
    "photo libsixel": (["-ps", "--dither=libsixel"], ["photo.jpg"], {}),
    "photo pq": (["-pq"], ["photo.jpg"], {}),
    "photo ph": (["-ph"], ["photo.jpg"], {}),
    "alpha pq none": (["-pq", "-b", "none"], ["alpha.png"], {}),
    "alpha ph none": (["-ph", "-b", "none"], ["alpha.png"], {}),
    "alpha cube checker": (["-ps", "--dither=cube", "-b", "black", "-B",
                            "gray"], ["alpha.png"], {}),
    "gif libsixel": (["-ps", "--dither=libsixel", "--loops=1"],
                     ["anim.gif"], {}),
    "gif pq": (["-pq", "--loops=1"], ["anim.gif"], {}),
    "grid cube": (["-ps", "--dither=cube", "--grid=4x2"], GRID_FILES, {}),
    "grid cube unbatched": (["-ps", "--dither=cube", "--grid=4x2"],
                            GRID_FILES, {"TIMG_TPU_NO_GRID_BATCH": "1"}),
    "grid pq": (["-pq", "--grid=4x2"], GRID_FILES, {}),
    "scroll libsixel": (["-ps", "--dither=libsixel", "--scroll=10",
                         "-t0.25"], ["panorama.png"], {}),
    "odd plane": (["-ps", "--dither=cube"], ["odd.png"],
                  {"TIMG_TPU_SIXEL_TRANSPORT": "plane"}),
    "odd runs": (["-ps", "--dither=cube"], ["odd.png"],
                 {"TIMG_TPU_SIXEL_TRANSPORT": "runs"}),
    "odd dcs": (["-ps", "--dither=cube"], ["odd.png"],
                {"TIMG_TPU_SIXEL_TRANSPORT": "dcs"}),
    "photo auto-crop": (["-pq", "--auto-crop"], ["photo.jpg"], {}),
    "photo nearest": (["-ps", "--dither=cube", "-a"], ["photo.jpg"], {}),
    "photo pk": (["-pk"], ["photo.jpg"], {}),
    "photo pi": (["-pi"], ["photo.jpg"], {}),
    "alpha pk none": (["-pk", "-b", "none"], ["alpha.png"], {}),
    "alpha pi none": (["-pi", "-b", "none"], ["alpha.png"], {}),
    "alpha pk checker": (["-pk", "-b", "black", "-B", "gray"],
                         ["alpha.png"], {}),
    "alpha pi checker": (["-pi", "-b", "black", "-B", "gray"],
                         ["alpha.png"], {}),
    "gif pk": (["-pk", "--loops=1"], ["anim.gif"], {}),
    "grid pi": (["-pi", "--grid=4x2"], GRID_FILES, {}),
}
# frames each case writes (an image each; the GIF's 24; the scroll's 26)
STILL_FRAMES = {"gif libsixel": 24, "gif pq": 24, "gif pk": 24,
                "grid cube": 8, "grid cube unbatched": 8, "grid pq": 8,
                "grid pi": 8, "scroll libsixel": 26}
STILL_KERNELS = ("dither", "tree", "bucket", "table", "quarter_cells",
                 "half_cells", "run_counts")
N_STILL_CHILDREN = 4        # CPU children sharing the cases
# the decoders beside Pillow and QOI, each in -pq and -ps: decoder ->
# its file (``decoder_inputs``); the last four run only where their
# library (or gs) is on the host
DECODER_FILES = {"hdr": "sky.hdr", "dpx": "scan.dpx", "xwd": "screen.xwd",
                 "miff": "image.miff", "xcf": "layers.xcf",
                 "text": "notes.txt", "svg": "drawing.svg",
                 "pdf": "letter.pdf", "postscript": "letter.ps",
                 "openslide": "slide.tif"}


def decoder_libraries() -> dict:
    """Which library-backed decoders can run on this host: librsvg and
    cairo (SVG), poppler-glib (PDF), gs (PostScript), libopenslide."""
    from timg_tpu_torch.sources import (openslide_source, pdf_source,
                                        ps_source, svg_source)

    return {"svg": svg_source._load() is not None,
            "pdf": pdf_source.poppler_available(),
            "postscript": ps_source.find_gs() is not None,
            "openslide": openslide_source._lib() is not None}


def decoder_cases(libraries: dict) -> dict:
    """STILL_CASES entries of the decoders this host can run."""
    cases = {}
    for name, f in DECODER_FILES.items():
        if not libraries.get(name, True):
            continue
        cases[f"{name} pq"] = (["-pq"], [f], {})
        cases[f"{name} ps"] = (["-ps"], [f], {})
    return cases


def decoder_inputs(d: str) -> None:
    """The decoders' files, written from the seed as their formats lay
    them out (the JAX package's tests write the same layouts:
    tests/test_hdr.py, tests/test_gm_formats.py, tests/test_xcf.py): a
    1024x768 Radiance HDR of adaptive-RLE scanlines, a 1920x1080 10-bit
    DPX (method A, big-endian), a 1280x800 32-bit XWD, a 1024x768 8-bit
    DirectClass MIFF, a 1024x768 XCF of an RGB layer under an RGBA layer
    with an alpha ramp (raw tiles), a text page, a 1600x1000 SVG with
    translucent shapes, a one-page Letter PDF, the same page in
    PostScript and a 2048x1536 tiled TIFF (OpenSlide's generic-tiff
    slide)."""
    import struct

    import numpy as np

    rng = np.random.default_rng(SEED + 17)

    def picture(h, w, k):
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([(xx * (100 + 30 * c) // w + yy * (60 + 20 * c) // h
                          + 40 * c + 11 * k + rng.integers(0, 16, (h, w)))
                         % 256 for c in range(3)], -1).astype(np.uint8)

    def put(name, data):
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)

    # Radiance HDR: each scanline 2 2 w/256 w%256, then each component's
    # literal chunks of up to 128 bytes (stb_image.h:7159-7287)
    h, w = 768, 1024
    rgbe = np.concatenate([picture(h, w, 0), rng.integers(
        124, 134, (h, w, 1)).astype(np.uint8)], -1)
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)]
    for row in rgbe:
        out.append(bytes([2, 2, w >> 8, w & 0xFF]))
        for c in range(4):
            for x in range(0, w, 128):
                chunk = row[x:x + 128, c]
                out.append(bytes([len(chunk)]) + chunk.tobytes())
    put(DECODER_FILES["hdr"], b"".join(out))

    # DPX: 2048-byte header, 10-bit RGB filled to 32 bits (method A)
    h, w = 1080, 1920
    rgb = picture(h, w, 1).astype(np.uint32) * 4 + 1
    hdr = bytearray(2048)
    hdr[0:4] = b"SDPX"
    struct.pack_into(">I", hdr, 4, 2048)
    hdr[8:16] = b"V2.0\0\0\0\0"
    struct.pack_into(">HHII", hdr, 768, 0, 1, w, h)
    hdr[800], hdr[803] = 50, 10               # RGB, 10 bits
    struct.pack_into(">HHII", hdr, 804, 1, 0, 2048, 0)
    words = (rgb[..., 0] << 22) | (rgb[..., 1] << 12) | (rgb[..., 2] << 2)
    put(DECODER_FILES["dpx"], bytes(hdr) + words.astype(">u4").tobytes())

    # XWD: ZPixmap, 24-bit depth in 32-bit pixels, MSB first
    h, w = 800, 1280
    rgb = picture(h, w, 2).astype(np.uint32)
    name = b"chip-smoke\0"
    head = struct.pack(">25I", 100 + len(name), 7, 2, 24, w, h, 0, 1, 32,
                       1, 32, 32, w * 4, 4, 0xFF0000, 0x00FF00, 0x0000FF,
                       8, 0, 0, w, h, 0, 0, 0)
    pix = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    put(DECODER_FILES["xwd"], head + name + pix.astype(">u4").tobytes())

    # MIFF: text header, then 8-bit DirectClass RGB samples
    h, w = 768, 1024
    head = (f"id=ImageMagick  version=1.0\nclass=DirectClass  colors=0  "
            f"matte=False\ncolumns={w}  rows={h}  depth=8\n"
            "compression=None\n\f\n:").encode()
    put(DECODER_FILES["miff"], head + picture(h, w, 3).tobytes())

    # XCF v2: an RGBA layer (offset, an alpha ramp) over an RGB layer,
    # raw 64x64 tiles (PROP_COMPRESSION 0)
    h, w = 768, 1024
    top = np.concatenate([picture(400, 600, 4), np.broadcast_to(
        np.linspace(255, 0, 600).astype(np.uint8)[None, :, None],
        (400, 600, 1))], -1)
    layers = [(top, 1, 150, 100), (picture(h, w, 5), 0, 0, 0)]
    b = bytearray(b"gimp xcf v002\0" + struct.pack(">III", w, h, 0))
    b += struct.pack(">II", 17, 1) + bytes([0]) + struct.pack(">II", 0, 0)
    slots = []
    for _ in range(len(layers) + 2):       # the layers, two terminators
        slots.append(len(b))
        b += bytes(4)
    for slot, (pix, kind, ox, oy) in zip(slots, layers):
        lh, lw, bpp = pix.shape
        struct.pack_into(">I", b, slot, len(b))
        b += struct.pack(">III", lw, lh, kind)
        b += struct.pack(">I", 6) + b"layer\0"
        b += struct.pack(">III", 6, 4, 255) + struct.pack(">III", 8, 4, 1)
        b += struct.pack(">IIii", 15, 8, ox, oy) + struct.pack(">II", 0, 0)
        hier = len(b)
        b += bytes(8)                      # hierarchy, mask (none)
        struct.pack_into(">I", b, hier, len(b))
        b += struct.pack(">III", lw, lh, bpp)
        level = len(b)
        b += bytes(8)                      # level, terminator
        struct.pack_into(">I", b, level, len(b))
        b += struct.pack(">II", lw, lh)
        tiles = [(ty, tx) for ty in range(0, lh, 64)
                 for tx in range(0, lw, 64)]
        first = len(b)
        b += bytes(4 * (len(tiles) + 1))
        for i, (ty, tx) in enumerate(tiles):
            struct.pack_into(">I", b, first + 4 * i, len(b))
            b += pix[ty:ty + 64, tx:tx + 64].tobytes()
    put(DECODER_FILES["xcf"], bytes(b))

    put(DECODER_FILES["text"], b"timg-tpu-torch\n\n" + b"".join(
        b"line %d: the quick brown fox jumps over the lazy dog\n" % i
        for i in range(40)))
    put(DECODER_FILES["svg"], (
        '<svg xmlns="http://www.w3.org/2000/svg" width="1600" '
        'height="1000"><rect width="1600" height="1000" fill="#336699"/>'
        '<circle cx="800" cy="500" r="380" fill="#ffcc00" '
        'fill-opacity="0.6"/><rect x="100" y="600" width="900" '
        'height="300" fill="#cc3366" fill-opacity="0.4"/></svg>').encode())

    # a one-page US Letter PDF (612 x 792 pt) and the page in PostScript
    page = (b"0.2 0.4 0.6 rg 0 0 612 792 re f 1 0.8 0 rg 100 200 400 300 "
            b"re f")
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
            b"/Contents 4 0 R >>",
            b"<< /Length %d >>\nstream\n%s\nendstream" % (len(page), page)]
    pdf = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, obj in enumerate(objs, 1):
        offsets.append(len(pdf))
        pdf += b"%d 0 obj\n%s\nendobj\n" % (i, obj)
    xref = len(pdf)
    pdf += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    pdf += b"".join(b"%010d 00000 n \n" % off for off in offsets)
    pdf += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objs) + 1, xref))
    put(DECODER_FILES["pdf"], bytes(pdf))
    put(DECODER_FILES["postscript"], (
        b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 612 792\n%%Pages: 1\n"
        b"0.2 0.4 0.6 setrgbcolor 0 0 612 792 rectfill\n"
        b"1 0.8 0 setrgbcolor 100 200 400 300 rectfill\nshowpage\n"))

    # a generic tiled TIFF, little-endian: 8-bit RGB in uncompressed
    # 256x256 tiles, one level; the IFD, then BitsPerSample, the tile
    # offsets and byte counts, then the tiles
    h, w, t = 1536, 2048, 256
    rgb = picture(h, w, 6)
    tiles = [rgb[y:y + t, x:x + t].tobytes() for y in range(0, h, t)
             for x in range(0, w, t)]
    n = len(tiles)
    bps = 8 + 2 + 12 * 11 + 4
    offsets = bps + 6
    data = offsets + 8 * n
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, bps),
            (259, 3, 1, 1), (262, 3, 1, 2), (277, 3, 1, 3), (284, 3, 1, 1),
            (322, 3, 1, t), (323, 3, 1, t), (324, 4, n, offsets),
            (325, 4, n, offsets + 4 * n)]
    tif = struct.pack("<2sHIH", b"II", 42, 8, len(tags))
    tif += b"".join(struct.pack("<HHII", *tag) for tag in tags)
    tif += struct.pack("<I3H", 0, 8, 8, 8)
    tif += struct.pack(f"<{n}I", *(data + k * len(tiles[0])
                                   for k in range(n)))
    tif += struct.pack(f"<{n}I", *(len(tile) for tile in tiles))
    put(DECODER_FILES["openslide"], tif + b"".join(tiles))


def still_inputs(d: str) -> None:
    """The stills phase's files, made with PIL from the seed: a 4032x3024
    photo-like JPEG (q 90), a 1920x1080 RGBA PNG with an alpha ramp and a
    fully transparent region, a 480x270 GIF of 24 frames, eight 1920x1080
    PNGs for the grid, a 3840x1080 panorama and a 1021x767 still of flat
    cube colours (every transport carries it)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 14)

    def scene(h, w, k):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.empty((h, w, 3), np.uint8)
        for c in range(3):
            img[..., c] = (xx * (90 + 40 * c) // w + yy * (120 - 30 * c) // h
                           + 37 * k + 50 * c
                           + rng.integers(0, 20, (h, w))) % 256
        img[h // 4:h // 2, w // 5:w // 3] = (20 + 30 * k) % 256   # a wall
        return img

    Image.fromarray(scene(3024, 4032, 0)).save(
        os.path.join(d, "photo.jpg"), quality=90)
    rgba = np.dstack([scene(1080, 1920, 1), np.full((1080, 1920), 255,
                                                    np.uint8)])
    rgba[200:800, 300:1500, 3] = np.linspace(254, 0, 1200).astype(np.uint8)
    rgba[850:1000, 100:700, 3] = 0
    Image.fromarray(rgba, "RGBA").save(os.path.join(d, "alpha.png"),
                                       compress_level=1)
    base = scene(270, 480, 2)
    frames = []
    for i in range(24):
        f = base.copy()
        f[:, 20 * i:20 * i + 40] = (255 - 10 * i, 8 * i, 128)
        frames.append(Image.fromarray(f))
    frames[0].save(os.path.join(d, "anim.gif"), save_all=True,
                   append_images=frames[1:], duration=40, loop=0)
    for i in range(8):
        Image.fromarray(scene(1080, 1920, 3 + i)).save(
            os.path.join(d, f"grid{i}.png"), compress_level=1)
    Image.fromarray(scene(1080, 3840, 11)).save(
        os.path.join(d, "panorama.png"), compress_level=1)
    odd = np.zeros((767, 1021, 3), np.uint8)
    odd[:, :, 0] = (np.arange(767) // 64 % 6 * 51)[:, None]
    odd[:, 400:700, 2] = 255
    odd[300:500, 100:900, 1] = 255
    Image.fromarray(odd).save(os.path.join(d, "odd.png"), compress_level=1)


def cli_stream(argv: list, out_path: str) -> bytes:
    """One run of the port's CLI in this process with its stdout on a
    pty of STILL_WINSIZE (the stream to ``out_path``); returns the
    stream."""
    import fcntl
    import pty
    import struct
    import termios
    import threading

    from timg_tpu_torch.cli import main

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH",
                                                       *STILL_WINSIZE))

    def pump():
        try:
            while True:
                data = os.read(master, 4096)
                if not data:
                    return
                for trigger, reply in STILL_ANSWERS.items():
                    if trigger in data:
                        os.write(master, reply)
        except OSError:
            return

    threading.Thread(target=pump, daemon=True).start()
    sys.stdout.flush()
    pin_kitty_ids()
    saved = os.dup(1)
    try:
        os.dup2(slave, 1)
        rc = main(argv + ["-o", out_path])
    finally:
        os.dup2(saved, 1)
        os.close(saved)
        os.close(slave)
        os.close(master)
    if rc != 0:
        fail(f"the CLI exited {rc} on {' '.join(argv)}")
    with open(out_path, "rb") as f:
        return f.read()


def still_argv(name: str, d: str) -> list:
    flags, inputs, _ = STILL_CASES[name]
    return STILL_FLAGS + flags + [os.path.join(d, f) for f in inputs]


@contextlib.contextmanager
def still_env(name: str):
    """The environment of one STILL_CASES run, while open."""
    env = STILL_CASES[name][2]
    os.environ.update(env)
    try:
        yield
    finally:
        for key in env:
            os.environ.pop(key, None)


def still_streams_cpu(d: str, names: list) -> None:
    """Child of the stills phase: each named case on the CPU, its stream
    to ``<d>/<name>.cpu``."""
    for name in names:
        with still_env(name):
            cli_stream(still_argv(name, d), os.path.join(d, name + ".cpu"))


def still_op_times(dev, d: str) -> None:
    """Device times of the still path's torch ops (CUDA events) beside
    their byte bound (each input byte read once, each output written
    once), at the phase's geometries."""
    import numpy as np
    import torch
    from PIL import Image

    from timg_tpu_torch.ops import autocrop
    from timg_tpu_torch.ops.compose import alpha_compose_background
    from timg_tpu_torch.ops.resize import resize_batch, resize_nearest
    from timg_tpu_torch.sources import scroll

    photo = np.asarray(Image.open(os.path.join(d, "photo.jpg")).convert(
        "RGBA"))
    full = torch.from_numpy(photo[None]).to(dev)               # 4032x3024
    drafted = full[:, ::2, ::2].contiguous()                    # 2016x1512
    rgba = np.asarray(Image.open(os.path.join(d, "alpha.png")))
    r720 = resize_batch(torch.from_numpy(rgba[None]).to(dev), 720, 1280)
    pano = torch.from_numpy(np.asarray(Image.open(os.path.join(
        d, "panorama.png")).convert("RGBA"))).to(dev)
    pano = resize_batch(pano[None], 768, 2730)[0]
    grid = full.new_zeros((8, 1080, 1920, 4))
    rows = [
        ("resize_batch 2016x1512 -> 1024x768 (the drafted photo's size)",
         lambda: resize_batch(drafted, 768, 1024),
         drafted.numel() + 768 * 1024 * 4),
        ("resize_batch 4032x3024 -> 1024x768 (the photo undrafted)",
         lambda: resize_batch(full, 768, 1024), full.numel() + 768 * 1024 * 4),
        ("resize_batch 8 x 1920x1080 -> 320x180 (the grid)",
         lambda: resize_batch(grid, 180, 320),
         8 * (1080 * 1920 + 180 * 320) * 4),
        ("compose 1280x720, checkerboard (the alpha PNG)",
         lambda: alpha_compose_background(r720, (0, 0, 0, 255),
                                          (128, 128, 128, 255), 16, 8),
         2 * r720.numel()),
        ("trim bounds 4032x3024 (--auto-crop)",
         lambda: autocrop._trim_bounds(full[0]), full.numel()),
        ("resize_nearest 4032x3024 -> 1024x768 (-a)",
         lambda: resize_nearest(full, 768, 1024), 2 * 768 * 1024 * 4),
        ("scroll_frames 16 x 1280x768 of 2730x768",
         lambda: scroll.scroll_frames(pano, 1280, 768, 1, 0, 0, 16),
         2 * 16 * 1280 * 768 * 4),
    ]
    for what, fn, nbytes in rows:
        ms = cuda_ms(fn, 5)
        b = bound(nbytes, 0)["bound_ms"]
        print(f"stills: torch op {what}: {ms:.6f} ms (CUDA events, mean of "
              f"5), byte bound {b:.6f} ms ({nbytes} B), {b / ms:.1%} of it")


def still_legs(dev, d: str) -> None:
    """The photo's first frame split into its legs (host clock,
    synchronized): decode with the JPEG draft, H2D, stb resize, the
    compose's alpha check (the photo is opaque, so no blend runs), then
    for cube the dither, the transport and the C assembly, for libsixel
    (the default) the fetch of the frame, libsixel's C quantizer and the
    assembly, for kitty (-pk; -b auto is none there, so an RGBA PNG at
    level 1) the fetch of the frame and its PNG (Sub filter and
    deflate)."""
    import numpy as np
    import torch
    from PIL import Image

    from timg_tpu_torch.native import runtime
    from timg_tpu_torch.ops.resize import resize_batch
    from timg_tpu_torch.ops.sixel_kernel import fs_dither_cube_fused
    from timg_tpu_torch.ops.sixel_np import cube_palette
    from timg_tpu_torch.ops.sixel_dcs import SixelDcs
    from timg_tpu_torch.ops.sixel_runs import SixelRuns, fetch_planes_or_runs
    from timg_tpu_torch.render.png import encode_png
    from timg_tpu_torch.render.sixel_render import (encode_sixel_stream,
                                                    encode_sixel_stream_dcs,
                                                    encode_sixel_stream_runs)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for mode in ("libsixel", "cube", "kitty"):
        legs = {}

        def decode():
            img = Image.open(os.path.join(d, "photo.jpg"))
            img.draft(None, (1024, 768))
            return np.asarray(img.convert("RGBA"))

        raw, legs["decode"] = clock(decode)
        x, legs["h2d"] = clock(lambda: torch.from_numpy(raw[None]).to(dev))
        r, legs["resize"] = clock(lambda: resize_batch(x, 768, 1024))
        _, legs["compose"] = clock(lambda: bool((r[..., 3] != 255).any()))
        if mode == "cube":
            words = r.view(torch.int32)[..., 0]
            idx, legs["dither"] = clock(
                lambda: fs_dither_cube_fused(words, 768, 1024, out_u8=True))
            entries, legs["transport"] = clock(
                lambda: fetch_planes_or_runs(idx, 1, 768, 1024))
            encode = (encode_sixel_stream_runs
                      if isinstance(entries[0], SixelRuns) else
                      encode_sixel_stream_dcs
                      if isinstance(entries[0], SixelDcs)
                      else encode_sixel_stream)
            _, legs["assembly"] = clock(
                lambda: encode(entries[0], cube_palette()))
        elif mode == "kitty":
            host, legs["fetch"] = clock(lambda: r[0].cpu().numpy())
            _, legs["png"] = clock(lambda: encode_png(host, 1, True))
        else:
            host, legs["transport"] = clock(lambda: r[0].cpu().numpy())
            (idx, pal), legs["dither"] = clock(
                lambda: runtime.libsixel_quant(host))
            _, legs["assembly"] = clock(
                lambda: encode_sixel_stream(idx, pal))
        total = sum(legs.values())
        flags = "-pk" if mode == "kitty" else f"-ps --dither={mode}"
        print(f"stills: photo {flags}, first frame by legs "
              f"(host clock, synchronized, ms): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in legs.items())
              + f"; sum {total:.3f}")


def process_start_ms() -> float:
    """A fresh process's torch import and CUDA context (host clock)."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c",
                    "import torch; torch.zeros(1, device='cuda'); "
                    "torch.cuda.synchronize()"], check=True, timeout=300)
    return (time.perf_counter() - t0) * 1e3


# the still path's torch ops, counted by call in the stills phase:
# name -> (module, function)
STILL_OPS = {"resize_batch": ("timg_tpu_torch.ops.resize", "resize_batch"),
             "resize_nearest": ("timg_tpu_torch.ops.resize",
                                "resize_nearest"),
             "compose": ("timg_tpu_torch.ops.compose",
                         "alpha_compose_background"),
             "trim_bounds": ("timg_tpu_torch.ops.autocrop", "_trim_bounds"),
             "scroll_frames": ("timg_tpu_torch.sources.scroll",
                               "scroll_frames")}


@contextlib.contextmanager
def counted_ops(calls: dict):
    """While open, each STILL_OPS function adds its calls to ``calls``
    (their callers look them up in their modules at each call)."""
    import importlib

    saved = []
    for name, (module, attr) in STILL_OPS.items():
        owner = importlib.import_module(module)
        fn = getattr(owner, attr)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        saved.append((owner, attr, fn))
        setattr(owner, attr, counted)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def still_run(name: str, d: str, streams: dict) -> int:
    """One STILL_CASES run on the card, its stream into ``streams``,
    checked for its sixel images or its rows of cells and, in a forced
    transport, that the transport carried the frame; returns the block
    frames it wrote (0 in sixel)."""
    import torch

    from timg_tpu_torch.ops import sixel_runs

    flags, _, env = STILL_CASES[name]
    transport = env.get("TIMG_TPU_SIXEL_TRANSPORT")
    s0 = dict(sixel_runs.STATS)
    t0 = time.perf_counter()
    with still_env(name):
        streams[name] = cli_stream(still_argv(name, d),
                                   os.path.join(d, name + ".cuda"))
    torch.cuda.synchronize()
    t_run = (time.perf_counter() - t0) * 1e3
    moved = {k: sixel_runs.STATS[k] - s0[k] for k in s0}
    n = STILL_FRAMES.get(name, 1)
    print(f"stills: {name}: CLI run {t_run:.1f} ms (host clock, in this "
          f"process), {len(streams[name])} bytes, {n} frames, transport "
          f"{moved}")
    if transport and moved[f"frames_{transport}"] != 1:
        fail(f"stills {name}: the {transport} transport moved {moved}")
    if "-ps" in flags:
        got = streams[name].count(b"\033Pq")
        if got != n:
            fail(f"stills {name}: {got} sixel images, expected {n}")
        return 0
    pixel = "kitty" if "-pk" in flags else "iterm2" if "-pi" in flags \
        else None
    if pixel:
        got = streams[name].count(PIXEL_HEADS[pixel])
        if got != n:
            fail(f"stills {name}: {got} {pixel} images, expected {n}")
        if name == "gif pk" and not all(
                b"i=%d," % (KITTY_ID_START + k) in streams[name]
                for k in (1, 2)):
            fail("stills gif pk: the animation's two flip-flop ids are "
                 "missing")
        return 0
    if b"\033[0m\n" not in streams[name]:
        fail(f"stills {name} wrote no row of cells")
    return n


def stills_phase(dev, reset_counts, read_counts, launches: dict,
                 after=None) -> None:
    """The port's CLI on stills, on the card: every STILL_CASES run's
    stream must equal the same run on the CPU in a child; each kernel of
    STILL_KERNELS must have launched, the C assembler assembled every
    sixel frame it was given and the C emitter written every block
    frame.  Then ``after(d, streams)``, if given, with the phase's files
    and its card streams, before the files go."""
    from timg_tpu_torch.render import ansi, sixel_render

    d = tempfile.mkdtemp(prefix="timg_stills_")
    t_phase = time.perf_counter()
    still_inputs(d)
    decoder_inputs(d)
    libraries = decoder_libraries()
    STILL_CASES.update(decoder_cases(libraries))
    print(f"stills: inputs made in {time.perf_counter() - t_phase:.2f} s; "
          "decoder libraries on this host: " + ", ".join(
              f"{k} {'found' if v else 'absent'}"
              for k, v in libraries.items()))
    env = dict(os.environ, TIMG_TPU_TORCH_DEVICE="cpu",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    names = list(STILL_CASES)
    me = os.path.abspath(__file__)
    children = [subprocess.Popen(
        [sys.executable, me, "--still-streams", d,
         json.dumps(names[k::N_STILL_CHILDREN])], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for k in range(N_STILL_CHILDREN)]
    try:
        assembled0 = dict(sixel_render.ASSEMBLED)
        emitted0 = dict(ansi.EMITTED)
        block_frames = 0
        streams = {}
        reset_counts()
        op_calls = {}
        with counted_ops(op_calls):
            for name in names:
                block_frames += still_run(name, d, streams)
        counts = read_counts()
        print(f"stills: launches {counts}; torch op calls {op_calls}")
        for k in STILL_KERNELS:
            if counts[k] <= 0:
                fail(f"stills: the still path launched no {k} kernel")
        for k in counts:
            launches[k] += counts[k]
        assembled = {k: sixel_render.ASSEMBLED[k] - assembled0[k]
                     for k in assembled0}
        emitted = {k: ansi.EMITTED[k] - emitted0[k] for k in emitted0}
        print(f"stills: the C assembler assembled {assembled['c']} frames, "
              f"the Python twin {assembled['python']}; the C ANSI emitter "
              f"wrote {emitted['c']} frames, the Python twin "
              f"{emitted['python']}")
        if assembled["python"] or not assembled["c"]:
            fail("stills: a sixel frame was not assembled by the C "
                 "assembler")
        if emitted["python"] or emitted["c"] != block_frames:
            fail(f"stills: of {block_frames} block frames the C emitter "
                 f"wrote {emitted['c']}, the Python twin "
                 f"{emitted['python']}")
        for case in ("photo libsixel", "photo cube", "photo pk"):
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                cli_stream(still_argv(case, d),
                           os.path.join(d, "again.cuda"))
                runs.append((time.perf_counter() - t0) * 1e3)
            print(f"stills: {case} ({' '.join(STILL_CASES[case][0])}): time "
                  f"to first frame, the whole CLI run in a warm process "
                  f"(host clock): {runs[0]:.1f} and {runs[1]:.1f} ms")
        print(f"stills: a fresh process's torch import and CUDA context: "
              f"{process_start_ms():.1f} ms (host clock)")
        still_legs(dev, d)
        still_op_times(dev, d)
        t_card = time.perf_counter() - t_phase
        for child in children:
            out, err = child.communicate(timeout=900)
            if child.returncode != 0:
                fail("stills: CPU reference run failed:\n"
                     + err.decode(errors="replace")[-3000:])
        for name in names:
            with open(os.path.join(d, name + ".cpu"), "rb") as f:
                cpu = f.read()
            if cpu != streams[name]:
                fail(f"stills {name}: cuda stream ({len(streams[name])} B) "
                     f"!= cpu stream ({len(cpu)} B): "
                     + first_difference(streams[name], cpu))
        print(f"stills: every cuda stream == its cpu stream; the phase took "
              f"{time.perf_counter() - t_phase:.1f} s (host clock; the "
              f"card's part {t_card:.1f} s, then waiting for the CPU "
              "children)")
        if after is not None:
            after(d, streams)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        import shutil
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------- serve
# The resident session: `timg-tpu-torch --serve` on the card, reached by
# the launcher as a user's shell runs it, with the stills phase's files
SERVE_CASES = ("photo pq", "photo libsixel", "photo pk", "hdr pq")
SERVE_WARM = 5              # warm requests timed after the first
SERVE_TIMED = "photo pq"    # the case of the cold, first and warm times
SERVE_DELEGATED = "hdr pq"  # sent for another device than the server's
DELEGATE_ENV = {"TIMG_TPU_TORCH_DEVICE": "cpu", "CUDA_VISIBLE_DEVICES": ""}


def launcher_stream(argv: list, out_path: str, env: dict) -> bytes:
    """One run of the launcher (``timg-tpu-torch``) in a fresh process,
    booted as its shebang boots it (``python3 -S``, this interpreter),
    with its stdin and stdout on a pty of STILL_WINSIZE that answers the
    terminal queries, as ``cli_stream`` runs the CLI; returns the
    stream."""
    import fcntl
    import pty
    import struct
    import termios
    import threading

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH",
                                                       *STILL_WINSIZE))

    def pump():
        try:
            while True:
                data = os.read(master, 4096)
                if not data:
                    return
                for trigger, reply in STILL_ANSWERS.items():
                    if trigger in data:
                        os.write(master, reply)
        except OSError:
            return

    threading.Thread(target=pump, daemon=True).start()
    try:
        proc = subprocess.run(
            [sys.executable, "-S", os.path.join(REPO, "timg-tpu-torch"),
             *argv, "-o", out_path], stdin=slave, stdout=slave,
            stderr=subprocess.PIPE, env=env, cwd=REPO, timeout=300)
    finally:
        os.close(slave)
        os.close(master)
    if proc.returncode != 0:
        fail(f"the launcher exited {proc.returncode} on {' '.join(argv)}:\n"
             + proc.stderr.decode(errors="replace")[-2000:])
    with open(out_path, "rb") as f:
        return f.read()


def pinned_kitty_ids(stream: bytes) -> bytes:
    """A kitty stream with its image ids (clock-seeded in a process that
    did not pin them, as the resident server) renamed, in order of first
    appearance, to the ids ``pin_kitty_ids`` gives."""
    import re

    ids = {}

    def rename(m):
        new = ids.setdefault(m.group(2), KITTY_ID_START + 1 + len(ids))
        return m.group(1) + b"%d" % new

    return re.sub(rb"(\033_G[^\033;]*?\bi=)(\d+)", rename, stream)


def served_memory(d: str, env: dict, reset_counts, read_counts) -> list:
    """The serve loop in this process (a thread, on another socket).
    First each SERVE_CASES case twice, in this process without the
    server and then served through the launcher, the kernels' launches
    counted around each: the served request must launch every kernel
    that the run without the server launched.  Then SERVE_WARM + 1
    launcher requests of SERVE_TIMED, and after each the caching
    allocator's (allocated, reserved) MiB on the card: what a resident
    server keeps across requests."""
    import threading

    import torch

    from timg_tpu_torch import serve

    sock = os.path.join(d, "memory.sock")
    ready = threading.Event()
    server = threading.Thread(
        target=serve.serve,
        args=(sock, ready.set, len(SERVE_CASES) + SERVE_WARM + 1),
        daemon=True)
    server.start()
    if not ready.wait(300):
        fail("serve: the in-process server did not come up")
    out = os.path.join(d, "memory.out")
    served_env = dict(env, TIMG_TPU_SERVE_SOCKET=sock)
    for name in SERVE_CASES:
        reset_counts()
        with still_env(name):
            cli_stream(still_argv(name, d), out)
        direct = read_counts()
        reset_counts()
        launcher_stream(still_argv(name, d), out,
                        dict(served_env, **STILL_CASES[name][2]))
        served = {k: v for k, v in read_counts().items() if v}
        direct = {k: v for k, v in direct.items() if v}
        missed = [k for k in direct if k not in served]
        if missed:
            fail(f"serve {name}: the served request launched no "
                 f"{', '.join(missed)} kernel (launched in this process "
                 f"without the server: {direct})")
        print(f"serve: {name}: launches served {served}, in this process "
              f"without the server {direct}")
        if name == SERVE_TIMED and not served:
            fail(f"serve {name}: the served request launched no kernel")
    mib = []
    for _ in range(SERVE_WARM + 1):
        launcher_stream(still_argv(SERVE_TIMED, d), out, served_env)
        torch.cuda.synchronize()
        mib.append((torch.cuda.memory_allocated() / 2**20,
                    torch.cuda.memory_reserved() / 2**20))
    server.join(60)
    return mib


def serve_phase(d: str, smi_line: str, reset_counts,
                read_counts) -> None:
    """`timg-tpu-torch --serve` on the card, on a socket in a temp dir:
    its warm-up; the launcher's requests of SERVE_CASES, each stream
    equal to the stills phase's CPU child's (kitty's ids renamed to the
    pinned ones); a cold launcher, the first served request and the
    median of SERVE_WARM warm ones, and the launcher's own start, on the
    host clock; a request with TIMG_TPU_TORCH_DEVICE=cpu answered 'D' on
    the socket, then run by the launcher itself on the CPU, with the
    same bytes; SIGTERM, after which the socket must be gone; then the
    kernels a served request launches and the device memory a server
    keeps across requests (``served_memory``)."""
    import signal
    import socket
    import statistics

    sock = os.path.join(d, "serve.sock")
    env = dict(os.environ, TIMG_TPU_SERVE_SOCKET=sock)
    env.pop("TIMG_TPU_NO_SERVE", None)
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "timg-tpu-torch"), "--serve"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        while not os.path.exists(sock):
            if server.poll() is not None or time.perf_counter() - t0 > 300:
                fail("serve: the server did not come up:\n"
                     + server.stderr.read().decode(errors="replace")[-2000:])
            time.sleep(0.02)
        t_warm = time.perf_counter() - t0
        print(f"serve: the server listens after {t_warm * 1e3:.1f} ms "
              "(host clock: its python start, torch import, CUDA context, "
              f"kernel library and native helper loaded); {smi_line}")

        def cpu_stream(name):
            with open(os.path.join(d, name + ".cpu"), "rb") as f:
                return f.read()

        def request(name, out, extra=None, pinned=False):
            case_env = dict(env, **STILL_CASES[name][2], **(extra or {}))
            t = time.perf_counter()
            got = launcher_stream(still_argv(name, d), out, case_env)
            ms = (time.perf_counter() - t) * 1e3
            if pinned:
                got = pinned_kitty_ids(got)
            if got != cpu_stream(name):
                fail(f"serve {name}: stream ({len(got)} B) != the cpu "
                     f"stream: " + first_difference(got, cpu_stream(name)))
            return ms

        out = os.path.join(d, "served.out")
        t_first = request(SERVE_TIMED, out)
        for name in SERVE_CASES:
            if name != SERVE_TIMED:
                ms = request(name, out, pinned="pk" in name)
                print(f"serve: {name} served, == its cpu stream, {ms:.1f} "
                      "ms (host clock, the launcher's process included)")
        warm = [request(SERVE_TIMED, out) for _ in range(SERVE_WARM)]
        starts = []
        for _ in range(3):
            t = time.perf_counter()
            subprocess.run([sys.executable, "-S", "-c", "import sys; sys."
                            f"path.insert(0, {REPO!r}); import "
                            "timg_tpu_torch.serve"], check=True, timeout=60)
            starts.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        cold = launcher_stream(still_argv(SERVE_TIMED, d), out,
                               dict(env, TIMG_TPU_NO_SERVE="1"))
        t_cold = (time.perf_counter() - t) * 1e3
        if cold != cpu_stream(SERVE_TIMED):
            fail("serve: the cold launcher's stream != the cpu stream")
        print(f"serve: {SERVE_TIMED} ({' '.join(STILL_CASES[SERVE_TIMED][0])}"
              f" on the 4032x3024 JPEG), the launcher's whole run on the "
              f"host clock: cold process {t_cold:.1f} ms, first served "
              f"{t_first:.1f} ms, warm served median of {SERVE_WARM} "
              f"{statistics.median(warm):.1f} ms (all "
              f"{', '.join(f'{w:.1f}' for w in warm)}); the launcher's own "
              f"start (python -S and the serve import, no request) "
              f"{statistics.median(starts):.1f} ms, median of 3; "
              f"{smi_line}")

        # delegation: the socket answers D, then the launcher runs it
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(60)
        conn.connect(sock)
        null = os.open(os.devnull, os.O_RDWR)
        try:
            import array
            conn.sendmsg([b"F"], [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                                   array.array("i", [null, null, null]))])
            req = {"argv": still_argv(SERVE_DELEGATED, d), "cwd": REPO,
                   "env": dict(env, **DELEGATE_ENV)}
            conn.sendall(json.dumps(req).encode() + b"\n")
            answer = conn.recv(64)
        finally:
            os.close(null)
            conn.close()
        if answer != b"D\n":
            fail(f"serve: a TIMG_TPU_TORCH_DEVICE=cpu request was answered "
                 f"{answer!r}, not D")
        ms = request(SERVE_DELEGATED, out, DELEGATE_ENV)
        print(f"serve: a TIMG_TPU_TORCH_DEVICE=cpu request: the socket "
              f"answered D; the launcher ran {SERVE_DELEGATED} itself on "
              f"the CPU in {ms:.1f} ms, == its cpu stream")
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=60)
        if rc != 0 or os.path.exists(sock):
            fail(f"serve: after SIGTERM the server exited {rc}, socket "
                 f"{'still there' if os.path.exists(sock) else 'gone'}")
        print("serve: SIGTERM: the server exited 0 and removed its socket")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    mib = served_memory(d, env, reset_counts, read_counts)
    print("serve: the serve loop in this process, the caching allocator "
          "after each request of " + SERVE_TIMED + " (allocated / reserved "
          "MiB): " + ", ".join(f"{a:.1f} / {r:.1f}" for a, r in mib)
          + f"; the phase took {time.perf_counter() - t0:.1f} s")
    if any(a > mib[1][0] or r > mib[1][1] for a, r in mib[2:]):
        fail("serve: the device memory grew across the warm requests")


# ---------------------------------------------------------------- devices
# --devices: each window's convert and resize (or sws) and the RGBA
# primers' dither or cells split over the cards; with one card, over
# cuda:0 four times
DEVICE_MODES = ("cube", "libsixel", "adaptive", "quarter", "kitty",
                "cube sws")
DEVICE_STILLS = ("photo pq", "photo pk")
# a still of at least 2048x2048 pixels after decode (the JPEG decodes
# drafted, smaller): the spatial route's input, in -pq
LARGE_SIZE = (2048, 2560)
LARGE_ROUNDS = 3            # one card, then the spatial route, in turn


@contextlib.contextmanager
def shard_cards(dev):
    """While open, the session is sharded: over every card with two or
    more (TIMG_TPU_DEVICES), else over ``dev`` four times (the routing's
    device list replaced).  Yields the cards."""
    import torch

    from timg_tpu_torch.parallel import auto

    n = torch.cuda.device_count()
    saved = auto.data_devices
    if n >= 2:
        os.environ["TIMG_TPU_DEVICES"] = str(n)
        cards = auto.data_devices()
    else:
        cards = [dev] * 4
        auto.data_devices = lambda: cards
    try:
        yield cards
    finally:
        auto.data_devices = saved
        os.environ.pop("TIMG_TPU_DEVICES", None)


def devices_phase(dev, d: str, still_streams: dict, reset_counts,
                  read_counts) -> None:
    """The routing over cards on the card(s): each DEVICE_MODES window
    (8 frames) through the port's video window sharded and on one card,
    byte-equal, with each kernel of the mode launched and each shard's
    card printed; the stills of DEVICE_STILLS through the CLI with
    --devices, equal to the stills phase's single-card streams, and the
    LARGE_SIZE still timed on one card and through the spatial route in
    turn; the mesh pipelines (parallel/mesh.py) against the unsharded
    ops.  The sharded runs' launches are printed on a line of their own:
    the kernels line counts the one-card main path alone."""
    import torch

    from timg_tpu_torch.ops import pipeline as tpipeline
    from timg_tpu_torch.ops.resize import resize_video_words
    from timg_tpu_torch.ops.sixel_kernel import fs_dither_cube_fused
    from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words
    from timg_tpu_torch.parallel import auto, mesh

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    launches = {}
    with shard_cards(dev) as cards:
        print(f"devices: {n_cards} card(s) visible: "
              + (f"--devices {n_cards}, the CLI's routing over every card"
                 if n_cards >= 2 else "one card, the routing and the mesh "
                 "pipelines over cuda:0 repeated four times"))
    for mode in DEVICE_MODES:
        sync()
        t0 = time.perf_counter()
        single = main_path_stream(mode, N_WINDOW)
        sync()
        t_single = time.perf_counter() - t0
        auto.SHARDS.clear()
        reset_counts()
        with shard_cards(dev):
            t0 = time.perf_counter()
            sharded = main_path_stream(mode, N_WINDOW)
            sync()
            t_sharded = time.perf_counter() - t0
        counts = read_counts()
        for k in counts:
            launches[k] = launches.get(k, 0) + counts[k]
        sixel = mode.partition(" ")[0] in SIXEL_MODES
        for k in PATH_KERNELS[mode] + (TRANSPORT_KERNELS["auto"] if sixel
                                       else ()):
            if counts[k] <= 0:
                fail(f"devices {mode}: the sharded window launched no {k} "
                     "kernel")
        if sharded != single:
            fail(f"devices {mode}: the sharded stream != the one-card "
                 "stream: " + first_difference(sharded, single))
        print(f"devices: {mode}: an 8-frame window sharded "
              f"{t_sharded * 1e3:.1f} ms, on one card {t_single * 1e3:.1f} "
              f"ms (host clock, emit included), == the one-card stream; "
              f"shards {dict(auto.SHARDS)}; launches {counts}")
    from PIL import Image

    large = os.path.join(d, "large.png")
    Image.fromarray(rgba_frames(1, SEED + 11)[0]).resize(
        LARGE_SIZE[::-1]).save(large, compress_level=1)
    large_argv = STILL_FLAGS + ["-pq", large]
    still_streams = dict(still_streams, large=cli_stream(
        large_argv, os.path.join(d, "large.cuda")))
    for name in DEVICE_STILLS + ("large",):
        argv = large_argv if name == "large" else still_argv(name, d)
        auto.SHARDS.clear()
        with shard_cards(dev) as cards, (
                still_env(name) if name in STILL_CASES
                else contextlib.nullcontext()):
            t0 = time.perf_counter()
            got = cli_stream(["--devices", str(len(cards))] + argv,
                             os.path.join(d, "devices.cuda"))
            ms = (time.perf_counter() - t0) * 1e3
        if got != still_streams[name]:
            fail(f"devices {name}: the --devices stream != the one-card "
                 "stream: " + first_difference(got, still_streams[name]))
        print(f"devices: {name} with --devices {len(cards)}: {ms:.1f} ms "
              f"(host clock), == the one-card stream; shards "
              f"{dict(auto.SHARDS)}")
    # the spatial route against one card, in turn, both warm
    shards = len(cards)
    times = {"one card": [], "spatial route": []}
    for _ in range(LARGE_ROUNDS):
        for route in times:
            sharded = route == "spatial route"
            with (shard_cards(dev) if sharded
                  else contextlib.nullcontext()):
                flags = ["--devices", str(shards)] if sharded else []
                t0 = time.perf_counter()
                got = cli_stream(flags + large_argv,
                                 os.path.join(d, "devices.cuda"))
                times[route].append((time.perf_counter() - t0) * 1e3)
            if got != still_streams["large"]:
                fail(f"devices large, {route}: another stream")
    print(f"devices: the {LARGE_SIZE[1]}x{LARGE_SIZE[0]} still in -pq, the "
          f"whole CLI run (host clock), {LARGE_ROUNDS} rounds in turn: "
          + "; ".join(f"{route} {', '.join(f'{t:.1f}' for t in ts)} ms"
                      for route, ts in times.items())
          + f" (the spatial route over {shards} "
          + ("cards" if n_cards >= 2 else "shards of cuda:0") + ")")
    if not any(k[0] == "still_resize" for k in auto.SHARDS):
        fail(f"devices: the {LARGE_SIZE[1]}x{LARGE_SIZE[0]} still did not "
             "take the spatial route")
    with shard_cards(dev) as cards:
        grid = mesh.make_mesh(4, 2, devices=cards, repeat=True)
        frames = torch.from_numpy(rgba_frames(4, SEED + 9))
        out_h, out_w = LIB_BLOCK_SIZE["quarter"]
        got = mesh.sharded_quarter_pipeline(grid, out_h, out_w)(frames)
        want = tpipeline.quarter_pipeline(frames.to(dev), out_h, out_w,
                                          bg_color=(0, 0, 0, 255))
        if not all(torch.equal(g, w.cpu()) for g, w in zip(got, want)):
            fail("devices: sharded_quarter_pipeline != quarter_pipeline")
        ys, us, vs = (torch.from_numpy(p) for p in yuv_frames(6, SEED + 3))
        got = mesh.sharded_video_sixel_pipeline(
            grid, OUT_H, OUT_W, yuv=True, full_range=False)(ys, us, vs)
        words = resize_video_words(yuv420_to_rgba_words(
            ys.to(dev), us.to(dev), vs.to(dev), False), OUT_H, OUT_W)
        want = fs_dither_cube_fused(words, OUT_H, OUT_W).cpu()
        if not torch.equal(got, want):
            fail("devices: sharded_video_sixel_pipeline != the unsharded "
                 "convert, resize and cube dither")
        on_cards = [str(c) for c in grid.devices.flat]
        print(f"devices: mesh {grid.shape} of {on_cards}: "
              f"sharded_quarter_pipeline (4 frames of 1080p into "
              f"{out_h}x{out_w}, height over 'space') and "
              f"sharded_video_sixel_pipeline (6 frames of 4:2:0 1080p into "
              f"{OUT_H}x{OUT_W}, padded to 8) == the unsharded ops; the "
              f"phase took {time.perf_counter() - t_phase:.1f} s")
    print("devices: launches of the sharded runs (not in the kernels "
          f"line, which counts the one-card main path): {launches}")


def rgba_phase(reset_counts, read_counts, launches: dict,
               streams: dict) -> int:
    """The RGBA and scaled video windows on the card (RGBA_RUNS): each
    run's stream into ``streams`` (its CPU child's comes later), its
    launches added to ``launches``.  The opaque codec's windows must
    launch K1 and never ask for the background, the others neither K1
    nor the convert.  Returns the block frames the C emitter wrote."""
    import torch

    block_frames = 0
    for name, (mode, n, content) in RGBA_RUNS.items():
        reset_counts()
        BG_QUERIES[0] = 0
        t0 = time.perf_counter()
        stream = main_path_stream(mode, n, content=content)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = read_counts()
        queries = BG_QUERIES[0]
        print(f"main path: {name}: {n} frames in {t_run:.2f} s (host clock, "
              f"frames' making and emit included, the CPU children "
              f"running), {len(stream)} bytes, background queries "
              f"{queries}, launches {counts}")
        want = RGBA_KERNELS[mode] + (TRANSPORT_KERNELS["auto"]
                                     if mode in SIXEL_MODES else ())
        if content == "rgba":
            want += ("resize",)
            if queries:
                fail(f"main path {name}: an opaque window asked for the "
                     f"background {queries} times")
        elif counts["resize"]:
            fail(f"main path {name} launched the lean resize (K1)")
        if content == "rgba alpha" and not queries:
            fail(f"main path {name} never asked for the background")
        if counts["convert"] or counts["sws"]:
            fail(f"main path {name} launched the convert or the sws kernel")
        for k in want:
            if counts[k] <= 0:
                fail(f"main path {name} launched no {k} kernel")
        for k in counts:
            launches[k] += counts[k]
        if mode in BLOCK_MODES:
            block_frames += n
            if b"\033[0m\n" not in stream:
                fail(f"main path {name} wrote no row of cells")
        else:
            head = PIXEL_HEADS.get(mode, b"\033Pq")
            if stream.count(head) != n:
                fail(f"main path {name} wrote {stream.count(head)} images, "
                     f"expected {n}")
        streams[name] = stream
    return block_frames


def build_native():
    """The port's native helper: the C sixel assembler must build; the
    libav video decoder may not (no libav on the host)."""
    from timg_tpu_torch.native import runtime

    t0 = time.perf_counter()
    if runtime.load() is None:
        fail("the C sixel assembler (timg_tpu_torch/native/timg_native.cc) "
             "did not build:\n" + runtime.build_error("native"))
    video = runtime.load_video() is not None
    why = runtime.build_error("video").strip().splitlines()
    return time.perf_counter() - t0, video, (why[0] if why else "")


def main() -> int:
    if len(sys.argv) in (4, 5) and sys.argv[1] == "--main-path-stream":
        # child of the main-path phase: one mode's windows on the CPU
        # (the seeded frames, or "flat" ones)
        sys.path.insert(0, REPO)
        sys.stdout.buffer.write(main_path_stream(
            sys.argv[2], int(sys.argv[3]),
            content=sys.argv[4] if len(sys.argv) == 5 else "seeded"))
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--still-streams":
        # child of the stills phase: its share of the cases on the CPU
        sys.path.insert(0, REPO)
        STILL_CASES.update(decoder_cases(decoder_libraries()))
        still_streams_cpu(sys.argv[2], json.loads(sys.argv[3]))
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--library-payloads":
        # child of the library phase: every run on the CPU
        sys.path.insert(0, REPO)
        print(json.dumps({run: digests(library_payloads(run))
                          for run in LIB_RUNS}))
        return 0
    if not os.path.isdir(os.path.join(REPO, "timg_tpu_torch")):
        fail("run from a checkout of the repository (timg_tpu_torch/ "
             "is missing)")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: needs an NVIDIA GPU")
    os.environ["TIMG_TPU_TORCH_DEVICE"] = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"setup: {smi_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {name}")

    from concurrent.futures import ThreadPoolExecutor

    from timg_tpu_torch.ops import (_build, blocks_kernel, libsixel_kernel,
                                    resize_kernel, sixel_dcs_kernel,
                                    sixel_kernel, sixel_runs,
                                    sixel_runs_kernel, sws_kernel,
                                    yuv_kernel)
    from timg_tpu_torch.render import ansi, png_core, sixel_render
    counters = {   # kernel -> (module, its launch counter)
        "convert": (yuv_kernel, "LAUNCHES"),
        "sws": (sws_kernel, "LAUNCHES"),
        "resize": (resize_kernel, "LAUNCHES"),
        "resize_passes": (resize_kernel, "PASS_LAUNCHES"),
        "dither": (sixel_kernel, "LAUNCHES"),
        "tree": (sixel_kernel, "TREE_LAUNCHES"),
        "bucket": (libsixel_kernel, "BUCKET_LAUNCHES"),
        "table": (libsixel_kernel, "TABLE_LAUNCHES"),
        "cube_rgb": (sixel_kernel, "RGB_LAUNCHES"),
        "tree_rgb": (sixel_kernel, "TREE_RGB_LAUNCHES"),
        "quarter_cells": (blocks_kernel, "QUARTER_LAUNCHES"),
        "half_cells": (blocks_kernel, "HALF_LAUNCHES"),
        "run_counts": (sixel_runs_kernel, "COUNT_LAUNCHES"),
        "compact_runs": (sixel_runs_kernel, "COMPACT_LAUNCHES"),
        "dcs_lens": (sixel_dcs_kernel, "LENS_LAUNCHES"),
        "dcs_emit": (sixel_dcs_kernel, "EMIT_LAUNCHES"),
    }

    def reset_counts():
        for module, attr in counters.values():
            setattr(module, attr, 0)

    def read_counts():
        return {k: getattr(module, attr)
                for k, (module, attr) in counters.items()}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(build_native)      # g++ beside the nvccs
        _build.build()
        _build.load()
        t_native, video, why = native.result()
    print(f"setup: kernels built in {time.perf_counter() - t0:.1f} s; "
          f"native helper: C sixel assembler built ({t_native:.1f} s), "
          f"libav video decoder {'built' if video else 'not built: ' + why}")
    with open(_build.LOG_PATH) as f:
        for line in f:
            if any(k in line for k in ("registers", "Compiling entry",
                                       "spill")):
                print("setup: ptxas:", line.strip())
    deflate = png_core.load_libdeflate()
    print("setup: the PNG writer (kitty, iTerm2) deflates with "
          + (f"libdeflate ({deflate._name})" if deflate is not None else
             "the zlib fallback (no libdeflate on this host); its CPU "
             "children load the same"))

    if sys.argv[1:] == ["--devices-only"]:
        # the devices phase alone (a host of several cards), its stills'
        # one-card streams made first on cuda:0
        d = tempfile.mkdtemp(prefix="timg_devices_")
        still_inputs(d)
        streams = {name: cli_stream(still_argv(name, d),
                                    os.path.join(d, name + ".cuda"))
                   for name in DEVICE_STILLS}
        devices_phase(dev, d, streams, reset_counts, read_counts)
        print(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    results = kernel_phase(dev)
    transport_legs(dev)

    # the CPU references, running while the card runs the same work (two
    # torch threads each): one child a video mode and a sixel mode's flat
    # windows, one for the library
    env = dict(os.environ, TIMG_TPU_TORCH_DEVICE="cpu",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env.pop("TIMG_TPU_SIXEL_TRANSPORT", None)
    me = os.path.abspath(__file__)
    runs = {mode: (mode, n, "seeded") for mode, n in N_MAIN.items()}
    runs.update({f"{mode} flat": (mode, N_FLAT, "flat")
                 for mode in SIXEL_MODES})
    runs.update(RGBA_RUNS)
    children = {key: subprocess.Popen(
        [sys.executable, me, "--main-path-stream", mode, str(n), content],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for key, (mode, n, content) in runs.items()}
    children["library"] = subprocess.Popen(
        [sys.executable, me, "--library-payloads"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    assembled0 = dict(sixel_render.ASSEMBLED)
    emitted0 = dict(ansi.EMITTED)
    block_frames = 0        # frames the C ANSI emitter must have written
    try:
        streams, launches = {}, {k: 0 for k in counters}
        for mode, n in N_MAIN.items():
            reset_counts()
            t0 = time.perf_counter()
            stream = main_path_stream(mode, n)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
            counts = read_counts()
            print(f"main path: {mode}: {n} frames in {t_main:.2f} s (host "
                  f"clock, assembly included), {len(stream)} bytes, "
                  f"launches {counts}")
            base, _, resample = mode.partition(" ")
            if mode in BLOCK_MODES:   # again, split into its legs
                legs = []
                if main_path_stream(mode, n, legs) != stream:
                    fail(f"main path {mode}: a second run on the card "
                         "wrote another stream")
                block_frames += n
                print_legs(mode, legs)
            sixel = base not in (*BLOCK_MODES, *PIXEL_MODES)
            for k in PATH_KERNELS[mode] + (
                    TRANSPORT_KERNELS["auto"] if sixel else ()):
                if counts[k] <= 0:
                    fail(f"main path {mode} launched no {k} kernel")
            if resample and counts["convert"] + counts["resize"]:
                fail(f"main path {mode}: --resample=sws-bitexact launched "
                     "the convert or the resize")
            for k in counts:
                launches[k] += counts[k]
            if base in BLOCK_MODES:
                block_frames += n
                if b"\033[0m\n" not in stream:
                    fail(f"main path {mode} wrote no row of cells")
            elif base in PIXEL_MODES:
                got = stream.count(PIXEL_HEADS[base])
                if got != n:
                    fail(f"main path {mode} wrote {got} images, expected "
                         f"{n}")
            else:
                n_dcs = stream.count(b"\033Pq")
                if n_dcs != n:
                    fail(f"main path {mode} wrote {n_dcs} sixel images, "
                         f"expected {n}")
            streams[mode] = stream
        # each sixel mode again on flat windows, in each forced transport:
        # every transport must carry the window and write the plane's
        # stream
        try:
            for mode in SIXEL_MODES:
                flat = {}
                for transport in TRANSPORTS:
                    os.environ["TIMG_TPU_SIXEL_TRANSPORT"] = transport
                    reset_counts()
                    s0 = dict(sixel_runs.STATS)
                    t0 = time.perf_counter()
                    flat[transport] = main_path_stream(mode, N_FLAT,
                                                       content="flat")
                    torch.cuda.synchronize()
                    t_main = time.perf_counter() - t0
                    counts = read_counts()
                    moved = {k: sixel_runs.STATS[k] - s0[k] for k in s0}
                    print(f"main path: {mode} flat, transport {transport}: "
                          f"{N_FLAT} frames in {t_main:.2f} s (host clock), "
                          f"{len(flat[transport])} bytes, {moved}, "
                          f"launches {counts}")
                    if moved[f"frames_{transport}"] != N_FLAT:
                        fail(f"main path {mode} flat: the {transport} "
                             f"transport moved {moved} of {N_FLAT} frames")
                    for k in PATH_KERNELS[mode] + TRANSPORT_KERNELS[transport]:
                        if counts[k] <= 0:
                            fail(f"main path {mode} flat, {transport}: "
                                 f"launched no {k} kernel")
                    for k in counts:
                        launches[k] += counts[k]
                for transport in ("runs", "dcs"):
                    if flat[transport] != flat["plane"]:
                        fail(f"main path {mode} flat: the {transport} "
                             "stream != the plane stream: "
                             + first_difference(flat[transport],
                                                flat["plane"]))
                streams[f"{mode} flat"] = flat["plane"]
        finally:
            os.environ.pop("TIMG_TPU_SIXEL_TRANSPORT", None)
        block_frames += rgba_phase(reset_counts, read_counts, launches,
                                   streams)
        payloads = {}
        for run in LIB_RUNS:
            reset_counts()
            t0 = time.perf_counter()
            out = library_payloads(run)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            counts = read_counts()
            print(f"library path: {run}: {len(out)} payloads in {t_run:.2f} "
                  f"s (host clock, set-up and assembly included), "
                  f"{sum(map(len, out))} bytes, launches {counts}")
            for k in LIB_KERNELS[run]:
                if counts[k] <= 0:
                    fail(f"library path {run} launched no {k} kernel")
            for k in counts:
                launches[k] += counts[k]
            if run in LIB_BLOCK_SIZE:
                block_frames += len(out)
                rows = LIB_BLOCK_SIZE[run][0] // 2
                if len(out) != N_LIB or not all(
                        p.count(b"\033[0m\n") == rows for p in out):
                    fail(f"library path {run}: expected {N_LIB} payloads "
                         f"of {rows} rows of cells")
            elif run in PIXEL_MODES:
                if len(out) != N_LIB or not all(
                        p.startswith(PIXEL_HEADS[run]) for p in out):
                    fail(f"library path {run}: expected {N_LIB} {run} "
                         "payloads")
            elif len(out) != N_LIB or not all(
                    p.startswith(b"\033Pq") and p.endswith(b"\033\\")
                    for p in out):
                fail(f"library path {run}: expected {N_LIB} sixel payloads")
            payloads[run] = digests(out)
        assembled = {k: sixel_render.ASSEMBLED[k] - assembled0[k]
                     for k in assembled0}
        print(f"assembler: the C copy assembled {assembled['c']} frames, the "
              f"Python twin {assembled['python']}")
        if assembled["python"] or not assembled["c"]:
            fail("the main paths' frames were not all assembled by the C "
                 "sixel assembler")
        emitted = {k: ansi.EMITTED[k] - emitted0[k] for k in emitted0}
        print(f"emitter: the C ANSI emitter wrote {emitted['c']} frames, the "
              f"Python twin {emitted['python']}")
        if emitted["python"] or emitted["c"] != block_frames:
            fail(f"of the {block_frames} block frames, the C ANSI emitter "
                 f"wrote {emitted['c']} and the Python twin "
                 f"{emitted['python']}")
        library_stages(dev)
        for mode, child in children.items():
            out, err = child.communicate(timeout=900)
            if child.returncode != 0:
                fail(f"CPU reference run ({mode}) failed:\n"
                     + err.decode(errors="replace")[-3000:])
            if mode == "library":
                cpu = json.loads(out)
                for run in LIB_RUNS:
                    if cpu[run] != payloads[run]:
                        bad = sum(a != b for a, b in zip(cpu[run],
                                                         payloads[run]))
                        fail(f"library path {run}: {bad} of {N_LIB} cuda "
                             "payloads differ from the cpu payloads")
                print("library path: every run's cuda payloads == cpu "
                      "payloads")
                continue
            if out != streams[mode]:
                # a second run on the card tells a card that is not
                # repeatable from one that repeats a different stream
                again = main_path_stream(runs[mode][0], runs[mode][1],
                                         content=runs[mode][2])
                which = ("equals the cpu stream" if again == out else
                         "equals the first" if again == streams[mode]
                         else "differs from both")
                fail(f"{mode}: cuda stream ({len(streams[mode])} B) != cpu "
                     f"stream ({len(out)} B): "
                     + first_difference(streams[mode], out)
                     + f"; a second cuda run {which}")
            print(f"main path: {mode}: cuda stream == cpu stream")
        # the pixel modes and the RGBA windows again, split into their
        # legs, now that no CPU child competes for the host's cores with
        # the pool's deflate, the stack and the copies
        for mode in PIXEL_MODES:
            legs = []
            if main_path_stream(mode, N_MAIN[mode], legs) != streams[mode]:
                fail(f"main path {mode}: a second run on the card wrote "
                     "another stream")
            print_legs(mode, legs)
        for key, (mode, n, content) in RGBA_RUNS.items():
            legs = []
            if main_path_stream(mode, n, legs, content) != streams[key]:
                fail(f"main path {key}: a second run on the card wrote "
                     "another stream")
            print_legs(key, legs)
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()

    def later_slices(d, still_streams):
        serve_phase(d, smi_line, reset_counts, read_counts)
        devices_phase(dev, d, still_streams, reset_counts, read_counts)

    stills_phase(dev, reset_counts, read_counts, launches,
                 after=later_slices)

    entries = [
        ("yuv420_to_rgba", "convert", "yuv420.cu", "timg_tpu/ops/yuv.py:109"),
        ("sws_yuv420_to_rgba", "sws", "sws_yuv420.cu",
         "timg_tpu/ops/sws_resize.py:261"),
        ("resize_words", "resize", "resize_words.cu",
         "timg_tpu/ops/resize_pallas.py:227"),
        ("resize_passes", "resize_passes", "resize_passes.cu",
         "timg_tpu/ops/resize_pallas.py:374"),
        ("fs_dither_cube", "dither", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel_pallas3.py:391"),
        ("bucket_tables", "bucket", "bucket_tables.cu",
         "timg_tpu/ops/sixel_pallas3.py:728"),
        ("fs_dither_table", "table", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel_pallas3.py:662"),
        ("fs_dither_tree", "tree", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel_pallas3.py:876"),
        ("fs_dither_cube_rgb", "cube_rgb", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel_pallas.py:124"),
        ("fs_dither_tree_rgb", "tree_rgb", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel.py:373"),
        ("quarter_cells", "quarter_cells", "block_cells.cu",
         "timg_tpu/ops/blocks.py:82"),
        ("half_cells", "half_cells", "block_cells.cu",
         "timg_tpu/ops/blocks.py:185"),
        ("band_run_counts", "run_counts", "sixel_runs.cu",
         "timg_tpu/ops/sixel_runs.py:77"),
        ("compact_runs", "compact_runs", "sixel_runs.cu",
         "timg_tpu/ops/sixel_runs.py:86"),
        ("dcs_band_lens", "dcs_lens", "sixel_dcs.cu",
         "timg_tpu/ops/sixel_dcs.py:253"),
        ("dcs_emit", "dcs_emit", "sixel_dcs.cu",
         "timg_tpu/ops/sixel_dcs.py:336"),
    ]
    kernels = [dict(name=n, route="cuda",
                    source=f"timg_tpu_torch/csrc/{src}", replaces=rep,
                    launches=launches[k], **results[k])
               for n, k, src, rep in entries]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
