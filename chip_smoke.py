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
2. kernels: a seeded window of 32 frames of 1080p 4:2:0 video, converted
   on the card by the convert kernel (byte-equal to its plain version in
   both ranges, timed at 32 and at the CLI's 8 frames, split by
   torch.profiler) and resized to 720x1280 by the resize kernel (also
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
   scan needs.
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
   must write the same stream.  Each mode's stream must equal the same
   windows run with TIMG_TPU_TORCH_DEVICE=cpu in a subprocess;
4. library path: timg_tpu_torch.models.get("sixel") at 720x1280 on 8
   seeded 1080p RGBA frames with a transparent region (bg opaque black),
   in cube, adaptive (a tree per frame) and adaptive with
   adaptive_reuse, and render_batch_yuv on 8 frames of 1080p 4:2:0 in
   cube; the quarter model at 96x320 and the half model at 96x160 on
   the same RGBA frames.  The payload lists must equal a CPU
   subprocess's; the stage times of the cube run are printed.

Before each run of phases 3 and 4 every launch counter is set to 0, and
just after it every kernel of that run must have launched.  The C
assembler must have assembled every sixel frame and the C ANSI emitter
written every block frame (the Python twins none).  The CLI itself is
not driven where the video decoder does not build.

Output: progress lines, then one JSON line of per-kernel results, the
card's nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
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
# dithers, then quarter and half blocks
N_MAIN = {"cube": 16, "libsixel": 8, "adaptive": 8, "quarter": 16,
          "half": 16}
# the block modes' cells in pixels and the CLI's width_stretch (a
# terminal whose cell size is unknown: 1.0, doubled for quarter blocks)
BLOCK_MODES = {"quarter": (2, 2.0), "half": (1, 1.0)}
GRID_W, GRID_H = 160, 48    # -g160x48
BG_WORD = -(1 << 24)    # opaque black RGBA word, as -b black pads rows
N_LIB = 8               # frames a library-path run renders
# library-path runs: name -> (dither, adaptive_reuse, input)
LIB_RUNS = {"cube": ("cube", False, "rgba"),
            "adaptive": ("adaptive", False, "rgba"),
            "adaptive_reuse": ("adaptive", True, "rgba"),
            "yuv": ("cube", False, "yuv"),
            "quarter": (None, False, "rgba"),
            "half": (None, False, "rgba")}
# the block models' output pixels (the library's -g160x48 canvas)
LIB_BLOCK_SIZE = {"quarter": (96, 320), "half": (96, 160)}
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


def yuv_frames(n: int, seed: int):
    """Seeded 4:2:0 planes: moving gradients plus a noise band, so both
    smooth areas and every dither state occur."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ch, cw = IN_H // 2, IN_W // 2
    yy, xx = np.mgrid[0:IN_H, 0:IN_W]
    cy, cx = np.mgrid[0:ch, 0:cw]
    ys = np.empty((n, IN_H, IN_W), np.uint8)
    us = np.empty((n, ch, cw), np.uint8)
    vs = np.empty((n, ch, cw), np.uint8)
    for i in range(n):
        base = 16 + (xx * 180 // IN_W + yy * 40 // IN_H + 7 * i) % 220
        noise = rng.integers(0, 24, (IN_H, IN_W))
        band = slice(IN_H // 3, IN_H // 2)
        noise[band] = rng.integers(0, 256, (IN_H // 2 - IN_H // 3, IN_W))
        ys[i] = np.clip(base + noise - 12, 0, 255)
        us[i] = 64 + (cx * 128 // cw + 3 * i) % 128
        vs[i] = np.clip(60 + cy * 140 // ch
                        + rng.integers(0, 16, (ch, cw)), 0, 255)
    return ys, us, vs


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


def main_path_stream(mode: str, n: int, legs: list = None) -> bytes:
    """n frames of 1080p through the port's video window, in 8-frame
    windows, dithered in ``mode`` into the port's SixelCanvas, or in
    quarter or half blocks into its UnicodeBlockCanvas; returns the
    written stream.  Given a list ``legs`` in a block mode, appends each
    window's legs in seconds (BLOCK_LEGS: the planes' making, a window's
    share; ``timed_block_legs``; the canvas's emit of its frames)."""
    from concurrent.futures import ThreadPoolExecutor

    from timg_tpu_torch.colors import parse_color
    from timg_tpu_torch.geometry import calc_scale_to_fit
    from timg_tpu_torch.options import DisplayOptions, SixelOptions
    from timg_tpu_torch.render.ansi import UnicodeBlockCanvas
    from timg_tpu_torch.render.renderer import Renderer
    from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType
    from timg_tpu_torch.render.sixel_render import SixelCanvas
    from timg_tpu_torch.sources.video_source import _WINDOW, VideoSource

    if mode in BLOCK_MODES:
        opts = block_options(mode)
    else:
        opts = DisplayOptions()
        opts.cell_x_px, opts.cell_y_px = 8, 16
        opts.width, opts.height = GRID_W * 8, GRID_H * 16   # -g160x48
        opts.sixel_batch_dither = mode
    bg = parse_color("black")
    opts.bgcolor_getter = lambda: bg
    tw, th, _ = calc_scale_to_fit(IN_W, IN_H, opts)

    src = VideoSource("chip-smoke.y4m")
    src._options = opts
    src._target = (tw, th)
    src._full_range = False
    t0 = time.perf_counter()
    ys, us, vs = yuv_frames(n, SEED + 1)
    planes_s = (time.perf_counter() - t0) * _WINDOW / n
    timing = legs is not None and mode in BLOCK_MODES

    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(max_workers=5) as pool:
        path = os.path.join(tmp, "stream.out")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        sequencer = BufferedWriteSequencer(
            fd, allow_frame_skipping=False, max_queue_len=4,
            debug_no_frame_delay=True, interrupt_flag=lambda: False)
        # the CLI's canvas: compression pool of queue_len + 1 workers
        if mode in BLOCK_MODES:
            canvas = UnicodeBlockCanvas(sequencer,
                                        use_quarter=mode == "quarter")
        else:
            canvas = SixelCanvas(sequencer, SixelOptions(), opts,
                                 dither=mode, executor=pool)
        sink = Renderer.create(canvas, opts, 1, 1, 0.0, 0.0).render_cb("")
        last_h = -1
        for k in range(0, n, _WINDOW):
            window = [(ys[i], us[i], vs[i]) for i in range(k, k + _WINDOW)]
            leg = dict.fromkeys(BLOCK_LEGS, 0.0)
            leg["planes"] = planes_s
            with (timed_block_legs(leg) if timing
                  else contextlib.nullcontext()):
                frames = src._process_window(window, "yuv")
            t0 = time.perf_counter()
            for j, frame in enumerate(frames):
                seq = (SeqType.START_OF_ANIMATION if k + j == 0
                       else SeqType.ANIMATION_FRAME)
                sink(src.indentation, -last_h if last_h > 0 else 0, frame,
                     seq, 40.0 * (k + j + 1))
                last_h = frame.shape[0]
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
    timg_tpu_torch.models.get("sixel") at 720x1280, or through the
    quarter or half block model at LIB_BLOCK_SIZE -> the payloads."""
    from timg_tpu_torch import models

    dither, reuse, kind = LIB_RUNS[run]
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
                "half": ("convert", "resize", "half_cells")}
LIB_KERNELS = {"cube": ("cube_rgb",), "adaptive": ("tree_rgb",),
               "adaptive_reuse": ("tree_rgb",),
               "yuv": ("convert", "resize", "cube_rgb"),
               "quarter": ("quarter_cells",), "half": ("half_cells",)}


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
    if len(sys.argv) == 4 and sys.argv[1] == "--main-path-stream":
        # child of the main-path phase: one mode's windows on the CPU
        sys.path.insert(0, REPO)
        sys.stdout.buffer.write(main_path_stream(sys.argv[2],
                                                 int(sys.argv[3])))
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
                                    resize_kernel, sixel_kernel, yuv_kernel)
    from timg_tpu_torch.render import ansi, sixel_render
    counters = {   # kernel -> (module, its launch counter)
        "convert": (yuv_kernel, "LAUNCHES"),
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

    results = kernel_phase(dev)

    # the CPU references, running while the card runs the same work (two
    # torch threads each): one child a video mode, one for the library
    env = dict(os.environ, TIMG_TPU_TORCH_DEVICE="cpu",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    me = os.path.abspath(__file__)
    children = {mode: subprocess.Popen(
        [sys.executable, me, "--main-path-stream", mode, str(n)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for mode, n in N_MAIN.items()}
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
            if mode in BLOCK_MODES:   # again, split into its legs
                legs = []
                if main_path_stream(mode, n, legs) != stream:
                    fail(f"main path {mode}: a second run on the card "
                         "wrote another stream")
                block_frames += n
                for k, leg in enumerate(legs):
                    print(f"main path: {mode} window {k} legs (host clock, "
                          "synchronized): " + ", ".join(
                              f"{key} {leg[key] * 1e3:.3f} ms"
                              for key in BLOCK_LEGS))
            for k in PATH_KERNELS[mode]:
                if counts[k] <= 0:
                    fail(f"main path {mode} launched no {k} kernel")
            for k in counts:
                launches[k] += counts[k]
            if mode in BLOCK_MODES:
                block_frames += n
                if b"\033[0m\n" not in stream:
                    fail(f"main path {mode} wrote no row of cells")
            else:
                n_dcs = stream.count(b"\033Pq")
                if n_dcs != n:
                    fail(f"main path {mode} wrote {n_dcs} sixel images, "
                         f"expected {n}")
            streams[mode] = stream
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
                again = main_path_stream(mode, N_MAIN[mode])
                which = ("equals the cpu stream" if again == out else
                         "equals the first" if again == streams[mode]
                         else "differs from both")
                fail(f"{mode}: cuda stream ({len(streams[mode])} B) != cpu "
                     f"stream ({len(out)} B): "
                     + first_difference(streams[mode], out)
                     + f"; a second cuda run {which}")
            print(f"main path: {mode}: cuda stream == cpu stream")
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()

    entries = [
        ("yuv420_to_rgba", "convert", "yuv420.cu", "timg_tpu/ops/yuv.py:109"),
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
    ]
    kernels = [dict(name=n, route="cuda",
                    source=f"timg_tpu_torch/csrc/{src}", replaces=rep,
                    launches=launches[k], **results[k])
               for n, k, src, rep in entries]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
