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
   on the card and resized to 720x1280 by the resize kernel, then
   dithered at 720 rows and at 722 rows padded to 726 with background
   rows by each dither kernel: FS cube on words (K6) and on bytes (K9,
   3 and 4 channels); libsixel (per-frame palettes from the host, with
   one flat frame whose diffuse flag is 0, the bucket-table build and
   the table dither); and the median-cut tree on words (K7) and on
   bytes.  Each kernel must equal its plain PyTorch version byte for
   byte (the resize's on CPU copies, the others' on the card); all are
   timed with CUDA events beside their bound (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time;
3. video main path: 1080p windows through the port's VideoSource window
   (convert -> resize -> dither on the card -> plane fetch ->
   SixelCanvas assembly), as the CLI runs `-g160x48 -ps --dither=MODE
   -b black` on a terminal with 8x16-pixel cells: two 8-frame windows
   with cube, one with libsixel and one with adaptive.  Each mode's
   sixel stream must equal the same windows run with
   TIMG_TPU_TORCH_DEVICE=cpu in a subprocess;
4. library path: timg_tpu_torch.models.get("sixel") at 720x1280 on 8
   seeded 1080p RGBA frames with a transparent region (bg opaque black),
   in cube, adaptive (a tree per frame) and adaptive with
   adaptive_reuse, and render_batch_yuv on 8 frames of 1080p 4:2:0 in
   cube.  The payload lists must equal a CPU subprocess's; the stage
   times of the cube run are printed.

Before each run of phases 3 and 4 every launch counter is set to 0, and
just after it every kernel of that run must have launched.  The C
assembler must have assembled every frame (the Python twin none).  The
CLI itself is not driven where the video decoder does not build.

Output: progress lines, then one JSON line of per-kernel results, the
card's nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

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
# frames through the main path per dither mode (8-frame windows)
N_MAIN = {"cube": 16, "libsixel": 8, "adaptive": 8}
BG_WORD = -(1 << 24)    # opaque black RGBA word, as -b black pads rows
N_LIB = 8               # frames a library-path run renders
# library-path runs: name -> (dither, adaptive_reuse, input)
LIB_RUNS = {"cube": ("cube", False, "rgba"),
            "adaptive": ("adaptive", False, "rgba"),
            "adaptive_reuse": ("adaptive", True, "rgba"),
            "yuv": ("cube", False, "yuv")}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores; also used
                            # for the int32 ALU work of the libsixel kernels
# operations a pixel of each dither kernel, counted from
# csrc/fs_dither_cube.cu and csrc/fs_dither_table.cu.  f32 kernels: the
# row-above mix (15), the incoming sum and clip (15), the error (3) and
# the quantizer (cube: 18 with the index; tree: 3 roundings, 8 levels of
# 4, the leaf unpack 3 = 38).  Table kernel: four truncated shares with
# clamps a channel (60), the key (5), the color unpack and offsets (6),
# the row-above offsets (12).
CUBE_OPS_PER_PX = 51
TREE_OPS_PER_PX = 71
TABLE_OPS_PER_PX = 83


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


def main_path_stream(mode: str, n: int) -> bytes:
    """n frames of 1080p through the port's video window, in 8-frame
    windows, dithered in ``mode``, into the port's SixelCanvas; returns
    the written stream."""
    from concurrent.futures import ThreadPoolExecutor

    from timg_tpu_torch.colors import parse_color
    from timg_tpu_torch.geometry import calc_scale_to_fit
    from timg_tpu_torch.options import DisplayOptions, SixelOptions
    from timg_tpu_torch.render.renderer import Renderer
    from timg_tpu_torch.render.sequencer import BufferedWriteSequencer, SeqType
    from timg_tpu_torch.render.sixel_render import SixelCanvas
    from timg_tpu_torch.sources.video_source import _WINDOW, VideoSource

    opts = DisplayOptions()
    opts.cell_x_px, opts.cell_y_px = 8, 16
    opts.width, opts.height = 160 * 8, 48 * 16          # -g160x48
    opts.sixel_batch_dither = mode
    bg = parse_color("black")
    opts.bgcolor_getter = lambda: bg
    tw, th, _ = calc_scale_to_fit(IN_W, IN_H, opts)

    src = VideoSource("chip-smoke.y4m")
    src._options = opts
    src._target = (tw, th)
    src._full_range = False
    ys, us, vs = yuv_frames(n, SEED + 1)

    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(max_workers=5) as pool:
        path = os.path.join(tmp, "stream.out")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        sequencer = BufferedWriteSequencer(
            fd, allow_frame_skipping=False, max_queue_len=4,
            debug_no_frame_delay=True, interrupt_flag=lambda: False)
        # the CLI's canvas: compression pool of queue_len + 1 workers
        canvas = SixelCanvas(sequencer, SixelOptions(), opts, dither=mode,
                             executor=pool)
        sink = Renderer.create(canvas, opts, 1, 1, 0.0, 0.0).render_cb("")
        last_h = -1
        for k in range(0, n, _WINDOW):
            window = [(ys[i], us[i], vs[i]) for i in range(k, k + _WINDOW)]
            for j, frame in enumerate(src._process_window(window, "yuv")):
                seq = (SeqType.START_OF_ANIMATION if k + j == 0
                       else SeqType.ANIMATION_FRAME)
                sink(src.indentation, -last_h if last_h > 0 else 0, frame,
                     seq, 40.0 * (k + j + 1))
                last_h = frame.shape[0]
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


def max_abs_err(a, b) -> int:
    """Largest absolute difference, per byte channel of RGBA words."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.int32:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return int((a.long() - b.long()).abs().max())


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
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
    from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words

    ys, us, vs = yuv_frames(N_KERNEL, SEED)
    planes = [torch.from_numpy(p).to(dev) for p in (ys, us, vs)]
    words = yuv420_to_rgba_words(*planes, False)
    torch.cuda.synchronize()
    results = {}

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
                N_KERNEL * 3 * macs * 2))
    del planes

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
    results["bucket"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: lib.build_bucket_tables_cuda(pals), 20),
        plain_ms=cuda_ms(lambda: lib.build_bucket_tables_plain(pals), 3),
        library_ms=cuda_ms(lambda: torch.cdist(
            bases.expand(N_KERNEL, -1, -1), pals_f32).argmin(dim=2), 3),
        **bound(N_KERNEL * (lib.PALETTE_SIZE * 3 * 4 + lib.N_BUCKETS),
                N_KERNEL * lib.N_BUCKETS * lib.PALETTE_SIZE * 10))

    palw = lib.palette_words(pals)
    errs = []
    for w_in, h in inputs:
        got = lib.fs_dither_table_cuda(w_in, tables, palw, diffs, h, OUT_W)
        want = lib.fs_dither_table_plain(w_in, tables, palw, diffs, h, OUT_W)
        errs.append(check_equal(f"fs_dither_table at {h}x{OUT_W}", got,
                                want))
    print(f"kernels: fs_dither_table {OUT_H}x{OUT_W} and {OUT_H + 6}x"
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
                px726 * TABLE_OPS_PER_PX))

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

    for name, r in results.items():
        lib_ms = r["library_ms"]
        print(f"kernels: {name}: kernel {r['ms']:.6f} ms, plain "
              f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), library "
              f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'} per "
              f"{N_KERNEL}-frame window")
    return results


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
    timg_tpu_torch.models.get("sixel") at 720x1280 -> the payloads."""
    from timg_tpu_torch import models

    dither, reuse, kind = LIB_RUNS[run]
    model = models.get("sixel")(out_h=OUT_H, out_w=OUT_W,
                                bg_color=(0, 0, 0, 255), dither=dither,
                                adaptive_reuse=reuse)
    if kind == "yuv":
        ys, us, vs = yuv_frames(N_LIB, SEED + 2)
        return model.render_batch_yuv(ys, us, vs, full_range=False)
    return model.render_batch(rgba_frames(N_LIB, SEED + 3))


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


PATH_KERNELS = {"cube": ("resize", "dither"),
                "libsixel": ("resize", "bucket", "table"),
                "adaptive": ("resize", "tree")}
LIB_KERNELS = {"cube": ("cube_rgb",), "adaptive": ("tree_rgb",),
               "adaptive_reuse": ("tree_rgb",), "yuv": ("resize", "cube_rgb")}


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

    from timg_tpu_torch.ops import (_build, libsixel_kernel, resize_kernel,
                                    sixel_kernel)
    from timg_tpu_torch.render import sixel_render
    counters = {   # kernel -> (module, its launch counter)
        "resize": (resize_kernel, "LAUNCHES"),
        "dither": (sixel_kernel, "LAUNCHES"),
        "tree": (sixel_kernel, "TREE_LAUNCHES"),
        "bucket": (libsixel_kernel, "BUCKET_LAUNCHES"),
        "table": (libsixel_kernel, "TABLE_LAUNCHES"),
        "cube_rgb": (sixel_kernel, "RGB_LAUNCHES"),
        "tree_rgb": (sixel_kernel, "TREE_RGB_LAUNCHES"),
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
            for k in PATH_KERNELS[mode]:
                if counts[k] <= 0:
                    fail(f"main path {mode} launched no {k} kernel")
            for k in counts:
                launches[k] += counts[k]
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
            if len(out) != N_LIB or not all(
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
                fail(f"{mode}: cuda stream ({len(streams[mode])} B) != cpu "
                     f"stream ({len(out)} B)")
            print(f"main path: {mode}: cuda sixel stream == cpu sixel "
                  "stream")
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()

    entries = [
        ("resize_words", "resize", "resize_words.cu",
         "timg_tpu/ops/resize_pallas.py:173"),
        ("fs_dither_cube", "dither", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel_pallas3.py:337"),
        ("bucket_tables", "bucket", "bucket_tables.cu",
         "timg_tpu/ops/sixel_pallas3.py:728"),
        ("fs_dither_table", "table", "fs_dither_table.cu",
         "timg_tpu/ops/sixel_pallas3.py:600"),
        ("fs_dither_tree", "tree", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel_pallas3.py:823"),
        ("fs_dither_cube_rgb", "cube_rgb", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel_pallas.py:95"),
        ("fs_dither_tree_rgb", "tree_rgb", "fs_dither_cube.cu",
         "timg_tpu/ops/sixel.py:373"),
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
