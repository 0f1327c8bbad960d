#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (timg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them.  Phases:

1. set-up: print the card (nvidia-smi name and power limit) and build
   the CUDA kernels from timg_tpu_torch/csrc/ (one nvcc per source, in
   parallel; timed);
2. kernels: a seeded window of 32 frames of 1080p 4:2:0 video, converted
   on the card and resized to 720x1280 by the resize kernel, then
   dithered at 720 rows and at 722 rows padded to 726 with background
   rows by each dither kernel: FS cube; libsixel (per-frame palettes
   from the host, with one flat frame whose diffuse flag is 0, the
   bucket-table build and the table dither); and the median-cut tree.
   Each kernel must equal its plain PyTorch version byte for byte (the
   resize's on CPU copies, the others' on the card); all are timed with
   CUDA events, and the host palette time per frame is printed;
3. main path: 1080p windows through the port's VideoSource window
   (convert -> resize -> dither on the card -> plane fetch ->
   SixelCanvas assembly), as the CLI runs `-g160x48 -ps --dither=MODE
   -b black` on a terminal with 8x16-pixel cells: two 8-frame windows
   with cube, one with libsixel and one with adaptive.  The launch
   counters are reset just before each mode's run and read just after;
   every kernel of that mode must have launched.  Each mode's sixel
   stream must equal the same windows run with TIMG_TPU_TORCH_DEVICE=cpu
   in a subprocess.

The CLI itself is not driven: its video decoder (timg_tpu/native, libav
and libdeflate) does not build where those headers are missing.

Output: progress lines, then one JSON line of per-kernel results, the
card's nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

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

    from timg_tpu.colors import parse_color
    from timg_tpu.geometry import calc_scale_to_fit
    from timg_tpu.options import DisplayOptions, SixelOptions
    from timg_tpu.render.renderer import Renderer
    from timg_tpu.render.sequencer import BufferedWriteSequencer, SeqType
    from timg_tpu.sources.video_source import _WINDOW
    from timg_tpu_torch.render.sixel_render import SixelCanvas
    from timg_tpu_torch.sources.video_source import VideoSource

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

    from timg_tpu.ops import libsixel_quant as lsq
    from timg_tpu.ops.sixel_np import median_cut_tree
    from timg_tpu_torch.ops import libsixel_kernel as lib
    from timg_tpu_torch.ops import resize_kernel, sixel_kernel
    from timg_tpu_torch.ops.resize import resize_video_words_plain
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
    results["resize"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: resize_kernel.resize_video_words_cuda(
            words, OUT_H, OUT_W), 20),
        plain_ms=cuda_ms(lambda: resize_video_words_plain(
            words, OUT_H, OUT_W), 3))

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
    results["dither"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: sixel_kernel.fs_dither_cube_cuda(
            w720, OUT_H, OUT_W), 10),
        plain_ms=cuda_ms(lambda: sixel_kernel.fs_dither_cube_plain(
            w720, OUT_H, OUT_W), 1))

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
    results["bucket"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: lib.build_bucket_tables_cuda(pals), 20),
        plain_ms=cuda_ms(lambda: lib.build_bucket_tables_plain(pals), 3))

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
            padded, tables, palw, diffs, OUT_H + 6, OUT_W), 1))

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
            padded, levels, leaves, OUT_H + 6, OUT_W), 1))

    for name, r in results.items():
        print(f"kernels: {name}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms per {N_KERNEL}-frame window")
    return results


PATH_KERNELS = {"cube": ("resize", "dither"),
                "libsixel": ("resize", "bucket", "table"),
                "adaptive": ("resize", "tree")}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--main-path-stream":
        # child of the main-path phase: one mode's windows on the CPU
        sys.path.insert(0, REPO)
        sys.stdout.buffer.write(main_path_stream(sys.argv[2],
                                                 int(sys.argv[3])))
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

    from timg_tpu_torch.ops import (_build, libsixel_kernel, resize_kernel,
                                    sixel_kernel)
    counters = {   # kernel -> (module, its launch counter)
        "resize": (resize_kernel, "LAUNCHES"),
        "dither": (sixel_kernel, "LAUNCHES"),
        "tree": (sixel_kernel, "TREE_LAUNCHES"),
        "bucket": (libsixel_kernel, "BUCKET_LAUNCHES"),
        "table": (libsixel_kernel, "TABLE_LAUNCHES"),
    }
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"setup: kernels built in {time.perf_counter() - t0:.1f} s")
    with open(_build.LOG_PATH) as f:
        for line in f:
            if any(k in line for k in ("registers", "Compiling entry",
                                       "spill")):
                print("setup: ptxas:", line.strip())

    results = kernel_phase(dev)

    # the CPU reference streams, one child a mode, running while the card
    # runs the same windows (two torch threads each)
    env = dict(os.environ, TIMG_TPU_TORCH_DEVICE="cpu",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    children = {mode: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--main-path-stream",
         mode, str(n)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for mode, n in N_MAIN.items()}
    try:
        streams, launches = {}, {k: 0 for k in counters}
        for mode, n in N_MAIN.items():
            for module, attr in counters.values():
                setattr(module, attr, 0)
            t0 = time.perf_counter()
            stream = main_path_stream(mode, n)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
            counts = {k: getattr(module, attr)
                      for k, (module, attr) in counters.items()}
            print(f"main path: {mode}: {n} frames in {t_main:.2f} s (host "
                  f"clock, assembly included), {len(stream)} bytes, "
                  f"launches {counts}")
            for k in PATH_KERNELS[mode]:
                if counts[k] <= 0:
                    fail(f"main path {mode} launched no {k} kernel")
                launches[k] += counts[k]
            n_dcs = stream.count(b"\033Pq")
            if n_dcs != n:
                fail(f"main path {mode} wrote {n_dcs} sixel images, "
                     f"expected {n}")
            streams[mode] = stream
        for mode, child in children.items():
            out, err = child.communicate(timeout=900)
            if child.returncode != 0:
                fail(f"CPU main-path run ({mode}) failed:\n"
                     + err.decode(errors="replace")[-3000:])
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

    kernels = [
        dict(name="resize_words", route="cuda",
             source="timg_tpu_torch/csrc/resize_words.cu",
             replaces="timg_tpu/ops/resize_pallas.py:173",
             launches=launches["resize"], **results["resize"]),
        dict(name="fs_dither_cube", route="cuda",
             source="timg_tpu_torch/csrc/fs_dither_cube.cu",
             replaces="timg_tpu/ops/sixel_pallas3.py:337",
             launches=launches["dither"], **results["dither"]),
        dict(name="bucket_tables", route="cuda",
             source="timg_tpu_torch/csrc/bucket_tables.cu",
             replaces="timg_tpu/ops/sixel_pallas3.py:728",
             launches=launches["bucket"], **results["bucket"]),
        dict(name="fs_dither_table", route="cuda",
             source="timg_tpu_torch/csrc/fs_dither_table.cu",
             replaces="timg_tpu/ops/sixel_pallas3.py:600",
             launches=launches["table"], **results["table"]),
        dict(name="fs_dither_tree", route="cuda",
             source="timg_tpu_torch/csrc/fs_dither_cube.cu",
             replaces="timg_tpu/ops/sixel_pallas3.py:823",
             launches=launches["tree"], **results["tree"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
