#!/usr/bin/env python3
"""The DCS kernels against other checkouts', in one process on one CUDA
card.

    python3 tools/dcs_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Each other checkout's kernel library is built by that checkout's own
``timg_tpu_torch/ops/_build.py``; its C entries ``timg_dcs_band_lens``
and ``timg_dcs_emit`` take the same arguments as this one's and are
called as the port's wrappers call them (outputs allocated a call, the
band buffers zeroed, the stream from ``torch.cuda.current_stream()``).
On the cube dither's index planes of chip_smoke's seeded window (as its
transport phase makes them) and on its flat, film-like and noise windows
(``transport_windows``), all 720x1280, at B=32 and at the CLI's B=8,
both kernels of every library are checked byte-equal to the plain
versions (``batch_band_lens_plain``, ``batch_encode_plain``), then timed
in turns (others, this, this, others reversed) with chip_smoke's
yardsticks: device time in a CUDA graph of 20 calls and a call by CUDA
events over 50 calls.  Then auto's fall-back leg (``fetch_planes_or_runs``
where neither the runs nor the DCS bands carry) on the film-like and
noise windows at B=8, with each library's lens kernel: the run counts
and their fetch, the DCS lens kernel and the fetch of the lengths and
colour counts, the plane's fetch; host clock, each step ended by its
copy, 20 runs a library in turns.  Last, ptxas' register and shared
memory lines of each library's DCS kernels (its ``nvcc.log``).  Imports
no jax.
"""

import ctypes
import importlib.util
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def other_kernels(checkout: str, k: int):
    """(nvcc log path, lens(p, h, w), emit(p, h, w, cap)) of another
    checkout's DCS kernels, built by its own _build.py."""
    import torch

    spec = importlib.util.spec_from_file_location(
        f"other_build_{k}", os.path.join(checkout, "timg_tpu_torch", "ops",
                                         "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = ctypes.CDLL(build.build())
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.timg_dcs_band_lens.argtypes = [p, i, i, i, ll, ll, p, p, p]
    lib.timg_dcs_band_lens.restype = ctypes.c_int
    lib.timg_dcs_emit.argtypes = [p, i, i, i, ll, ll, i, p, p, p]
    lib.timg_dcs_emit.restype = ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())   # noqa: E731

    def stream(t):
        return ctypes.c_void_p(torch.cuda.current_stream(t.device)
                               .cuda_stream)

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{checkout}: {what}: CUDA error {rc}")

    def lens(planes, h, w):
        b, nb = planes.shape[0], (h + 5) // 6
        out = torch.empty((b, nb), dtype=torch.int32, device=planes.device)
        counts = torch.empty_like(out)
        check(lib.timg_dcs_band_lens(
            ptr(planes), b, h, w, planes.stride(0), planes.stride(1),
            ptr(out), ptr(counts), stream(planes)), "dcs_band_lens")
        return out, counts

    def emit(planes, h, w, cap):
        b, nb = planes.shape[0], (h + 5) // 6
        bands = torch.zeros((b, nb, cap), dtype=torch.uint8,
                            device=planes.device)
        out = torch.empty((b, nb), dtype=torch.int32, device=planes.device)
        check(lib.timg_dcs_emit(
            ptr(planes), b, h, w, planes.stride(0), planes.stride(1), cap,
            ptr(bands), ptr(out), stream(planes)), "dcs_emit")
        return bands, out
    return build.LOG_PATH, lens, emit


def fallback_leg(planes, h: int, w: int, lens) -> tuple:
    """Host ms of auto's fall-back steps (the run counts and their fetch;
    ``lens`` and the fetch of its two outputs; the plane's fetch)."""
    import torch

    from timg_tpu_torch.ops import sixel_runs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sixel_runs.run_counts(planes, h, w).cpu()
    t1 = time.perf_counter()
    for t in lens(planes, h, w):
        t.cpu()
    t2 = time.perf_counter()
    planes[:, :h, :w].cpu()
    t3 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def ptxas_lines(log_path: str, kernel: str = "dcs_bands") -> list:
    """ptxas' lines for the kernels whose mangled names hold ``kernel``
    (the DCS kernels unless given) in an nvcc log."""
    if not os.path.exists(log_path):
        return [f"(no {log_path})"]
    lines, take = [], False
    for line in open(log_path):
        if "Compiling entry function" in line:
            take = kernel in line
        if take and ("Used" in line or "Compiling entry" in line
                     or "spill" in line):
            lines.append(line.strip())
    return lines


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from timg_tpu_torch.ops import _build, resize_kernel, sixel_dcs
    from timg_tpu_torch.ops import sixel_dcs_kernel as sdk
    from timg_tpu_torch.ops import sixel_kernel, yuv_kernel

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    sides = {"this": (_build.LOG_PATH,
                      lambda p, h, w: sdk.dcs_band_lens_cuda(p, h, w),
                      lambda p, h, w, cap: sdk.dcs_emit_cuda(p, h, w, 64,
                                                             cap))}
    for k, checkout in enumerate(sys.argv[1:]):
        sides[os.path.basename(os.path.abspath(checkout))] = other_kernels(
            os.path.abspath(checkout), k)
    others = [name for name in sides if name != "this"]
    order = others + ["this", "this"] + others[::-1]

    dev = torch.device("cuda", 0)
    h, w = cs.OUT_H, cs.OUT_W
    planes = [torch.from_numpy(x).to(dev)
              for x in cs.yuv_frames(cs.N_KERNEL, cs.SEED)]
    words = yuv_kernel.yuv420_to_rgba_words_cuda(*planes, False)
    w720 = resize_kernel.resize_video_words_cuda(words, h, w)
    windows = {"seeded": sixel_kernel.fs_dither_cube_cuda(w720, h, w)}
    windows.update(cs.transport_windows(cs.N_KERNEL, dev))
    for name, window in windows.items():
        for b in (cs.N_KERNEL, cs.N_WINDOW):
            p = window[:b]
            want_lens = sixel_dcs.batch_band_lens_plain(p, b, h, w)
            cap = sixel_dcs.bucket_cap(int(want_lens[0].max()))
            want_bands = sixel_dcs.batch_encode_plain(p, b, h, w, cap)
            for side, (_, lens, emit) in sides.items():
                got = lens(p, h, w)
                cs.check_equal(f"{side} dcs_band_lens {name} B={b}", got[0],
                               want_lens[0])
                cs.check_equal(f"{side} dcs_band_lens' colours {name} "
                               f"B={b}", got[1], want_lens[1])
                got = emit(p, h, w, cap)
                torch.cuda.synchronize()
                cs.check_equal(f"{side} dcs_emit {name} B={b}", got[0],
                               want_bands[0])
                cs.check_equal(f"{side} dcs_emit's lens {name} B={b}",
                               got[1], want_bands[1])
            listed = int(want_lens[1].clamp(max=64).sum())
            over = int((want_lens[1] > 64).sum())
            runs = []
            for side in order:
                _, lens, emit = sides[side]
                runs.append((side,
                             cs.graph_ms(lambda: lens(p, h, w)),
                             cs.cuda_ms(lambda: lens(p, h, w), 50),
                             cs.graph_ms(lambda: emit(p, h, w, cap)),
                             cs.cuda_ms(lambda: emit(p, h, w, cap), 50)))
            print(f"{name} B={b} {h}x{w} ({listed} listed colours, {over} "
                  f"bands over 64, {int(want_lens[0].sum())} body bytes, "
                  f"cap {cap}): all equal to plain; " + "; ".join(
                      f"{side} lens {gl:.6f} ms in a CUDA graph, {el:.6f} "
                      f"by events, emit {ge:.6f} / {ee:.6f}"
                      for side, gl, el, ge, ee in runs))
    for name in ("film-like", "noise"):
        p = windows[name][:cs.N_WINDOW]
        steps = {side: [] for side in sides}
        for rep in range(21):                 # the first warms up
            for side in order[:len(sides)] if rep % 2 else order[len(sides):]:
                t = fallback_leg(p, h, w, sides[side][1])
                if rep:
                    steps[side].append(t)
        print(f"auto fall-back leg, {name} window, B={cs.N_WINDOW} {h}x{w} "
              "(host clock, median of 20; run counts + fetch, DCS lens + "
              "fetch, plane fetch = leg): " + "; ".join(
                  f"{side} " + " + ".join(
                      f"{statistics.median(x):.3f}" for x in zip(*t))
                  + f" = {statistics.median(sum(x) for x in t):.3f} ms"
                  for side, t in steps.items()))
    for side, (log, _, _) in sides.items():
        for line in ptxas_lines(log):
            print(f"ptxas {side}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
