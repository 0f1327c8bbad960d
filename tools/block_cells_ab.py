#!/usr/bin/env python3
"""The quarter block-cell kernel against other checkouts', in one process
on one CUDA card.

    python3 tools/block_cells_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Each other checkout's kernel library is built by that checkout's own
``timg_tpu_torch/ops/_build.py``; its C entry ``timg_quarter_cells``
takes the same arguments as this one's and is called as the port's
first block wrapper called it (four outputs allocated a call, the
stream from ``torch.cuda.current_stream()``).  On chip_smoke's B=32
windows of 720x1280 words (``block_windows``: seeded video, noise,
flat), the seeded window cut to 1278 words (an odd number of cells a
row) and the CLI's 8 frames of 90x320 words, every kernel is checked
byte-equal to the plain version, then timed in turns (others, this,
this, others reversed) with chip_smoke's yardsticks: device time in a
CUDA graph and a call by CUDA events over 200 calls.  On the CLI's
window the host fetch of this kernel's outputs is timed too, one copy
of their buffer (``cells_to_host``) against one copy each, in turns.  Last, the SASS
instructions of each library's quarter_cells are counted by opcode
(cuobjdump).  Imports no jax.
"""

import collections
import ctypes
import importlib.util
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_counts(lib_path: str) -> dict:
    """{kernel symbol: Counter of opcodes} of each quarter_cells in lib."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "quarter_cells" in name:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                             fn)
            out[name] = collections.Counter(op.split(".")[0] for op in ops)
    return out


def other_kernel(checkout: str, k: int):
    """(library path, cells(words, tail)) of another checkout's quarter
    kernel, built by its own _build.py."""
    import torch

    spec = importlib.util.spec_from_file_location(
        f"other_build_{k}", os.path.join(checkout, "timg_tpu_torch", "ops",
                                         "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = ctypes.CDLL(build.build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.timg_quarter_cells.argtypes = [p, p, i, i, i, i, p, p, p, p, p]
    lib.timg_quarter_cells.restype = ctypes.c_int

    def cells(words, tail):
        b, th, tw = words.shape
        shape = (b, (th + 1) // 2, tw // 2)
        dev = words.device
        outs = [torch.empty(shape, dtype=dt, device=dev)
                for dt in (torch.uint8, torch.int32, torch.int32,
                           torch.bool)]
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())
        rc = lib.timg_quarter_cells(
            ptr(words), ptr(tail), b, th, tw, 0, *(ptr(t) for t in outs),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc:
            raise RuntimeError(f"{checkout}: quarter_cells: CUDA error {rc}")
        return outs
    return lib._name, cells


def fetch_times(cells, iters: int = 200) -> dict:
    """Host ms to fetch the kernel's outputs after a synchronized call:
    with one copy (``ops/blocks.cells_to_host``) or with one copy of each
    output, in turns; {way: (median, mean)}."""
    import numpy as np
    import torch

    from timg_tpu_torch.ops.blocks import cells_to_host

    def four(out):
        glyph, fg, bg, eq = out
        return (glyph.cpu().numpy(),
                fg.cpu().numpy().view(np.uint8).reshape(fg.shape + (4,)),
                bg.cpu().numpy().view(np.uint8).reshape(bg.shape + (4,)),
                eq.cpu().numpy())

    times = {"one": [], "four": []}
    for k in range(2 * iters):
        name = ("one", "four")[k % 2]
        out = cells()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (cells_to_host if name == "one" else four)(out)
        times[name].append(time.perf_counter() - t0)
    return {name: (statistics.median(t) * 1e3, statistics.fmean(t) * 1e3)
            for name, t in times.items()}


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from timg_tpu_torch.geometry import calc_scale_to_fit
    from timg_tpu_torch.ops import _build, blocks_kernel, resize_kernel
    from timg_tpu_torch.ops import blocks as blocks_op
    from timg_tpu_torch.ops import yuv_kernel

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    sides = {"this": (_build.LIB_PATH, None)}
    for k, checkout in enumerate(sys.argv[1:]):
        sides[os.path.basename(os.path.abspath(checkout))] = other_kernel(
            os.path.abspath(checkout), k)

    dev = torch.device("cuda", 0)
    planes = [torch.from_numpy(x).to(dev)
              for x in cs.yuv_frames(cs.N_KERNEL, cs.SEED)]
    words = yuv_kernel.yuv420_to_rgba_words_cuda(*planes, False)
    windows = cs.block_windows(resize_kernel.resize_video_words_cuda(
        words, cs.OUT_H, cs.OUT_W))
    windows["odd_cells"] = windows["seeded"][..., :cs.OUT_W - 2].contiguous()
    tw, th, _ = calc_scale_to_fit(cs.IN_W, cs.IN_H,
                                  cs.block_options("quarter"))
    windows["cli"] = resize_kernel.resize_video_words_cuda(
        words[:cs.N_WINDOW], th, tw)
    others = [name for name in sides if name != "this"]
    for name, w in windows.items():
        tail = w[-1].clone()
        fns = {side: (lambda: blocks_kernel.quarter_cells_cuda(w, False, tail))
               if side == "this" else
               (lambda cells=sides[side][1]: cells(w, tail))
               for side in sides}
        want = blocks_op.quarter_cells_plain(w, False, tail)
        for side, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            for part, g, ref in zip(("glyph", "fg", "bg", "eq"), got, want):
                cs.check_equal(f"{side} quarter_cells {name} ({part})", g,
                               ref)
        ops, depth = cs.quarter_ops(w)
        order = others + ["this", "this"] + others[::-1]
        runs = [(side, cs.graph_ms(fns[side]), cs.cuda_ms(fns[side], 200))
                for side in order]
        print(f"{name} {tuple(w.shape)}: all equal to plain; "
              f"{depth:.4f} candidates a cell, {ops} float operations; "
              + "; ".join(f"{side} {g:.6f} ms in a CUDA graph, {e:.6f} ms "
                          "a call by events" for side, g, e in runs))
        if name == "cli":
            for way, (med, mean) in fetch_times(fns["this"]).items():
                print(f"cli fetch of this kernel's outputs, {way} "
                      f"copies: median {med:.6f} ms, mean {mean:.6f} ms "
                      "(host clock, 200 fetches)")
    for side, (path, _) in sides.items():
        for kernel, ops in sass_counts(path).items():
            print(f"SASS {side} {kernel}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {n}" for k, n in ops.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
