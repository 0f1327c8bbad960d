#!/usr/bin/env python3
"""The sws kernel (csrc/sws_yuv420.cu, --resample=sws-bitexact) against
other checkouts', in one process on one CUDA card.

    python3 tools/sws_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Each other checkout's ``timg_tpu_torch.ops.sws_resize`` is imported from
that checkout (``runs_ab.import_checkout``), so its kernel is built by
its own ``_build.py`` and called through its own wrapper with its own
plan.  On chip_smoke's seeded planes, 1080p into 720x1280 at B=32 and
at the CLI's B=8, into 720x1279 (full chroma), into the quarter sws
window's geometry and at 1080x1920 (the unscaled converter), and 8
frames of 2160x3840 into 720x1280, every checkout's kernel is checked
byte-equal to this checkout's plain version in both ranges, then timed
in turns (others, this, this, others reversed) by CUDA events over 20
calls and in a CUDA graph of 20 calls, each way twice: on one window
(inputs and output may stay in the 50 MB L2 from call to call) and
rotating over enough windows of other planes that the inputs read
since a window's last call exceed 150 MB, more than L2 holds.  Each
line gives the bound (bytes over 3.35 TB/s, or chip_smoke's integer
operations over 16.7 T/s, the larger) and this checkout's tiling.
Last, ptxas' register and shared memory lines of each checkout's sws
kernels (its ``nvcc.log``).  Imports no jax.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROTATE_BYTES = 150e6   # inputs a rotation reads, well over the L2


def events_ms(fn, args: list, iters: int = 20) -> float:
    """A call by CUDA events over ``iters`` back-to-back calls, cycling
    through ``args`` (after one warm-up call of each)."""
    import torch

    for a in args:
        fn(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(args[i % len(args)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, args: list, iters: int = 20) -> float:
    """Device time a call: CUDA events around one replay of a CUDA graph
    of ``iters`` calls cycling through ``args``."""
    import torch

    for a in args:
        fn(a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(args[i % len(args)])
    graph.replay()                                   # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch

    import chip_smoke as cs
    from dcs_ab import ptxas_lines
    from runs_ab import import_checkout
    from timg_tpu_torch.ops import sws_resize

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    sides = {"this": sws_resize}
    for checkout in sys.argv[1:]:
        sides[os.path.basename(os.path.abspath(checkout))] = \
            import_checkout(os.path.abspath(checkout), "ops.sws_resize")
    others = [name for name in sides if name != "this"]
    order = others + ["this", "this"] + others[::-1]

    dev = torch.device("cuda", 0)
    frames = {}

    def windows(b: int, h: int, w: int) -> list:
        """Enough seeded windows of b frames of h x w that a rotation
        reads ROTATE_BYTES of inputs; the first is chip_smoke's."""
        n = max(2, int(-(-ROTATE_BYTES // (b * h * w * 3 // 2))))
        key = (b, h, w)
        if key not in frames:
            frames[key] = [[torch.from_numpy(p).to(dev)
                            for p in cs.yuv_frames(b, cs.SEED + k, h, w)]
                           for k in range(n)]
        return frames[key]

    cases = [(f"720x1280, B={cs.N_KERNEL}", cs.N_KERNEL, cs.IN_H, cs.IN_W,
              cs.OUT_H, cs.OUT_W)]
    cases += [(f"{what}, B={cs.N_WINDOW}", cs.N_WINDOW, ih, iw, oh, ow)
              for what, ih, iw, oh, ow in cs.sws_geometries()]
    for what, b, ih, iw, oh, ow in cases:
        wins = windows(b, ih, iw)
        for full_range in (False, True):
            want = sws_resize.sws_yuv420_to_rgba_words_plain(
                *wins[0], oh, ow, full_range)
            for side, mod in sides.items():
                plan = mod.get_plan(iw, ih, ow, oh, full_range)
                got = mod.sws_kernel.sws_yuv420_to_rgba_words_cuda(
                    *wins[0], plan)
                torch.cuda.synchronize()
                cs.check_equal(f"{side} sws {ih}x{iw} -> {what} "
                               f"(full_range={full_range})", got, want)
            del want
        plan = sws_resize.get_plan(iw, ih, ow, oh, False)
        nbytes = b * (ih * iw * 3 // 2 + oh * ow * 4)
        bb = cs.bound(nbytes, 0)["bound_ms"]
        bo = cs.bound(0, cs.sws_ops(plan, b), cs.INT32_OPS_PER_S)["bound_ms"]
        if plan.unscaled:
            tiling = "the unscaled converter"
        else:
            t = plan.tiling
            tiling = (f"strips of {t.sw}, chunks of {t.ch} rows ({t.n_strips}"
                      f" x {t.n_chunks} x {b} blocks), {len(t.steps)} steps,"
                      f" {t.kf or 'wide'} register taps, rings {t.ring_l} / "
                      f"{t.ring_c} rows, {t.smem} B of shared memory")
        rows = []
        for side in order:
            mod = sides[side]
            p = mod.get_plan(iw, ih, ow, oh, False)

            def fn(planes, mod=mod, p=p):
                return mod.sws_kernel.sws_yuv420_to_rgba_words_cuda(*planes,
                                                                    p)
            rows.append((side, graph_ms(fn, wins[:1]),
                         events_ms(fn, wins[:1]), graph_ms(fn, wins),
                         events_ms(fn, wins)))
        print(f"sws {ih}x{iw} -> {what}: all equal to plain; bound "
              f"{max(bb, bo):.6f} ms (bytes {bb:.6f}, operations {bo:.6f});"
              f" {len(wins)} windows rotated; this checkout's tiling: "
              f"{tiling}; " + "; ".join(
                  f"{side} {g1:.6f} ms in a CUDA graph, {e1:.6f} by events "
                  f"on one window, rotated {gr:.6f} / {er:.6f}"
                  for side, g1, e1, gr, er in rows), flush=True)
    for side, mod in sides.items():
        for line in ptxas_lines(mod.sws_kernel._build.LOG_PATH, "sws_"):
            print(f"ptxas {side}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
