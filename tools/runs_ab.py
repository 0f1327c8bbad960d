#!/usr/bin/env python3
"""The run-record kernels and the runs leg against other checkouts', in
one process on one CUDA card.

    python3 tools/runs_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Each other checkout's ``timg_tpu_torch.ops.sixel_runs`` is imported from
that checkout (its package swapped in under the same name for the
import, then swapped out), so its kernels are built by its own
``_build.py`` and called through its own wrappers: ``band_run_counts_cuda``
and ``compact_records_cuda`` allocate their outputs as that checkout
does (an earlier wrapper zeroes the records, this one's kernel writes
every byte).  On the cube dither's index planes of chip_smoke's seeded
window (as its transport phase makes them) and on its flat, film-like
and noise windows (``transport_windows``), all 720x1280, at B=32 and at
the CLI's B=8, both kernels of every checkout are checked byte-equal to
the plain versions (the records at ``default_cap``), then timed in turns
(others, this, this, others reversed) with chip_smoke's yardsticks:
device time in a CUDA graph of 20 calls and a call by CUDA events over
50 calls; the compaction also as its C entry alone into a records
buffer made once (device time without the wrapper's allocation or
memset).  Then each checkout's ``fetch_planes_or_runs`` under
``TIMG_TPU_SIXEL_TRANSPORT=runs`` and ``auto`` on the flat window at
B=8 (the runs leg: the counts, the decision, the compaction and the
fetches), host clock, 20 runs a checkout in turns after a warm-up, the
entries checked equal across checkouts and the counts kernel's launches
a window counted.  Last, ptxas' register lines of each checkout's run
kernels (its ``nvcc.log``).  Imports no jax.
"""

import importlib
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "timg_tpu_torch"


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def import_checkout(checkout: str, name: str = "ops.sixel_runs"):
    """``timg_tpu_torch.<name>`` of another checkout, with the modules
    it imports from its own package; this checkout's modules are back in
    ``sys.modules`` on return."""
    mine = _package_modules()
    for k in mine:
        del sys.modules[k]
    sys.path.insert(0, checkout)
    try:
        module = importlib.import_module(f"{PKG}.{name}")
    finally:
        sys.path.remove(checkout)
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(mine)
    if not module.__file__.startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {module.__file__}, not {checkout}'s")
    return module


def kernel_alone(kern, p, h: int, w: int, counts, records):
    """The compaction's C entry into ``records`` (made once by the
    caller), as ``kern``'s wrapper launches it."""
    n = records.shape[1]
    kern._build.check(kern._lib().timg_compact_runs(
        kern._ptr(p), p.shape[0], h, w, p.stride(0), p.stride(1),
        kern._ptr(counts), n, kern._ptr(records), kern._stream(p)),
        "compact_runs")


def runs_leg(runs, planes, b: int, h: int, w: int) -> tuple:
    """Host ms of one ``fetch_planes_or_runs`` (it ends in its fetches),
    the entries, and the counts kernel's launches in it."""
    import torch

    kern = runs.sixel_runs_kernel
    n0 = kern.COUNT_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    entries = runs.fetch_planes_or_runs(planes, b, h, w)
    t1 = time.perf_counter()
    return (t1 - t0) * 1e3, entries, kern.COUNT_LAUNCHES - n0


def same_entries(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        type(x).__name__ == type(y).__name__ and all(
            np.array_equal(u, v) if isinstance(u, np.ndarray) else u == v
            for u, v in zip(x, y))
        for x, y in zip(a, b))


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch

    import chip_smoke as cs
    from dcs_ab import ptxas_lines
    from timg_tpu_torch.ops import resize_kernel, sixel_kernel, sixel_runs
    from timg_tpu_torch.ops import yuv_kernel

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    sides = {"this": sixel_runs}
    for checkout in sys.argv[1:]:
        sides[os.path.basename(os.path.abspath(checkout))] = \
            import_checkout(os.path.abspath(checkout))
    others = [name for name in sides if name != "this"]
    order = others + ["this", "this"] + others[::-1]

    dev = torch.device("cuda", 0)
    h, w = cs.OUT_H, cs.OUT_W
    cap = sixel_runs.default_cap(h, w)
    planes = [torch.from_numpy(x).to(dev)
              for x in cs.yuv_frames(cs.N_KERNEL, cs.SEED)]
    words = yuv_kernel.yuv420_to_rgba_words_cuda(*planes, False)
    w720 = resize_kernel.resize_video_words_cuda(words, h, w)
    windows = {"seeded": sixel_kernel.fs_dither_cube_cuda(w720, h, w)}
    windows.update(cs.transport_windows(cs.N_KERNEL, dev))
    for name, window in windows.items():
        for b in (cs.N_KERNEL, cs.N_WINDOW):
            p = window[:b]
            want_counts = sixel_runs.band_run_counts_plain(p, h, w)
            want = sixel_runs.compact_runs_plain(p, h, w, cap)[0]
            for side, runs in sides.items():
                kern = runs.sixel_runs_kernel
                got = kern.band_run_counts_cuda(p, h, w)
                cs.check_equal(f"{side} band_run_counts {name} B={b}", got,
                               want_counts)
                got = kern.compact_records_cuda(p, h, w, want_counts, cap)
                torch.cuda.synchronize()
                cs.check_equal(f"{side} compact_runs {name} B={b}", got,
                               want)
            n_runs = int(want_counts.sum())
            buf = torch.zeros((b, cap, 2), dtype=torch.int32, device=dev)
            rows = []
            for side in order:
                kern = sides[side].sixel_runs_kernel
                rows.append((
                    side,
                    cs.graph_ms(lambda: kern.band_run_counts_cuda(p, h, w)),
                    cs.cuda_ms(lambda: kern.band_run_counts_cuda(p, h, w),
                               50),
                    cs.graph_ms(lambda: kern.compact_records_cuda(
                        p, h, w, want_counts, cap)),
                    cs.cuda_ms(lambda: kern.compact_records_cuda(
                        p, h, w, want_counts, cap), 50),
                    cs.graph_ms(lambda: kernel_alone(kern, p, h, w,
                                                     want_counts, buf))))
            print(f"{name} B={b} {h}x{w} ({n_runs} runs, records [{b}, "
                  f"{cap}, 2]): all equal to plain; " + "; ".join(
                      f"{side} counts {gc:.6f} ms in a CUDA graph, "
                      f"{ec:.6f} by events; compaction {gr:.6f} / {er:.6f},"
                      f" its C entry alone {ga:.6f} in a CUDA graph"
                      for side, gc, ec, gr, er, ga in rows))
    flat = windows["flat"][:cs.N_WINDOW]
    b = cs.N_WINDOW
    try:
        for mode in ("runs", "auto"):
            os.environ["TIMG_TPU_SIXEL_TRANSPORT"] = mode
            times = {side: [] for side in sides}
            first, launches = {}, {}
            for rep in range(21):                 # the first warms up
                for side in (order[:len(sides)] if rep % 2
                             else order[len(sides):]):
                    t, entries, n = runs_leg(sides[side], flat, b, h, w)
                    if rep:
                        times[side].append(t)
                    else:
                        first[side], launches[side] = entries, n
            for side in sides:
                if not same_entries(first[side], first["this"]):
                    cs.fail(f"runs leg ({mode}): {side}'s entries differ "
                            "from this checkout's")
            kinds = {type(e).__name__ for e in first["this"]}
            print(f"runs leg, TIMG_TPU_SIXEL_TRANSPORT={mode}, flat window, "
                  f"B={b} {h}x{w} (shipped as {', '.join(sorted(kinds))}, "
                  "entries equal; host clock, median of 20 [min-max]): "
                  + "; ".join(
                      f"{side} {statistics.median(t):.4f} ms "
                      f"[{min(t):.4f}-{max(t):.4f}], {launches[side]} "
                      "counts launches a window"
                      for side, t in times.items()))
    finally:
        os.environ.pop("TIMG_TPU_SIXEL_TRANSPORT", None)
    for side, runs in sides.items():
        log = runs.sixel_runs_kernel._build.LOG_PATH
        for kernel in ("band_run_counts", "compact_runs"):
            for line in ptxas_lines(log, kernel):
                print(f"ptxas {side}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
