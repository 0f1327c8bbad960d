#!/usr/bin/env python3
"""Where the sws kernel's time goes (csrc/sws_yuv420.cu, sws_tiled), on
one CUDA card.

    python3 tools/sws_phases.py

Builds four copies of this checkout's csrc/sws_yuv420.cu with nvcc (the
flags of ``ops/_build.py``), each into its own library under
``build/sws_phases/``: the kernel as it is, without its vertical pass
and conversion (no words are written), without its horizontal pass (the
rings are read unwritten), and without both (what is left: staging the
byte rows, the steps' barriers and loop).  The whole kernel is checked
byte-equal to the plain version; the others compute garbage and are
only timed.  Each is called through this checkout's wrapper with the
same plan on chip_smoke's seeded planes (1080p into 720x1280 at B=32 and
at the CLI's B=8, into 720x1279 and into the quarter sws window's
geometry, and 8 frames of 2160x3840 into 720x1280), timed in turns
(whole, the three cuts, then again in reverse) as device time in a CUDA
graph of 20 calls; a phase's share is the whole kernel's time less the
time without it.  Imports no jax.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "sws_phases")

# the vertical pass and conversion, and the horizontal pass, as they
# stand in sws_tiled, and what each cut puts in their place
NO_V = ("if (!q_in) continue;", "continue;")
NO_H = (("    if (cl < ncol) {\n      const int n1",
         "    if (false) {\n      const int n1"),
        ("    if (cc < ncol_c) {\n      const uint8_t* cbuf",
         "    if (false) {\n      const uint8_t* cbuf"))


def _cut(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"sws_tiled no longer holds {old!r}")
        src = src.replace(old, new)
    return src


VARIANTS = {"whole": (), "no vertical": (NO_V,), "no horizontal": NO_H,
            "neither": (NO_V, *NO_H)}


def build() -> dict:
    """Each variant's library (built in parallel), its argtypes those of
    the wrapper's."""
    from timg_tpu_torch.ops import _build, sws_kernel

    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(_build.CSRC, "sws_yuv420.cu")).read()
    procs = {}
    for k, (name, cuts) in enumerate(VARIANTS.items()):
        cu = os.path.join(OUT, f"v{k}.cu")
        with open(cu, "w") as f:
            f.write(_cut(src, cuts))
        lib = os.path.join(OUT, f"v{k}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes = sws_kernel._lib().timg_sws_yuv420_to_rgba_words.argtypes
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n"
                               + log[-3000:])
        lib = ctypes.CDLL(path)
        lib.timg_sws_yuv420_to_rgba_words.argtypes = argtypes
        lib.timg_sws_yuv420_to_rgba_words.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from timg_tpu_torch.ops import sws_kernel, sws_resize

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    libs = build()
    dev = torch.device("cuda", 0)
    planes = [torch.from_numpy(p).to(dev)
              for p in cs.yuv_frames(cs.N_KERNEL, cs.SEED)]
    window = [p[:cs.N_WINDOW] for p in planes]
    window_4k = [torch.from_numpy(p).to(dev) for p in cs.yuv_frames(
        cs.N_WINDOW, cs.SEED + 5, cs.H_4K, cs.W_4K)]
    cases = [(f"720x1280, B={cs.N_KERNEL}", planes, cs.OUT_H, cs.OUT_W)]
    cases += [(f"{what}, B={cs.N_WINDOW}",
               window_4k if ih == cs.H_4K else window, oh, ow)
              for what, ih, iw, oh, ow in cs.sws_geometries()
              if (oh, ow) != (ih, iw)]
    mine = sws_kernel._bound
    order = list(libs) + list(libs)[::-1]
    try:
        for what, batch, oh, ow in cases:
            ih, iw = batch[0].shape[1:]
            plan = sws_resize.get_plan(iw, ih, ow, oh, False)
            sws_kernel._bound = libs["whole"]
            cs.check_equal(f"sws {ih}x{iw} -> {what} (the whole variant)",
                           sws_kernel.sws_yuv420_to_rgba_words_cuda(*batch,
                                                                    plan),
                           sws_resize.sws_yuv420_to_rgba_words_plain(
                               *batch, oh, ow, False))
            times = {name: [] for name in libs}
            for name in order:
                sws_kernel._bound = libs[name]
                times[name].append(cs.graph_ms(
                    lambda: sws_kernel.sws_yuv420_to_rgba_words_cuda(
                        *batch, plan)))
            ms = {name: min(t) for name, t in times.items()}
            whole = ms["whole"]
            print(f"sws {ih}x{iw} -> {what}: " + "; ".join(
                f"{name} {t[0]:.6f} / {t[1]:.6f} ms" for name, t in
                times.items())
                + f"; shares of {whole:.6f}: vertical and conversion "
                f"{(whole - ms['no vertical']) / whole:.0%}, horizontal "
                f"{(whole - ms['no horizontal']) / whole:.0%}, the rest "
                f"{ms['neither'] / whole:.0%}", flush=True)
    finally:
        sws_kernel._bound = mine
    return 0


if __name__ == "__main__":
    sys.exit(main())
