#!/usr/bin/env python3
"""Repeat chip_smoke's CPU child for quarter blocks and find what moves.

    python3 tools/quarter_repeat.py [--runs 200] [--jobs 7] [--frames 16]
                                    [--threads 2] [--out DIR]

Runs ``chip_smoke.py --main-path-stream quarter N`` (the CPU reference
child of chip_smoke's quarter main path: 1080p 4:2:0 windows converted,
resized to 90x320 words and cut into quarter cells by the port's plain
PyTorch versions) K times, ``--jobs`` at a time, each with
TIMG_TPU_TORCH_DEVICE=cpu and OMP_NUM_THREADS=``--threads`` as chip_smoke
starts it.  Every second run is chip_smoke's child exactly as chip_smoke
starts it; the others run the same child in-process under hooks that
record, per window, the convert's and the resize's words, the outputs of
``blocks._lin``, ``blocks._avd`` and ``blocks._repack`` (each call, in
order), and the cells (glyph, fg, bg, eq).  A hooked call is also run a
second time on a copy of its inputs with one torch thread and compared
bit for bit, and every repack's root is held against the exact
floor(sqrt) taken in float64; any difference is logged with the op, the
shape, strides, storage offset, data pointer modulo 64 and thread count.

The runs' streams are kept by digest.  For a stream unlike the most
common one, the hooked run's arrays are compared with a hooked run of
the common stream: the first recorded op whose output differs names
the side that moved (convert, resize or cells, and inside the cells
which op), and the differing frame's words, cells and intermediates are
saved.  Writes ``summary.json`` and ``diff_*.npz`` under ``--out``
(default build/quarter_repeat, git-ignored) and prints the summary.
Imports no jax.
"""

import argparse
import collections
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


# --- the hooked child -------------------------------------------------------

def _layout(t) -> dict:
    return {"shape": list(t.shape), "stride": list(t.stride()),
            "offset": t.storage_offset(), "ptr_mod64": t.data_ptr() % 64}


def _bits(t):
    import torch
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _hooked_child(frames: int, dump: str) -> int:
    """chip_smoke's quarter child under hooks (see the module docstring);
    the stream to stdout, the records to ``dump``."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from timg_tpu_torch.ops import blocks
    from timg_tpu_torch.render import plane_cache

    records = []     # (name, numpy array) in call order
    log = []         # recheck differences
    window = [0]

    def rechecked(name, fn):
        def run(*args):
            out = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            n = torch.get_num_threads()
            copies = [a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args]
            torch.set_num_threads(1)
            try:
                again = fn(*copies)
            finally:
                torch.set_num_threads(n)
            again = again if isinstance(again, tuple) else (again,)
            for k, (a, b) in enumerate(zip(outs, again)):
                differ = _bits(a) != _bits(b)
                if bool(differ.any()):
                    where = differ.nonzero()[:4]
                    log.append({
                        "op": name, "output": k, "window": window[0],
                        "threads": n, "n_diff": int(differ.sum()),
                        "inputs": [_layout(t) for t in args
                                   if isinstance(t, torch.Tensor)],
                        "out": _layout(a), "first": where.tolist(),
                        "values": [[float(a[tuple(i)]), float(b[tuple(i)])]
                                   for i in where.tolist()]})
            for k, a in enumerate(outs):
                records.append((f"w{window[0]}.{name}.{len(records)}.{k}",
                                a.detach().cpu().numpy().copy()))
            return out
        return run

    repack = blocks._repack

    def repack_checked(lin):
        out = repack(lin)
        exact = torch.clamp(torch.floor(torch.sqrt(
            lin[..., :3].to(torch.float64))), max=255.0).to(torch.uint8)
        bad = out[..., :3] != exact
        if bool(bad.any()):
            idx = bad.nonzero()[:8]
            vals = [float(lin[tuple(i[:-1].tolist()) + (int(i[-1]),)])
                    for i in idx]
            log.append({"op": "repack root", "window": window[0],
                        "threads": torch.get_num_threads(),
                        "n_diff": int(bad.sum()), "input": _layout(lin),
                        "first": idx.tolist(), "values": vals})
        return out

    def recorded(name, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            for k, a in enumerate(out if isinstance(out, tuple) else (out,)):
                if a is not None:
                    records.append((f"w{window[0]}.{name}.{len(records)}.{k}",
                                    a.detach().cpu().numpy().copy()))
            if name == "cells":
                window[0] += 1
            return out
        return run

    blocks._lin = rechecked("lin", blocks._lin)
    blocks._avd = rechecked("avd", blocks._avd)
    blocks._repack = rechecked("repack", repack_checked)
    plane_cache.yuv420_to_rgba_words = recorded(
        "convert", plane_cache.yuv420_to_rgba_words)
    plane_cache.resize_video_words = recorded(
        "resize", plane_cache.resize_video_words)
    blocks.quarter_cells = recorded("cells", blocks.quarter_cells)

    stream = chip_smoke.main_path_stream("quarter", frames)
    os.makedirs(dump, exist_ok=True)
    np.savez(os.path.join(dump, "arrays.npz"), **dict(records))
    with open(os.path.join(dump, "log.json"), "w") as f:
        json.dump({"log": log, "order": [k for k, _ in records],
                   "digests": {k: _sha(a.tobytes()) for k, a in records}}, f)
    sys.stdout.buffer.write(stream)
    return 0


# --- the parent -------------------------------------------------------------

def _first_moved(odd: dict, common: dict) -> str:
    for key in common["order"]:
        if odd["digests"].get(key) != common["digests"][key]:
            return key
    return ""


def _save_diff(path: str, odd_dir: str, common_dir: str, key: str) -> dict:
    """The differing frame's words, cells and intermediates of both runs."""
    import numpy as np

    a = np.load(os.path.join(odd_dir, "arrays.npz"))
    b = np.load(os.path.join(common_dir, "arrays.npz"))
    diff = a[key] != b[key]
    frame = int(np.argwhere(diff)[0][0]) if diff.ndim else 0
    win = key.split(".")[0]
    out, cells = {}, []
    for k in a.files:
        if k.startswith(win + ".") and a[k].ndim and len(a[k]) > frame:
            out["odd." + k] = a[k][frame]
            out["common." + k] = b[k][frame]
    for k in a.files:
        if k.startswith(win + ".cells") and a[k].shape == b[k].shape:
            d = np.argwhere(a[k] != b[k])
            cells += [{"array": k, "index": i.tolist(),
                       "odd": a[k][tuple(i)].tolist(),
                       "common": b[k][tuple(i)].tolist()} for i in d[:16]]
    np.savez_compressed(path, **out)
    return {"first_moved": key, "frame": frame,
            "n_diff_first": int(diff.sum()), "cells": cells}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=7)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "quarter_repeat"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return _hooked_child(args.frames, args.dump)

    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="quarter_repeat.")
    env = dict(os.environ, TIMG_TPU_TORCH_DEVICE="cpu",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=str(args.threads))
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    streams = collections.Counter()
    runs = []        # (i, hooked, digest, dump dir or None)
    logs = []
    pending = list(range(args.runs))
    live = {}
    try:
        while pending or live:
            while pending and len(live) < args.jobs:
                i = pending.pop(0)
                hooked = i % 2 == 1
                dump = os.path.join(work, f"run{i}") if hooked else None
                cmd = ([sys.executable, __file__, "--child", "--frames",
                        str(args.frames), "--dump", dump] if hooked else
                       [sys.executable, CHIP_SMOKE, "--main-path-stream",
                        "quarter", str(args.frames)])
                out = open(os.path.join(work, f"stream{i}"), "wb")
                live[i] = (subprocess.Popen(cmd, env=env, cwd=REPO,
                                            stdout=out,
                                            stderr=subprocess.PIPE), out,
                           hooked, dump)
            time.sleep(0.2)
            for i in [i for i, v in live.items() if v[0].poll() is not None]:
                proc, out, hooked, dump = live.pop(i)
                out.close()
                err = proc.stderr.read().decode(errors="replace")
                if proc.returncode != 0:
                    print(f"run {i} failed ({proc.returncode}):\n{err[-2000:]}",
                          file=sys.stderr)
                    return 1
                with open(os.path.join(work, f"stream{i}"), "rb") as f:
                    data = f.read()
                digest = _sha(data)
                if digest not in streams and len(streams) < 3:
                    # the first stream and two others (a few MB each)
                    shutil.copy(os.path.join(work, f"stream{i}"),
                                os.path.join(args.out, f"stream_{digest}.out"))
                os.remove(os.path.join(work, f"stream{i}"))
                streams[digest] += 1
                if hooked:
                    with open(os.path.join(dump, "log.json")) as f:
                        rec = json.load(f)
                    logs += [dict(e, run=i) for e in rec["log"]]
                runs.append((i, hooked, digest, dump))
                # keep the arrays of the first two hooked runs of each
                # stream; drop the rest as they come
                same = [r for r in runs if r[1] and r[2] == digest]
                if hooked and len(same) > 2:
                    shutil.rmtree(dump, ignore_errors=True)
                    runs[-1] = (i, hooked, digest, None)
        common = streams.most_common(1)[0][0]
        report = {"runs": args.runs, "frames": args.frames,
                  "threads": args.threads, "jobs": args.jobs,
                  "seconds": round(time.perf_counter() - t0, 1),
                  "streams": dict(streams), "common": common,
                  "odd_runs": [{"run": i, "hooked": h, "stream": d}
                               for i, h, d, _ in runs if d != common],
                  "recheck_differences": logs[:200],
                  "n_recheck_differences": len(logs), "moved": []}
        ref = next((r for r in runs if r[1] and r[2] == common and r[3]),
                   None)
        for i, hooked, digest, dump in runs:
            if digest == common or not dump or ref is None:
                continue
            with open(os.path.join(dump, "log.json")) as f:
                odd = json.load(f)
            with open(os.path.join(ref[3], "log.json")) as f:
                com = json.load(f)
            key = _first_moved(odd, com)
            entry = {"run": i, "stream": digest}
            if key:
                entry.update(_save_diff(os.path.join(
                    args.out, f"diff_run{i}.npz"), dump, ref[3], key))
            report["moved"].append(entry)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({k: report[k] for k in (
            "runs", "seconds", "streams", "odd_runs",
            "n_recheck_differences", "moved")}, indent=1))
        if logs:
            print("first recheck differences:",
                  json.dumps(logs[:5], indent=1))
    finally:
        for proc, out, _, _ in live.values():
            proc.kill()
            proc.wait()
            out.close()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
