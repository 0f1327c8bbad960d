#!/usr/bin/env python3
"""The launchers' start, in turns, on a CUDA card's host.

    python3 tools/launcher_ab.py [--pairs N]

Served: a resident server (``timg-tpu-torch --serve``, default
device) on a socket in a temp dir; chip_smoke's photo (a 4032x3024
JPEG) in ``-pq`` at ``-g160x48`` sent N rounds, in turns, through the C
launcher (``timg-tpu-torch-fast``: its own client, no python),
the python launcher (``python3 -S timg-tpu-torch``) and this process's
own client (``serve.request``, no process started), each on a pty of
8x16-pixel cells that answers the terminal queries; the streams must be
equal.  What the in-process request takes is the server's part; each
launcher's excess over it is its client's start.

Every time is on the host clock; medians and quartiles are printed
beside the card's nvidia-smi line.  Imports no jax.
"""

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the stills' inputs and the pty runner)


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def report(label, times):
    lo, med, hi = quartiles(times)
    print(f"{label}: median {med:.1f} ms, quartiles {lo:.1f} / {hi:.1f} "
          f"(all {', '.join(f'{t:.1f}' for t in times)})")


def in_process_request(argv, out, sock):
    """``serve.request`` from this process with a pty as its terminal."""
    import fcntl
    import pty
    import struct
    import termios
    import threading

    from timg_tpu_torch import serve

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ,
                struct.pack("HHHH", *chip_smoke.STILL_WINSIZE))

    def pump():
        try:
            while True:
                data = os.read(master, 4096)
                if not data:
                    return
                for trigger, reply in chip_smoke.STILL_ANSWERS.items():
                    if trigger in data:
                        os.write(master, reply)
        except OSError:
            return

    threading.Thread(target=pump, daemon=True).start()
    saved = [os.dup(0), os.dup(1)]
    try:
        os.dup2(slave, 0)
        os.dup2(slave, 1)
        rc = serve.request(argv + ["-o", out], socket_path=sock)
    finally:
        os.dup2(saved[0], 0)
        os.dup2(saved[1], 1)
        for fd in saved + [slave, master]:
            os.close(fd)
    if rc != 0:
        chip_smoke.fail(f"the in-process request answered {rc}")
    with open(out, "rb") as f:
        return f.read()


def served(d, pairs, smi):
    sock = os.path.join(d, "ab.sock")
    env = dict(os.environ, TIMG_TPU_SERVE_SOCKET=sock,
               TIMG_TPU_TORCH_DEVICE="cuda")
    env.pop("TIMG_TPU_NO_SERVE", None)
    server = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "timg-tpu-torch"), "--serve"],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        t0 = time.perf_counter()
        while not os.path.exists(sock):
            if server.poll() is not None or time.perf_counter() - t0 > 300:
                chip_smoke.fail("the server did not come up:\n" +
                                server.stderr.read().decode()[-2000:])
            time.sleep(0.02)
        os.environ["TIMG_TPU_SERVE_SOCKET"] = sock
        argv = chip_smoke.still_argv("photo pq", d)
        out = os.path.join(d, "ab.out")
        runs = {
            "C launcher": lambda: chip_smoke.launcher_stream(
                argv, out, env, chip_smoke.C_LAUNCHER),
            "python launcher": lambda: chip_smoke.launcher_stream(
                argv, out, env),
            "in-process client": lambda: in_process_request(argv, out,
                                                            sock),
        }
        want = runs["in-process client"]()
        for run in runs.values():           # warm every route once
            if run() != want:
                chip_smoke.fail("a route wrote another stream")
        times = {k: [] for k in runs}
        for i in range(pairs):
            order = list(runs) if i % 2 == 0 else list(runs)[::-1]
            for key in order:
                t = time.perf_counter()
                got = runs[key]()
                times[key].append((time.perf_counter() - t) * 1e3)
                if got != want:
                    chip_smoke.fail(f"{key} wrote another stream")
        print(f"served photo -pq, {pairs} rounds in turns, every stream "
              f"equal; {smi}")
        for key, xs in times.items():
            report(f"  {key}", xs)
        base = statistics.median(times["in-process client"])
        for key in ("C launcher", "python launcher"):
            print(f"  {key}'s excess over the in-process request: "
                  f"{statistics.median(times[key]) - base:.1f} ms")
    finally:
        server.terminate()
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    from timg_tpu_torch.native import runtime
    from timg_tpu_torch.ops import _build

    os.environ["TIMG_TPU_TORCH_DEVICE"] = "cuda"
    _build.build()
    if runtime.build_launcher() is None or runtime.load() is None:
        chip_smoke.fail("the C launcher or the native helper did not "
                        "build:\n" + runtime.build_error("launcher"))
    d = tempfile.mkdtemp(prefix="timg_launcher_ab_")
    chip_smoke.still_inputs(d)
    served(d, args.pairs, smi)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
