"""Build the CUDA sources under timg_tpu_torch/csrc/ at first use.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects link into one
shared library with a plain C interface, loaded with ctypes.  No
PyTorch header is included, so the build takes seconds rather than
minutes.  The library lands in ``csrc/build/`` (git-ignored) and is
rebuilt whenever a source is newer than it.  Nothing here runs at
import time: a machine without ``nvcc`` can import every module.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libtimg_torch_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "nvcc.log")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                       "CUDA kernels of timg_tpu_torch cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def build() -> str:
    """Compile the library if it is missing or stale; return its path.

    One ``nvcc -c`` per source, run in parallel, then one link.  Links
    to a temporary name and renames, so a concurrent loader never sees a
    half-written library.  ptxas' register and shared memory report
    goes to ``csrc/build/nvcc.log``."""
    if not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    tmp = f"{LIB_PATH}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(LOG_PATH, "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value
    is ``cudaGetLastError()`` right after the launch)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
