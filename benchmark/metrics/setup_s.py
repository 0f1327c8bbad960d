"""setup_s: from the process's start to the first measured window:
importing torch, the CUDA context, loading (or, in a fresh checkout,
building) the kernel library and the native helper, the frame pool and
the warm-up windows (host clock)."""


def read(r):
    return r.setup_s
