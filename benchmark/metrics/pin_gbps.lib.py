"""GB/s of the library staging's host pack: the bytes that the program's
``lib.pin`` spans (ops/staging.py: one chunk packed into a pinned slot
of the ring, while the previous chunk's DMA runs) moved, over those
spans' host seconds.  The spans are the program's own, those that began
inside the traced window; a program without them, or a run whose batches
never crossed through the ring (the CPU), reads nothing."""


def read(r):
    try:
        from timg_tpu_torch import tracing
    except ImportError:
        return None
    if r.trace is None:
        return None
    spans = [s for s in tracing.records()
             if s.name == "lib.pin" and r.t0 <= s.t0_ns < r.t1]
    ns = sum(s.t1_ns - s.t0_ns for s in spans)
    return sum(s.count for s in spans) / ns if ns > 0 else None
