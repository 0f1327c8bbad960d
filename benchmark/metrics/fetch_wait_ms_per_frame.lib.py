"""Host milliseconds a frame in the program's ``lib.fetch`` spans
(models/blocks.py process_batch: the planes' copies to the host, where
the host waits for the card's resize, compose and cells), those that
began inside the traced window, over the frames handed in.  The spans
are the program's own (timg_tpu_torch/tracing.py); a program without
them reads nothing."""


def read(r):
    try:
        from timg_tpu_torch import tracing
    except ImportError:
        return None
    if r.trace is None or r.frames == 0:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in tracing.records()
             if s.name == "lib.fetch" and r.t0 <= s.t0_ns < r.t1)
    return ns / 1e6 / r.frames if ns > 0 else None
