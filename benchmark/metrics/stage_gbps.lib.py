"""GB/s of the library's staging: the bytes that the program's
``lib.stage`` spans (models/blocks.py process_batch: from_numpy and the
pageable copy to the card) moved, over those spans' host seconds.  The
spans are the program's own (timg_tpu_torch/tracing.py), those that
began inside the traced window; a program without them reads nothing."""


def read(r):
    try:
        from timg_tpu_torch import tracing
    except ImportError:
        return None
    if r.trace is None:
        return None
    spans = [s for s in tracing.records()
             if s.name == "lib.stage" and r.t0 <= s.t0_ns < r.t1]
    ns = sum(s.t1_ns - s.t0_ns for s in spans)
    return sum(s.count for s in spans) / ns if ns > 0 else None
