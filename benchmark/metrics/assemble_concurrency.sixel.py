"""Sixel assemblies in flight, on average, while the sixel model
assembles a batch: the host ns of the program's ``lib.assemble`` spans
(render/sixel_render.py ``encode_sixel_streams``: one payload's C
assembly, on the thread that runs it) over those of its ``lib.emit``
spans (models/pixel.py ``SixelModel._render_resized``: a batch's
assembly, on the caller's thread), both those that began inside the
traced window.  Payloads assembled one after another read 1; a program
without ``lib.assemble`` reads nothing."""


def read(r):
    try:
        from timg_tpu_torch import tracing
    except ImportError:
        return None
    if r.trace is None:
        return None
    ns = {"lib.assemble": 0, "lib.emit": 0}
    for s in tracing.records():
        if s.name in ns and r.t0 <= s.t0_ns < r.t1:
            ns[s.name] += s.t1_ns - s.t0_ns
    if not ns["lib.assemble"] or not ns["lib.emit"]:
        return None
    return ns["lib.assemble"] / ns["lib.emit"]
