"""Host milliseconds a payload in the program's ``lib.emit`` spans of
the sixel model (models/pixel.py ``SixelModel._render_resized``: the
loop that assembles a batch's payloads, the C assembler's
``timg_sixel_encode``), those that began inside the traced window, over
the payloads handed in.  A program without the span reads nothing.
``span_ms`` reads any span so; fetch_wait_ms_per_frame.lib's body is
the same reading of ``lib.fetch``."""


def span_ms(r, name):
    """Host ms a payload in the program's spans ``name`` of the window."""
    try:
        from timg_tpu_torch import tracing
    except ImportError:
        return None
    if r.trace is None or r.frames == 0:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in tracing.records()
             if s.name == name and r.t0 <= s.t0_ns < r.t1)
    return ns / 1e6 / r.frames if ns > 0 else None


def read(r):
    return span_ms(r, "lib.emit")
