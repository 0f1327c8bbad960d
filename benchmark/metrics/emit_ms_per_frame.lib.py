"""Host milliseconds a payload in the C ANSI emitter's entry
(render/ansi.py _emit_frame_native), timed by the harness's wrapper."""

SPANS = {"emit": ["timg_tpu_torch.render.ansi:_emit_frame_native"]}


def read(r):
    if r.spans is None or r.frames == 0:
        return None
    s = r.spans.seconds("emit", r.t0, r.t1)
    return 1e3 * s / r.frames if s > 0 else None
