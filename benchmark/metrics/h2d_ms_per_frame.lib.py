"""Device milliseconds of host-to-device copies a frame (torch.profiler's
HtoD memcpy activity inside the window, over the frames handed in)."""

from harness.trace import is_copy


def read(r):
    if r.trace is None or r.frames == 0:
        return None
    s = r.trace.seconds(lambda name: is_copy(name, "HtoD"))
    return 1e3 * s / r.frames if s > 0 else None
