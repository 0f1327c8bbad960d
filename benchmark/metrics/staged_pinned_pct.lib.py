"""Share of the bytes handed to the library's staging that crossed
through the pinned ring: 100 x the bytes of the program's ``lib.pin``
spans over those of its ``lib.stage`` spans (ops/staging.py), of the
spans that began inside the traced window.  A program without the ring,
or a run in which no batch crossed through it (the CPU), reads
nothing."""


def read(r):
    try:
        from timg_tpu_torch import tracing
    except ImportError:
        return None
    if r.trace is None:
        return None
    spans = [s for s in tracing.records() if r.t0 <= s.t0_ns < r.t1]
    pinned = sum(s.count for s in spans if s.name == "lib.pin")
    staged = sum(s.count for s in spans if s.name == "lib.stage")
    return 100.0 * pinned / staged if pinned and staged else None
