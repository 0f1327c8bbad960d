"""Share of the traced window in which the card was idle while the
program's ``lib.resize`` span (ops/pipeline.py _resized: the stb resize
and compose launches) was the innermost span open: the span less its
children, against the device trace's idle gaps.  The spans are the
program's own (timg_tpu_torch/tracing.py), those that began inside the
window, on the clock the trace is tied to; a program without them, or a
run without device activity, reads nothing.  ``idle_in`` also reads
idle_in_emit_pct.lib."""

from bisect import bisect_right
from collections import defaultdict


def _exclusive(span, children):
    """[t0, t1) of ``span`` less its children's intervals."""
    out, at = [], span.t0_ns
    for c in sorted(children, key=lambda c: c.t0_ns):
        if c.t0_ns > at:
            out.append((at, min(c.t0_ns, span.t1_ns)))
        at = max(at, c.t1_ns)
    if span.t1_ns > at:
        out.append((at, span.t1_ns))
    return out


def idle_in(r, name):
    try:
        from timg_tpu_torch import tracing
    except ImportError:
        return None
    if r.trace is None or not r.trace.intervals:
        return None
    spans = [s for s in tracing.records() if r.t0 <= s.t0_ns < r.t1]
    own = [s for s in spans if s.name == name]
    if not own:
        return None
    children = defaultdict(list)
    for s in spans:
        children[s.parent_id].append(s)
    gaps = r.trace.gaps()
    starts = [g0 for g0, _ in gaps]
    idle = 0
    for s in own:
        for a, b in _exclusive(s, children[s.span_id]):
            i = max(bisect_right(starts, a) - 1, 0)
            while i < len(gaps) and gaps[i][0] < b:
                idle += max(0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
                i += 1
    return 100.0 * idle / 1e9 / r.seconds


def read(r):
    return idle_in(r, "lib.resize")
