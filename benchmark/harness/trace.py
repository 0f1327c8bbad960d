"""The traced run's device side: one torch.profiler session over the
measured window (a process's later sessions see no device time), read
into per-name device time, the busy share, and the idle gaps named by
the host span the program was in.

Kineto's clock is tied to ``time.perf_counter_ns`` by an anchor: a
profiler range opened at a known perf_counter time inside the session.
"""

from __future__ import annotations

import time
from collections import defaultdict

ANCHOR = "benchmark.anchor"


class DeviceTrace:
    def __init__(self, on_card: bool = True, ranges=()):
        """``ranges``: the harness's profiler ranges, which are no device
        activity of their own."""
        import torch

        act = torch.profiler.ProfilerActivity
        self._on_card = on_card
        self._ranges = {ANCHOR, *ranges}
        self._prof = torch.profiler.profile(
            activities=[act.CPU, act.CUDA] if on_card else [act.CPU])
        self.offset_ns = 0            # kineto ns - perf_counter ns
        self.intervals = []           # (start, end, name) in perf ns
        self.by_name = defaultdict(float)      # device seconds
        self.ranges = {}              # profiler range -> device seconds

    def start(self) -> None:
        import torch

        self._prof.__enter__()
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(ANCHOR):
            t1 = time.perf_counter_ns()
        self._anchor = (t0 + t1) // 2

    def stop(self, lo_ns: int, hi_ns: int) -> None:
        """End the session; keep the device activity inside [lo, hi)
        (perf_counter ns)."""
        import torch

        if self._on_card:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        anchor = next((e for e in events if e.name() == ANCHOR), None)
        if anchor is None:
            raise RuntimeError("the profiler lost its anchor range")
        self.offset_ns = anchor.start_ns() - self._anchor
        for e in events:
            # the profiler also marks its ranges on the device's timeline:
            # they are no device activity
            if e.device_type() != torch.autograd.DeviceType.CUDA \
                    or e.name() in self._ranges:
                continue
            s = e.start_ns() - self.offset_ns
            d = e.duration_ns()
            if d <= 0 or s + d <= lo_ns or s >= hi_ns:
                continue
            s, t = max(s, lo_ns), min(s + d, hi_ns)
            self.intervals.append((s, t, e.name()))
            self.by_name[e.name()] += (t - s) / 1e9
        for avg in self._prof.key_averages():
            total = getattr(avg, "device_time_total",
                            getattr(avg, "cuda_time_total", 0))
            self.ranges[avg.key] = total / 1e6
        self.lo, self.hi = lo_ns, hi_ns

    def busy_s(self) -> float:
        """Seconds of the window in which something ran on the card."""
        busy, end = 0, self.lo
        for s, t, _ in sorted(self.intervals):
            if t <= end:
                continue
            busy += t - max(s, end)
            end = t
        return busy / 1e9

    def gaps(self):
        """The idle stretches of the window: (start, end) perf ns."""
        out, end = [], self.lo
        for s, t, _ in sorted(self.intervals):
            if s > end:
                out.append((end, s))
            end = max(end, t)
        if self.hi > end:
            out.append((end, self.hi))
        return out

    def seconds(self, match) -> float:
        """Device seconds of the activity whose name ``match`` accepts."""
        return sum(v for k, v in self.by_name.items() if match(k))


def is_copy(name: str, kind: str) -> bool:
    """A memcpy of ``kind`` ("HtoD", "DtoH") as CUPTI names it."""
    return "Memcpy" in name and kind in name


def idle_by_span(trace: DeviceTrace, spans) -> list:
    """Idle seconds of the window by the host span the program was in
    (the span that began last among those open; "other" where none was),
    most first."""
    opened = sorted((t0, t1, layer) for layer, recs in spans.records.items()
                    for t0, t1 in recs)
    totals = defaultdict(float)
    j, active = 0, []
    for g0, g1 in trace.gaps():
        while j < len(opened) and opened[j][0] <= g1:
            active.append(opened[j])
            j += 1
        active = [a for a in active if a[1] > g0]
        # split the gap at every span edge inside it
        edges = sorted({g0, g1, *[a[0] for a in active if g0 < a[0] < g1],
                        *[a[1] for a in active if g0 < a[1] < g1]})
        for a, b in zip(edges, edges[1:]):
            mid = (a + b) // 2
            inner = [s for s in active if s[0] <= mid < s[1]]
            name = max(inner)[2] if inner else "other"
            totals[name] += (b - a) / 1e9
    return sorted(totals.items(), key=lambda kv: -kv[1])
