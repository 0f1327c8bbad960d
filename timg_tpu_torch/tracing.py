"""The program's spans: host intervals on ``time.perf_counter_ns``'s
clock, each with its parent on the same thread and a count of the work
it did (bytes, frames, payloads or cells).

    with tracing.span("lib.fetch") as s:
        ...
        s.count = nbytes          # a span may learn its count late

Spans record only while a torch.profiler session runs in the process
(``torch.autograd.profiler._is_profiler_enabled``, which the profiler
sets on entry and clears on exit), so a caller who profiles their own
process gets them.  Otherwise a span costs one attribute read and hands
back one shared no-op context: no clock read, no allocation, no torch
call.  In the program's own session (``profiled``, TIMG_TPU_PROFILE)
each span also opens a ``record_function`` range, so that it lands in
the profiler's Chrome trace beside the kernels it launched.  In anyone
else's session it opens none: the profiler marks ranges on the device's
timeline too, where they would read as device work.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time

CAP = 1 << 20             # records kept; past it they are counted only
ANCHOR = "timg.anchor"

Record = collections.namedtuple(
    "Record", "name t0_ns t1_ns parent_id span_id count thread_id")

_records: list = []
dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_range = None             # record_function, in the program's own session
_now = time.perf_counter_ns


class _BeforeTorch:
    """Stands for torch.autograd.profiler until torch is loaded (no
    session runs before): the first span after that swaps the module in,
    so that this module never loads torch itself."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _profiler
        module = sys.modules.get("torch.autograd.profiler")
        if module is None:
            return False
        _profiler = module
        return module._is_profiler_enabled


_profiler = _BeforeTorch()


class _Off:
    __slots__ = ("count",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "count", "t0", "span_id", "parent_id", "_rf")

    def __init__(self, name: str, count: int):
        self.name, self.count = name, count

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        self.parent_id = stack[-1] if stack else 0
        self.span_id = next(_ids)
        stack.append(self.span_id)
        self._rf = None
        if _range is not None:
            self._rf = _range(self.name)
            self._rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        global dropped
        t1 = _now()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        record = Record(self.name, self.t0, t1, self.parent_id,
                        self.span_id, int(self.count), _local.tid)
        with _lock:
            if len(_records) < CAP:
                _records.append(record)
            else:
                dropped += 1
        return False


def span(name: str, count: int = 0):
    """A context for one span of ``name`` (``lib.*``, ``window.*`` or
    ``seq.*``); ``count`` may also be set on it inside."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, count)


def records() -> list:
    """The spans recorded so far, in the order they ended."""
    return list(_records)


def clear() -> None:
    global dropped
    with _lock:
        _records.clear()
        dropped = 0


@contextlib.contextmanager
def profiled(directory):
    """The program's own profile session over the block, where
    ``directory`` is set: torch.profiler (the CPU, and the card when the
    port runs there), the spans as ranges, then the profiler's Chrome
    trace in ``<directory>/timg-tpu-torch.<pid>.trace.json``.  The
    profiler follows only the thread that opened it: the spans of the
    other threads (video windows, the sequencer's writer) are added to
    the trace as complete events on its clock, and every span carries
    its count and ids in ``args``."""
    global _range
    if not directory:
        yield
        return
    import torch

    from timg_tpu_torch.ops import backend

    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(activities=[act.CPU] + (
        [act.CUDA] if backend.device().type == "cuda" else []))
    prof.__enter__()
    since = _now()
    with torch.profiler.record_function(ANCHOR):
        anchor = _now()
    after = _now()
    _range = torch.profiler.record_function
    try:
        yield
    finally:
        _range = None
        prof.__exit__(None, None, None)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory,
                            f"timg-tpu-torch.{os.getpid()}.trace.json")
        prof.export_chrome_trace(path)
        _merge_spans(path, (since, anchor, after))
        print(f"torch profile written to {path}", file=sys.stderr)
        if dropped:
            print(f"timg: {dropped} spans dropped past {CAP}",
                  file=sys.stderr)


def _merge_spans(path: str, anchor: tuple) -> None:
    """Give the profiler's ranges of the program's spans their counts and
    ids, and add the spans of the threads it did not follow as complete
    events.  ``anchor``: perf_counter reads before, inside and after the
    anchor range; its start or its end, whichever lies in the narrower
    bracket, ties the two clocks."""
    import json

    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    mark = next(e for e in events if e.get("name") == ANCHOR)
    since_ns, inside, after = anchor
    if inside - since_ns <= after - inside:
        offset_us = mark["ts"] - (since_ns + inside) / 2e3
    else:
        offset_us = mark["ts"] + mark["dur"] - (inside + after) / 2e3
    mine = collections.defaultdict(list)
    for r in records():
        if r.t0_ns >= since_ns:
            mine[r.thread_id, r.name].append(r)
    seen = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and (e.get("tid"), e.get("name")) in mine:
            seen[e["tid"], e["name"]].append(e)
    followed = {tid for tid, _ in seen}
    for (tid, name), recs in mine.items():
        recs.sort(key=lambda r: r.t0_ns)
        if tid in followed:
            ranges = sorted(seen[tid, name], key=lambda e: e["ts"])
            for e, r in zip(ranges, recs):
                e.setdefault("args", {}).update(_args(r))
            continue
        events += [{"ph": "X", "cat": "timg_span", "name": name,
                    "pid": mark["pid"], "tid": tid,
                    "ts": r.t0_ns / 1e3 + offset_us,
                    "dur": (r.t1_ns - r.t0_ns) / 1e3, "args": _args(r)}
                   for r in recs]
    with open(path, "w") as f:
        json.dump(trace, f)


def _args(r: Record) -> dict:
    return {"count": r.count, "span_id": r.span_id,
            "parent_id": r.parent_id}
