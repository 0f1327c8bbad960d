"""Host spans, taken by wrapping the program's functions from here.

The program has no spans of its own yet.  A per-layer metric's reader
(``metrics/<name>.py``) names the spans it needs in ``SPANS``: {layer:
["module:attribute", ...]}, the entries at which that layer is timed;
and in ``RANGES`` the layers that also open a torch.profiler range, so
that the device time of the kernels they launch is attributed to them.
In a traced run the harness wraps the entries that the cell's per-layer
metrics name, records when each call began and ended
(``time.perf_counter_ns``, any thread), and puts them back when the run
ends.  A layer's entry that calls itself (a fallback) counts once.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import defaultdict


def declared(readers) -> tuple:
    """({layer: [entry, ...]}, ranges): what the metric modules
    ``readers`` name, merged."""
    points, ranges = {}, set()
    for reader in readers:
        for layer, entries in getattr(reader, "SPANS", {}).items():
            known = points.setdefault(layer, [])
            known += [e for e in entries if e not in known]
        ranges.update(getattr(reader, "RANGES", ()))
    return points, tuple(sorted(ranges))


def _resolve(entry: str):
    module, attr = entry.split(":")
    owner = importlib.import_module(module)
    *path, leaf = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, leaf


class Spans:
    def __init__(self, points: dict, ranges=()):
        self.records = defaultdict(list)     # layer -> [(t0_ns, t1_ns)]
        self._lock = threading.Lock()
        self._local = threading.local()
        self._undo = []
        self._points = points
        self._ranges = ranges

    def install(self) -> None:
        for layer, entries in self._points.items():
            for entry in entries:
                owner, leaf = _resolve(entry)
                fn = getattr(owner, leaf)
                setattr(owner, leaf, self._wrap(layer, fn))
                self._undo.append((owner, leaf, fn))

    def restore(self) -> None:
        while self._undo:
            owner, leaf, fn = self._undo.pop()
            setattr(owner, leaf, fn)

    def _wrap(self, layer: str, fn):
        local, records, lock = self._local, self.records, self._lock
        profiled = layer in self._ranges

        def wrapper(*args, **kwargs):
            if getattr(local, layer, False):
                return fn(*args, **kwargs)
            setattr(local, layer, True)
            t0 = time.perf_counter_ns()
            try:
                if profiled:
                    import torch
                    with torch.profiler.record_function(layer):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter_ns()
                setattr(local, layer, False)
                with lock:
                    records[layer].append((t0, t1))

        wrapper.__wrapped__ = fn
        return wrapper

    def seconds(self, layer: str, lo_ns: int, hi_ns: int) -> float:
        """Host seconds in ``layer``'s calls that began in [lo, hi)."""
        return sum(t1 - t0 for t0, t1 in self.records.get(layer, ())
                   if lo_ns <= t0 < hi_ns) / 1e9
