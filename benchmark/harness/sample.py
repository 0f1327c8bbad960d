"""A seeded sample of the answers a run produced, kept as they come."""

from __future__ import annotations

import random
import threading


class Sample:
    """Reservoir sample of ``size`` (key, bytes) answers offered one by
    one, drawn from ``seed``.  With ``strata`` > 1 the answers are split
    by ``key % strata`` (a payload's position in its batch) and each
    position keeps its own reservoir of ``size // strata`` (at least 1),
    so every position is judged in every run.  The last answer offered
    is always kept beside them, so the run's final state is judged too."""

    def __init__(self, size: int, seed: int, strata: int = 1):
        self._rng = random.Random(seed * 2654435761 + 12345)
        self._strata = strata
        self._size = max(1, size // strata)
        self._keys = [[] for _ in range(strata)]
        self._seen = [0] * strata
        self.items = {}
        self.last = None
        self._lock = threading.Lock()

    def offer(self, key, data) -> None:
        with self._lock:
            s = key % self._strata
            self._seen[s] += 1
            self.last = (key, bytes(data))
            keys = self._keys[s]
            if len(keys) < self._size:
                keys.append(key)
                self.items[key] = self.last[1]
                return
            j = self._rng.randrange(self._seen[s])
            if j < self._size:
                del self.items[keys[j]]
                keys[j] = key
                self.items[key] = self.last[1]

    def chosen(self) -> dict:
        """key -> bytes: the reservoirs and the last answer."""
        out = dict(self.items)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out
