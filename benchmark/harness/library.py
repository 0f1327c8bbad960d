"""The embeddable library API, driven as one caller drives it: batch
after batch of decoded RGBA frames handed to a model's
``render_batch``, each call waited for (a closed loop).  Payload g of
the run is pool frame g % pool_frames."""

from __future__ import annotations

import time

from harness.frames import make_pool
from harness.sample import Sample


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.batch = int(config["batch"])
        self.returned = 0             # payloads returned, warm-up included
        self.first_measured = 0
        self.done = []                # (end ns, payloads) a call
        # a payload of each position in the batch, at least
        self.sample = Sample(int(traffic["check_frames"]), seed,
                             strata=self.batch)

    def setup(self) -> None:
        from timg_tpu_torch import models

        cfg, frames = self.config, self.config["frames"]
        self.model = models.get(cfg["model"])(
            out_h=int(cfg["out_h"]), out_w=int(cfg["out_w"]),
            bg_color=tuple(cfg["bg_color"]))
        n = int(self.traffic["pool_frames"])
        if n % self.batch:
            raise ValueError("pool_frames must be a multiple of the batch")
        self.pool = make_pool(self.traffic["content"], n,
                              int(frames["height"]), int(frames["width"]),
                              self.seed)

    def frame(self, g: int):
        return self.pool[g % len(self.pool)]

    def _call(self, measured: bool) -> None:
        g0 = self.returned
        i = g0 % len(self.pool)
        payloads = self.model.render_batch(self.pool[i:i + self.batch])
        t = time.perf_counter_ns()
        self.returned += len(payloads)
        if measured:
            self.done.append((t, len(payloads)))
            for j, p in enumerate(payloads):
                self.sample.offer(g0 + j, p)

    def warm(self) -> None:
        for _ in range(int(self.traffic["warm_batches"])):
            self._call(False)
        self.first_measured = self.returned

    def window(self, seconds: float) -> tuple:
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        while time.perf_counter_ns() < end:
            self._call(True)
        return t0, time.perf_counter_ns()

    def drain(self, timeout_s: float = 60.0) -> bool:
        return True                   # every call has returned

    def attempted(self) -> int:
        """Payloads asked for during the measured window."""
        return sum(n for _, n in self.done)

    def attempted_between(self, lo_ns: int, hi_ns: int) -> int:
        """Payloads of the calls that returned inside [lo, hi]."""
        return self.answered_between(lo_ns, hi_ns)

    def unanswered(self) -> int:
        return 0                      # render_batch returns every payload

    def answered_between(self, lo_ns: int, hi_ns: int) -> int:
        """Payloads of the calls that returned inside [lo, hi]."""
        return sum(n for t, n in self.done if lo_ns <= t <= hi_ns)

    def notes(self) -> dict:
        return {"payloads returned": self.returned}

    def close(self) -> None:
        self.model = None
