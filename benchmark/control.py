#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the precision below the configuration's
(bfloat16 for its float32 stages), judged by the same comparison.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--frames n]

For each seed it makes the cell's decoded frames, takes ``--frames``
answers drawn from the seed (the cell's ``check_frames`` by default),
and counts those whose bytes differ between the bfloat16 and the
float32 reference: the control's reading of ``mismatched``, which has
to exceed the limit (0).  Numpy only; the program is not loaded.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

from harness import check, spec  # noqa: E402
from harness.frames import make_pool  # noqa: E402
from reference.precision import BF16, F32  # noqa: E402

# answers are drawn from this many frames or payloads past the warm-up
SPAN = 4096


class PoolInputs:
    """The cell's decoded inputs, as a run makes them from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.config, self.traffic = config, traffic
        size = config["frames"]
        self.pool = make_pool(traffic["content"],
                              int(traffic["pool_frames"]),
                              int(size["height"]), int(size["width"]), seed)

    def frame(self, k: int):
        return self.pool[k % len(self.pool)]


def control(cell, seed: int, frames: int) -> tuple:
    """(mismatched, compared) of the bfloat16 reference on ``seed``."""
    inputs = PoolInputs(cell.config, cell.traffic, seed)
    rng = random.Random(seed)
    keys = sorted(rng.sample(range(16, 16 + SPAN), frames))
    bad = sum(check.expected(inputs, k, BF16) != check.expected(inputs, k, F32)
              for k in keys)
    return bad, len(keys)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    frames = args.frames or int(cell.traffic["check_frames"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        bad, n = control(cell, seed, frames)
        print(f"control {cell.name} seed {seed}: mismatched {bad} of {n} "
              f"(limit {check.LIMITS['mismatched']}; "
              f"{time.perf_counter() - t:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
