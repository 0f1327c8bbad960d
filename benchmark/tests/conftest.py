"""The benchmark's own tests, on the CPU at a tiny size: the harness
and the plain reference, run with the program's plain versions
(TIMG_TPU_TORCH_DEVICE=cpu).  Run from the checkout's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

from harness import spec  # noqa: E402

# 192x108 frames into a 10x32 canvas, batches of 4: every stage of the
# cell runs, at sizes a test holds
TINY_FRAMES = (108, 192)


def shrink(cell):
    """The cell at a tiny size: its frames 192x108, a small canvas,
    small pools and batches."""
    h, w = TINY_FRAMES
    cell.config["frames"].update(width=w, height=h)
    cell.config.update(out_h=10, out_w=32, batch=4)
    cell.traffic.update(pool_frames=16, check_frames=6)
    return cell


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", "cpu")


SPEC = spec.load_json(spec.SPEC_PATH)
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def tiny():
    return lambda name: shrink(spec.load_cell(name, SPEC))
