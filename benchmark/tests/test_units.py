"""The sample, the frame generator and the roofline counts."""

import ast
import os

import numpy as np
import pytest

from conftest import ROOT
from harness import roofline
from harness.frames import make_pool
from harness.sample import Sample
from harness.spec import traffic_mix


def test_sample_is_seeded_and_keeps_the_last():
    def draw(seed):
        s = Sample(4, seed)
        for k in range(100):
            s.offer(k, bytes([k]))
        return s.chosen()
    assert draw(3) == draw(3)
    assert 99 in draw(3) and len(draw(3)) in (4, 5)
    assert draw(3) != draw(4)


def test_sample_keeps_every_position_of_the_batch():
    s = Sample(8, 5, strata=4)
    for k in range(400):
        s.offer(k, bytes([k % 256]))
    chosen = s.chosen()
    assert len(chosen) in (8, 9) and 399 in chosen
    assert sorted(k % 4 for k in chosen if k != 399) == [0, 0, 1, 1, 2, 2,
                                                          3, 3]


def test_pools_repeat_by_seed_and_frames_differ():
    content = traffic_mix("batch-film")["content"]
    a = make_pool(content, 4, 54, 96, 2**31 + 3)
    b = make_pool(content, 4, 54, 96, 2**31 + 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a, make_pool(content, 4, 54, 96, 2**31 + 4))


def chip_smoke_constants():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            if all(isinstance(n, (ast.Constant, ast.BinOp, ast.Tuple,
                                  ast.operator, ast.Load))
                   for n in ast.walk(node.value)):
                out[node.targets[0].id] = eval(compile(
                    ast.Expression(node.value), "chip_smoke.py", "eval"),
                    {"__builtins__": {}})
    return out


def test_peaks_are_chip_smokes():
    c = chip_smoke_constants()
    assert roofline.HBM_BYTES_PER_S == c["HBM_BYTES_PER_S"]
    assert roofline.F32_OPS_PER_S == 132 * 128 * 1.98e9


def test_bytes_are_read_once_and_written_once():
    # the stb stage: the frames in and the composed frames out
    nbytes, _ = roofline.stb_resize_compose(3, 10, 20, 5, 8, 4, 4, True)
    assert nbytes == 3 * 4 * (10 * 20 + 5 * 8)
