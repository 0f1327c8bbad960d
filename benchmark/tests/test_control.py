"""The control of each cell's comparison: the reference computed in
bfloat16 in the program's place fails the comparison that the program
passes (test_harness), here at a tiny size."""

import pytest

import control
from conftest import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_comparison(name, tiny):
    cell = tiny(name)
    bad, n = control.control(cell, 2**31 + 5, 6)
    assert n == 6 and bad > 0
