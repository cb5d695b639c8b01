"""The control at a size a test run holds: the reference with TF32
products in the program's place must fail a compared number of each
cell. The TF32 rounding is the reference's own, so the CPU serves."""

import pytest

from wsprbench import compare, control
from wsprbench.run import load_cell


@pytest.mark.parametrize("name,windows,check", [
    ("farm.mixed", 8, 8), ("chain.raw", 1, 1)])
def test_the_control_is_not_correct(name, windows, check):
    cell = load_cell(name)
    cell.mix = dict(cell.mix, windows=windows, check_windows=check)
    numbers = control.readings(cell, 2**31 + 17, device="cpu")
    ok, checks = compare.judge(numbers, cell.limits)
    assert not ok, checks
