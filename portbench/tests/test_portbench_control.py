"""The check's control: the plain reference in the program's place, in
float32 with TF32 products, comes out not correct in every cell; the
program itself comes out correct (both at a small size on the CPU)."""
import pytest

from portbench.control import readings
from portbench.tests.small import SMALL, small

CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_the_check(cell):
    (rec,) = readings(cell, [1234567891011], "control", 0.0, "cpu",
                      small(cell))
    assert rec["correct"] is False, rec


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_the_check(cell):
    (rec,) = readings(cell, [2 ** 31 + 7], "program", 0.0, "cpu",
                      small(cell))
    assert rec["correct"] is True, rec
