"""The control must come out as not correct: the reference computed in
the next precision below the configuration's (TF32 geometry, fp8
detector operands) in the program's place fails at least one of the
cell's limits, where the program itself passes them. On the card, at the
small size of slam_bench/tests/small.py; slam_bench/control.py reads the
same at the cells' own sizes."""

import pytest

from slam_bench import control
from slam_bench.harness import core
from slam_bench.tests import small


@pytest.mark.card
@pytest.mark.parametrize("cell", ("full_c32.rotloop_moving", "vo_batch11.sweep"))
def test_control_fails_where_the_program_passes(cell, card):
    got = control.readings(cell, small.SEED, 10.0, True, overrides=small.overrides(cell))
    limits = core.find_cell(cell).limits
    limits.update(small.overrides(cell).get("limits", {}))
    prog = core.check_limits(got["program"], limits)
    ctrl = core.check_limits(got["control"], limits)
    assert all(ok for *_, ok in prog), prog
    assert not all(ok for *_, ok in ctrl), ctrl
