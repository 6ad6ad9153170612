"""The control (the reference put in the program's place, its signal in
bfloat16) and each fault planted in it fail the comparison; the reference
in the configuration's precision passes it."""

import pytest

from bench import control
from bench.conftest import SEED, TINY


@pytest.mark.parametrize("cell", ["compim.review", "dense.review", "compim.onboard"])
def test_the_control_and_every_fault_fail(cell):
    kind = "onboard" if cell.endswith("onboard") else "review"
    # a seed whose sampled jobs the retraining epochs change (on some seeds
    # at this size one-shot training already classifies every frame, and a
    # frozen retraining is then the same answer)
    got = control.readings(cell, SEED + 3, "cpu", TINY[kind], jobs=6)
    assert set(got) >= {"control", "half", "altered"}
    for reading, nums in got.items():
        assert any(v > 0 for v in nums.values()), (reading, nums)
