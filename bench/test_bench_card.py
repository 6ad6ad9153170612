"""One short run of each cell on the card at a small size: the kernels, the
profiler's trace and its readers.  Skips without a card."""

import pytest

from bench import harness
from bench.conftest import SEED, TINY


@pytest.mark.card
@pytest.mark.parametrize("cell", ["compim.review", "dense.review", "compim.onboard"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_run_on_the_card(card, cell, traced):
    kind = "onboard" if cell.endswith("onboard") else "review"
    res = harness.run(cell, SEED + 3, 0.5, traced, device=card, traffic_overrides=TINY[kind])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["metrics"]
