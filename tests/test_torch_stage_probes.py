"""``StreamingFleet.stage_probes`` held against the reference's: on a CPU
fleet the four stages (``ingest``, ``spatial``, ``temporal``, ``am``) of one
round on tile 0, each output bit-equal to the reference jnp fleet's same
probe on the same bank (transferred through ``repro_torch.convert``), for
``sparse_compim``, a masked ``sparse_compim`` fleet (every spatial mode of
the mask: OR and, with thinning, the adder tree) and a masked ``dense``
fleet (the majority and the Hamming AM); and the
guard that refuses a fleet whose tiles step on the card (the fused kernel's
route), tested on a CPU fleet whose tile devices read as the card.

Tolerance: exact equality (integer and bit arithmetic).
"""

import numpy as np
import pytest
import torch

from repro.reliability.faults import FaultConfig
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.core import hv
from repro_torch.serve.fleet import StreamingFleet
from test_torch_channels import _banks, _random_masks
from test_torch_online import CHANNELS, WINDOW

CASES = [("sparse_compim", False, False), ("sparse_compim", False, True),
         ("sparse_compim", True, True), ("dense", False, True)]
IDS = ["or", "or-masked", "thin-masked", "dense-masked"]
SESSIONS, TILE = 6, 4      # two tiles: the probes run on tile 0, scale 2


def _fleets(variant, thinning, masked):
    jbank, tbank = _banks(variant, thinning)
    owners = ["p0", "p1", "p1", "p0", "p1", "p0"]
    kw = dict(buckets=(16, WINDOW), tile=TILE)
    if masked:
        ref = JFleet(jbank, owners, backend="jnp", channel_masking=True,
                     faults=FaultConfig(), **kw)
        port = StreamingFleet(tbank, owners, channel_masking=True, **kw)
        mask = _random_masks(np.random.default_rng(3), SESSIONS, 3)
        ref.set_channel_mask(mask)
        port.set_channel_mask(mask)
    else:
        ref = JFleet(jbank, owners, backend="jnp", **kw)
        port = StreamingFleet(tbank, owners, **kw)
    return ref, port


@pytest.mark.parametrize("variant,thinning,masked", CASES, ids=IDS)
def test_stages_equal_the_reference_probes(variant, thinning, masked):
    ref, port = _fleets(variant, thinning, masked)
    rng = np.random.default_rng(7)
    warm = rng.integers(0, 64, (SESSIONS, WINDOW + 5, CHANNELS), np.uint8)
    ref.push(list(warm))
    port.push(list(warm))     # class rows and fill levels past round one
    batch = rng.integers(0, 64, (SESSIONS, WINDOW, CHANNELS), np.uint8)
    want, got = ref.stage_probes(batch), port.stage_probes(batch)
    assert set(got) == set(want) == {"ingest", "spatial", "temporal", "am"}
    assert {k: s for k, (_, s) in got.items()} == {k: s for k, (_, s) in want.items()}
    assert got["spatial"][1] == 2 and got["ingest"][1] == 1
    for stage in ("spatial", "temporal", "am"):
        g, w = got[stage][0](), np.asarray(want[stage][0]())
        g = hv.to_u32(g) if stage == "spatial" else g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=stage)
    assert got["ingest"][0]() is None and want["ingest"][0]() is None
    stage, lens = port._stage_buf(0, 0, WINDOW)
    np.testing.assert_array_equal(stage.numpy()[:TILE], batch[:TILE])
    np.testing.assert_array_equal(lens.numpy(), WINDOW)


def test_probes_leave_the_fleet_as_it_was():
    """The class rows are a clone: running every probe changes no state,
    and the next push decides as the reference's."""
    ref, port = _fleets("sparse_compim", False, False)
    rng = np.random.default_rng(8)
    batch = rng.integers(0, 64, (SESSIONS, WINDOW, CHANNELS), np.uint8)
    rows = port.class_rows.copy()
    for fn, _ in port.stage_probes(batch).values():
        fn()
    np.testing.assert_array_equal(port.class_rows, rows)
    chunks = list(rng.integers(0, 64, (SESSIONS, WINDOW, CHANNELS), np.uint8))
    for g, w in zip(port.push(chunks), ref.push(chunks)):
        assert [d.prediction for d in g] == [d.prediction for d in w]


def test_guards():
    """A fleet on the card raises, as the reference's Pallas fleet does;
    a round longer than the largest bucket raises."""
    _, port = _fleets("sparse_compim", False, False)
    batch = np.zeros((SESSIONS, WINDOW, CHANNELS), np.uint8)
    with pytest.raises(ValueError, match="stage_probes needs one round"):
        port.stage_probes(np.zeros((SESSIONS, WINDOW + 1, CHANNELS), np.uint8))
    port._tile_devs = [torch.device("cuda", 0)] * port.n_tiles
    with pytest.raises(ValueError, match="fused CUDA kernel"):
        port.stage_probes(batch)
