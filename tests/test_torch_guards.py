"""The port's serving-hygiene guards (``repro_torch.analysis.guards``) held
against the reference's (``repro.analysis.guards``) on the same workloads:
each guard must give the same verdict in both packages, and the fleets
guarded must decide alike.

``no_recompiles`` counts, in the port, kernel-library builds, CUDA-graph
captures and step shapes a fleet or engine first runs eagerly; in the
reference, XLA compilations.  ``no_transfers`` on the CPU instruments the
tensors' host-read surface in the port, the arrays' in the reference; on
the card the port sets ``torch.cuda.set_sync_debug_mode("error")``, which
these tests drive through a stand-in for the two CUDA calls.

Tolerance: exact equality of decisions (integer and bit arithmetic).
"""

import jax
import numpy as np
import pytest
import torch

from repro.analysis import guards as j_guards
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.analysis import guards
from repro_torch.kernels import build
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.fleet import StreamingFleet
from test_torch_fleet import _assert_decisions_equal, _banks

jax.config.update("jax_platform_name", "cpu")

BUCKETS = (32, 64)
CH = 8


@pytest.fixture(scope="module")
def banks():
    return _banks(CH)


@pytest.fixture
def no_recompiles():
    """The port's ``no_recompiles``, as the reference's conftest fixture
    gives its own."""
    return guards.no_recompiles


@pytest.fixture
def no_transfers():
    return guards.no_transfers


def _fleets(banks, n=5):
    jbank, tbank = banks
    owners = [("a", "b", "c")[i % 3] for i in range(n)]
    return (JFleet(jbank, owners, backend="jnp", buckets=BUCKETS),
            StreamingFleet(tbank, owners, buckets=BUCKETS))


def _chunks(rng, n, lengths):
    return [rng.integers(0, 64, (int(t), CH), np.uint8) for t in lengths]


def test_no_recompiles_passes_on_a_bucketed_push_loop(banks, no_recompiles):
    """Once every bucket has run, pushes of any length stay in the buckets:
    neither package prepares a program, and they decide alike."""
    jf, tf = _fleets(banks)
    rng = np.random.default_rng(0)
    for t in BUCKETS:          # first run of each bucket, outside the guard
        chunks = _chunks(rng, 5, [t] * 5)
        _assert_decisions_equal(tf.push(chunks), jf.push(chunks))
    loop = [_chunks(rng, 5, rng.integers(0, 150, 5)) for _ in range(4)]
    with no_recompiles() as rec:
        got = [tf.push(c) for c in loop]
    assert rec.compiled == [] and rec.builds == [] and rec.captures == []
    with j_guards.no_recompiles() as jrec:
        want = [jf.push(c) for c in loop]
    assert jrec.compiled == []
    for g, w in zip(got, want):
        _assert_decisions_equal(g, w)
    assert tf.compile_count == len(BUCKETS) and tf.aot_count == 0


def test_no_recompiles_fails_on_an_unbucketed_shape(banks, no_recompiles):
    """The engine pads the batch to a power of two but not the request
    length: a new length is a new program in both packages."""
    jbank, tbank = banks
    je, te = JEngine(jbank), ServingEngine(tbank)
    rng = np.random.default_rng(1)
    req = [("a", rng.integers(0, 64, (64, CH), np.uint8))]
    te.serve(req)
    je.serve(req)
    with no_recompiles():
        te.serve(req)
    new = [("b", rng.integers(0, 64, (96, CH), np.uint8))]
    with pytest.raises(guards.GuardViolation, match="eager:engine"):
        with no_recompiles():
            te.serve(new)
    with pytest.raises(j_guards.GuardViolation):
        with j_guards.no_recompiles():
            je.serve(new)
    newer = [("c", rng.integers(0, 64, (128, CH), np.uint8))]
    with no_recompiles(allow=1) as rec:
        d = te.serve(newer)
    assert len(rec.eager) == 1
    np.testing.assert_array_equal(d[0].scores, np.asarray(je.serve(newer)[0].scores))


def test_no_recompiles_counts_a_kernel_build(monkeypatch, no_recompiles):
    """An nvcc build inside the region is a violation, named by the
    library it built."""
    monkeypatch.setattr(build, "BUILD_LOG", list(build.BUILD_LOG))
    with pytest.raises(guards.GuardViolation, match="build:libhdc_kernels_x.so"):
        with no_recompiles():
            build.BUILD_LOG.append("libhdc_kernels_x.so")


def test_no_transfers_passes_on_push_raw_and_raises_on_collect_decisions(
        banks, no_transfers):
    """A push never reads the device (the staging buffers' numpy views are
    host memory); collecting decisions does, in both packages."""
    jf, tf = _fleets(banks)
    rng = np.random.default_rng(2)
    warm = _chunks(rng, 5, [40] * 5)
    jf.push(warm)
    tf.push(warm)
    chunks = _chunks(rng, 5, [0, 31, 64, 100, 7])
    with no_transfers():
        rounds = tf.push_raw(chunks)
    with j_guards.no_transfers():
        jrounds = jf.push_raw(chunks)
    assert len(rounds) == len(jrounds) == 2
    with pytest.raises(guards.GuardViolation, match="numpy"):
        with no_transfers():
            tf.collect_decisions(rounds)
    with pytest.raises(j_guards.GuardViolation):
        with j_guards.no_transfers():
            jf.collect_decisions(jrounds)
    _assert_decisions_equal(tf.collect_decisions(rounds), jf.collect_decisions(jrounds))


@pytest.mark.parametrize("method", ["item", "numpy", "tolist", "__array__",
                                    "__int__", "__float__", "__bool__"])
def test_no_transfers_blocks_each_host_read_and_restores_it(method, no_transfers):
    x = torch.arange(1, 2, dtype=torch.int32)
    with pytest.raises(guards.GuardViolation, match=method):
        with no_transfers(device="cpu"):
            getattr(x, method)()
    getattr(x, method)()      # restored after the region
    with no_transfers(device="cpu"):
        y = (x * 2).sum()     # tensor work is fine
    assert int(y) == 2


def test_no_transfers_exempts_only_marked_host_buffers(no_transfers):
    buf = torch.zeros(4, dtype=torch.uint8)
    buf._host_staging = True
    other = torch.zeros(4, dtype=torch.uint8)
    with no_transfers(device="cpu"):
        buf.numpy()[:] = 3
        with pytest.raises(guards.GuardViolation):
            np.asarray(other)
    assert buf.tolist() == [3, 3, 3, 3]


def test_no_transfers_on_the_card_sets_sync_debug_mode(monkeypatch, no_transfers):
    """On a CUDA device the region runs under sync-debug mode "error" and
    restores the previous mode; a synchronising call's RuntimeError becomes
    a GuardViolation, any other error passes through."""
    modes = ["warn"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with no_transfers(device="cuda"):
        assert modes[-1] == "error"
    assert modes == ["warn", "error", "warn"]
    with pytest.raises(guards.GuardViolation, match="host sync"):
        with no_transfers(device="cuda"):
            raise RuntimeError("called a synchronizing CUDA operation")
    with pytest.raises(RuntimeError, match="other"):
        with no_transfers(device="cuda"):
            raise RuntimeError("other")
    assert modes[-1] == "warn"
