"""The program audit (``repro_torch.analysis.audit``, ``python -m
repro_torch.analysis --audit``) held against the reference's HLO audit
(``repro.analysis.hlo_audit``).

* The reference's ``run_audit(backend="jnp")`` and the port's
  ``run_audit(device="cpu")`` give the same four entries (the fleet's step
  and adapt at two sessions and bucket 32, the engine at batch buckets 1
  and 2), with equal verdicts, and the step writes its nine state leaves
  in place as the reference's donates and aliases them.
* Ports of the reference's planted cases: a body that copies its state
  passes and one that rebinds a leaf fails; ``.item()``, ``nonzero``, a
  host read and a copy between devices are host escapes; an unpinned
  int32 ``sum``, an int32 buffer added to or selected with an ``arange``
  and a float64 buffer fail the width rule, a pinned ``sum``, an
  ``arange`` index, an explicit int64 cast, an int64 table at int32
  indices, a bool mask over int64, a write into an int64 buffer and a
  one-element int64 pass.
* A kernel's plain version is one opaque operation: its int64 carriers
  are not reported, its name is in the entry's kernels, and a kernel the
  program's capture does not hold is reported.
* The factored program makers run what the eager fleet runs: a step or
  adapt body, run once on a CPU fleet, leaves the state the eager path
  leaves, bit for bit.
* The CLI exits 0 on the tree and 1 with a planted failing entry.

All on the CPU.  Tolerance: exact equality (integer and bit arithmetic).
"""

import json
import os
import re
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import hlo_audit
from repro_torch.analysis import audit
from repro_torch.analysis.__main__ import main
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.kernels.hdc_fleet import ops as fleet_ops
from repro_torch.kernels.hdc_fleet.ref import emission_masks, fleet_counts_plain
from repro_torch.reliability.faults import FaultConfig
from repro_torch.runtime import graphs
from repro_torch.serve.fleet import FleetState, StreamingFleet

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"^(?:fleet\.[^.]+\.[^.]+(?:\.faulted)?(?:\.masked)?\.s(\d+)"
                   r"(?:\.t(\d+))?\.(step|adapt)|(engine)\.[^.]+\.b(\d+)\.t(\d+))\.")


def _key(name: str) -> tuple:
    """(kind, tile or batch, bucket) of an entry name of either package."""
    m = _NAME.match(name)
    assert m, name
    if m.group(4):
        return ("engine", int(m.group(5)), int(m.group(6)))
    return (m.group(3), int(m.group(1)), None if m.group(2) is None else int(m.group(2)))


@pytest.fixture(scope="module")
def reports():
    return hlo_audit.run_audit(backend="jnp"), audit.run_audit(device="cpu")


def test_entries_match_the_reference(reports):
    ref, port = reports
    want = {_key(e.name): e for e in ref.entries}
    got = {_key(e.name): e for e in port.entries}
    assert sorted(got, key=str) == sorted(want, key=str) == sorted(
        [("step", 2, 32), ("adapt", 2, None), ("engine", 1, 32), ("engine", 2, 32)], key=str)
    for key, r in want.items():
        p = got[key]
        assert p.ok == r.ok is True, (key, p.problems)
        assert p.kind == key[0]
        assert p.expected_in_place == r.expected_donated
    step, ref_step = got[("step", 2, 32)], want[("step", 2, 32)]
    assert step.in_place == step.expected_in_place == ref_step.expected_donated == 9
    assert ref_step.aliased == 9
    assert sorted(step.written) == ["counts", "filled", "frame_index", "has_frame",
                                    "last_frame", "last_scores"]
    assert got[("adapt", 2, None)].in_place == 9          # reported, not held
    assert sorted(got[("adapt", 2, None)].written) == ["am_counts", "am_n", "class_rows"]
    for key in (("step", 2, 32), ("engine", 1, 32), ("engine", 2, 32)):
        assert got[key].kernels == ["hdc_fleet"]
    assert got[("adapt", 2, None)].kernels == []
    for e in port.entries:
        assert not e.host_escapes and not e.wide and not e.replayed
        assert "f64" not in e.dtype_histogram and e.dtype_histogram.get("i32", 0) > 0


# ---------------------------------------------------------------------------
# planted programs (the reference's tests/test_analysis.py audit cases)
# ---------------------------------------------------------------------------

def _program(body, state=None, eager=None, counted=()):
    return graphs.Program(name="planted", kind="step", body=body, state=state or {},
                          eager=eager, counted=counted)


@pytest.mark.parametrize("rebind", [False, True], ids=["copied", "rebound"])
def test_state_written_in_place(rebind):
    s = torch.arange(64, dtype=torch.int32)
    x = torch.full((64,), 3, dtype=torch.int32)
    held = {"s": s}

    def body():
        new = held["s"] + x
        if rebind:
            held["s"] = new          # the replay would keep the stale leaf
        else:
            s.copy_(new)
        return (new,)

    a = audit.audit_entry(_program(body, {"s": s}, lambda leaves: {"s": leaves["s"] + x}),
                          expected_in_place=1)
    if rebind:
        assert not a.ok and a.in_place == 0 and a.written == []
        assert any("in place" in p for p in a.problems), a.problems
    else:
        assert a.ok and a.in_place == 1 and a.written == ["s"], a.problems
    assert torch.equal(s, torch.arange(64, dtype=torch.int32))   # put back


def test_a_leaf_passed_through_is_in_place_and_a_moved_one_is_not():
    a_leaf, b_leaf = torch.zeros(8, dtype=torch.int32), torch.ones(8, dtype=torch.int32)

    def body():
        b_leaf.set_(torch.full((8,), 5, dtype=torch.int32))   # another storage
        return ()

    got = audit.audit_entry(
        _program(body, {"a": a_leaf, "b": b_leaf},
                 lambda leaves: {"a": leaves["a"], "b": torch.full((8,), 5, dtype=torch.int32)}),
        expected_in_place=2)
    assert got.in_place == 1 and "b" in got.not_in_place and "a" not in got.not_in_place
    assert "storage" in got.not_in_place["b"]


_X = torch.arange(32, dtype=torch.int32).reshape(8, 4)
_TABLE = torch.arange(64, dtype=torch.int64)

ESCAPES = {
    "item": lambda: (_X + int(_X[0, 1].item()),),
    "nonzero": lambda: (torch.nonzero(_X),),
    "tolist": lambda: (_X + len(_X.tolist()),),
    "numpy": lambda: (_X + int(_X.numpy().shape[0]),),
    "device copy": lambda: (_X.to("meta"),),
}


@pytest.mark.parametrize("case", sorted(ESCAPES))
def test_host_escapes_are_reported(case):
    a = audit.audit_entry(_program(ESCAPES[case]))
    assert not a.ok and a.host_escapes, a.problems
    assert any(p.startswith("host escapes") for p in a.problems)
    assert all("test_torch_audit.py:" in h for h in a.host_escapes), a.host_escapes


WIDTHS = {   # body -> passes?
    "unpinned int32 sum": (lambda: (_X.sum(1),), False),
    "unpinned bool cumsum": (lambda: ((_X > 3).cumsum(1),), False),
    "float64 buffer": (lambda: (_X.to(torch.float64) * 2,), False),
    "int32 + arange": (lambda: (_X + torch.arange(4),), False),
    "int32 where int64": (lambda: (torch.where(_X > 3, _X, torch.arange(32).reshape(8, 4)),),
                          False),
    "int64 table at int32 indices": (lambda: (_TABLE[_X[:, 0]] * 2,), True),
    "bool mask over int64": (lambda: (torch.where(_X > 3, torch.arange(4), 0),), True),
    "write into int64": (lambda: (torch.zeros(8, 4, dtype=torch.int64).add_(_X),), True),
    "pinned sum": (lambda: (_X.sum(1, dtype=torch.int32),), True),
    "arange index": (lambda: (_X[torch.arange(8), 1],), True),
    "explicit int64 index": (lambda: (_X[:, 0].to(torch.int64) * 4,), True),
    "one-element int64": (lambda: (_X + _X[:1, :1].sum(),), True),
}


@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_dtype_width_rule(case):
    body, passes = WIDTHS[case]
    a = audit.audit_entry(_program(body))
    assert a.ok == passes, a.problems
    if not passes:
        assert any(p.startswith("64-bit widening") for p in a.problems)
        assert all("test_torch_audit.py:" in w for w in a.wide), a.wide
    elif case not in ("pinned sum", "one-element int64"):
        assert a.explicit_i64 >= 1


def test_widening_names_the_port_line():
    """A finding inside the port names the innermost repro_torch line."""
    from repro_torch.core import hv

    words = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    a = audit.audit_entry(_program(lambda: (hv.lax_popcount(words).sum(1),)))
    assert not a.ok and a.wide and "test_torch_audit.py:" in a.wide[0]
    a = audit.audit_entry(_program(lambda: (hv.popcount(words),)))
    assert a.ok, a.problems


# ---------------------------------------------------------------------------
# kernels are opaque
# ---------------------------------------------------------------------------

def _fleet_operands():
    g = torch.Generator().manual_seed(3)
    tables = torch.randint(-2**31, 2**31 - 1, (2, 8, 64, 8), generator=g, dtype=torch.int64)
    tables = tables.to(torch.int32)
    owner = torch.tensor([0, 1, 1], dtype=torch.int32)
    codes = torch.randint(0, 64, (3, 32, 8), generator=g, dtype=torch.uint8)
    tm = emission_masks(torch.zeros(3, dtype=torch.int32),
                        torch.tensor([32, 20, 7], dtype=torch.int32), t_pad=32, window=16)
    return tables, owner, codes, tm


@pytest.mark.parametrize("counted", [True, False], ids=["held", "not held"])
def test_the_plain_kernel_is_one_operation(counted):
    ops = _fleet_operands()
    wrapped = audit.audit_entry(_program(
        lambda: (fleet_ops.fleet_counts_kernel(*ops, mode="or", dim=256),),
        counted=(fleet_ops.fleet_counts_kernel,) if counted else ()))
    assert wrapped.kernels == ["hdc_fleet"]
    assert "i64" not in wrapped.dtype_histogram and wrapped.explicit_i64 == 0
    assert not wrapped.wide and not wrapped.host_escapes
    if counted:
        assert wrapped.ok, wrapped.problems
    else:
        assert not wrapped.ok and wrapped.unexpected_kernels == ["hdc_fleet"]
        assert any("capture does not hold" in p for p in wrapped.problems)
    # the same plain version called outside its wrapper shows its carriers
    bare = audit.audit_entry(_program(lambda: (fleet_counts_plain(*ops, mode="or", dim=256),)))
    assert bare.kernels == [] and bare.dtype_histogram.get("i64", 0) > 0
    assert bare.explicit_i64 > 0


# ---------------------------------------------------------------------------
# the factored program makers run what the eager path runs
# ---------------------------------------------------------------------------

CH, WINDOW = 8, 32


@pytest.fixture(scope="module")
def bank():
    cfg = HDCConfig(dim=256, segments=8, channels=CH, window=WINDOW,
                    variant="sparse_compim", spatial_threshold=1, temporal_threshold=4)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 64, (2, 4 * WINDOW, CH), np.uint8)
    labels = rng.integers(0, 2, (2, 4), np.int32)
    labels[0, :2] = (0, 1)
    return {f"p{i}": HDCPipeline.init(torch.Generator().manual_seed(i), cfg, device="cpu")
            .train_one_shot(codes, torch.as_tensor(labels)) for i in range(2)}


FLEETS = {"plain": {}, "masked": {"channel_masking": True},
          "faulted": {"faults": FaultConfig(tables=1e-2, am=1e-2, counts=1e-2, ecc="secded")}}


@pytest.mark.parametrize("kind", sorted(FLEETS) + ["adapt"])
def test_program_body_equals_the_eager_path(bank, kind):
    kw = FLEETS.get(kind, {})
    owners = ["p0", "p1", "p0"]
    rng = np.random.default_rng(7)
    first = [rng.integers(0, 64, (t, CH), np.uint8) for t in (40, 20, 33)]
    fleets = [StreamingFleet(bank, owners, buckets=(WINDOW,), **kw) for _ in range(2)]
    for f in fleets:
        if kind == "masked":
            m = np.ones((3, CH), np.uint8)
            m[1, [2, 5]] = 0
            f.set_channel_mask(m)
        f.push(first)
    built, eager = fleets
    chunk = torch.from_numpy(rng.integers(0, 64, (3, WINDOW, CH), np.uint8))
    lens = torch.tensor([32, 17, 0], dtype=torch.int32)
    if kind == "adapt":
        labels = torch.tensor([1, 0, -1])
        prog = built._adapt_program(0)
        prog.inputs["labels"].copy_(labels)
        out = prog.body()
        app = eager.adapt(labels.numpy())
        assert np.array_equal(out[0].numpy(), app)
    else:
        prog = built._step_program(0, WINDOW)
        prog.inputs["codes"].copy_(chunk)
        prog.inputs["lengths"].copy_(lens)
        out = prog.body()
        fo = eager._eager_step(0, WINDOW, chunk, lens, built._stage_phase)
        assert torch.equal(out[0], fo.frames) and torch.equal(out[1], fo.scores)
    assert list(prog.state) == [f.name for f in fields(FleetState)]
    for name, leaf in prog.state.items():
        assert leaf is getattr(built._state_t[0], name)        # the fleet's own state
        assert torch.equal(leaf, getattr(eager._state_t[0], name)), name


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_audit_on_the_cpu(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--audit",
                        "--device", "cpu", "--json", str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("audit: ")]
    assert len(lines) == 4 and all(ln.startswith("audit: [ok] ") for ln in lines), p.stdout
    assert any(".step." in ln and "in_place=9/9" in ln for ln in lines)
    data = json.loads(out.read_text())
    assert data["ok"] is True and data["audit"]["ok"] is True
    assert len(data["audit"]["entries"]) == 4


@pytest.mark.parametrize("argv", [["--audit"], ["--audit", "--device", "cuda"]],
                         ids=["default", "cuda"])
def test_the_audit_runs_on_the_card_unless_asked(argv, monkeypatch):
    """Like every entry point of the port, the audit raises without a card
    unless the CPU is asked for; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audit.run_audit()


def test_cli_fails_on_a_planted_entry(tmp_path, monkeypatch, capsys):
    tiny = audit._tiny_programs

    def planted(device):
        x = torch.arange(64, dtype=torch.int32).reshape(8, 8)
        return tiny(device) + [(_program(lambda: (x.sum(1),)), None, None)]

    monkeypatch.setattr(audit, "_tiny_programs", planted)
    out = tmp_path / "report.json"
    assert main(["--audit", "--device", "cpu", "--json", str(out)]) == 1
    data = json.loads(out.read_text())
    assert data["ok"] is False and not data["audit"]["entries"][-1]["ok"]
    captured = capsys.readouterr()
    assert "audit: [FAIL] planted" in captured.out and "64-bit widening" in captured.err
