"""The port's lint rules (``repro_torch.analysis``): each rule flags a
case planted in a temporary package and leaves its clean twin alone, a
waiver comment is honoured and reported as waived with its reason, the
CLI's exit codes and report, and ``src/repro_torch/`` itself lints with no
unwaived finding, every waiver giving its reason.

These checks are structural; no numerical tolerance is involved.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.__main__ import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

CAPTURED = '''
import numpy as np
import torch

from repro_torch.runtime import graphs
from repro_torch.serve import helpers


def _step(state, n):
    m = helpers.norm(state)
    k = float(n)                                   # RPR002: operand read on the host
    return state * m + k


def _not_captured(state):
    return state.sum().item()                      # never reached from a capture


class Fleet:
    def _adapt(self, state):
        return self._rows(state)

    def _rows(self, state):
        return np.asarray(state)                   # RPR002 through self.


    def warm(self):
        def run(state):
            return _step(state, 3)

        def body():
            out = run(self.state)
            torch.cuda.synchronize()               # RPR002 in the body itself
            return (out,)

        graphs.capture("step", body, warm=body, pool=None)
        graphs.capture("adapt", lambda: (self._adapt(self.state),), warm=None, pool=None)
'''

HELPERS = '''
def norm(state):
    return state.abs().max().cpu()                 # RPR002, reached across modules


def unused(state):
    return state.tolist()
'''

RNG = '''
import random

import numpy as np
import torch


def draws(x, seed):
    a = np.random.rand(3)                          # RPR003 legacy global state
    b = np.random.default_rng()                    # RPR003 seedless
    c = np.random.default_rng(seed)
    d = random.random()                            # RPR003 stdlib
    torch.manual_seed(0)                           # RPR003 global torch stream
    e = torch.randn(3)                             # RPR003 no generator=
    g = torch.Generator()                          # RPR003 never seeded
    h = torch.Generator().manual_seed(seed)
    f = torch.randn(3, generator=h)
    x.normal_()                                    # RPR003 no generator=
    x.normal_(generator=h)
    k = torch.Generator(device="cpu")
    k.manual_seed(seed)
    return a, b, c, d, e, f, g, k
'''


def _plant(tmp_path, files: dict) -> str:
    pkg = tmp_path / "src" / "repro_torch"
    for rel, body in files.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(body))
    return str(pkg)


def _hits(findings, code: str) -> dict:
    return {(os.path.basename(f.path), f.line): f for f in findings if f.code == code}


def _line(src: str, needle: str) -> int:
    return next(i for i, ln in enumerate(textwrap.dedent(src).splitlines(), 1) if needle in ln)


def test_rpr002_follows_captured_bodies(tmp_path):
    """Host syncs in the bodies ``graphs.capture`` takes, in what they
    call (closures, ``self.`` methods, other modules), and nowhere else."""
    root = _plant(tmp_path, {"serve/fleet.py": CAPTURED, "serve/helpers.py": HELPERS})
    hits = _hits(lint.lint_paths([root]), "RPR002")
    want = {("fleet.py", _line(CAPTURED, "float(n)")),
            ("fleet.py", _line(CAPTURED, "np.asarray(state)")),
            ("fleet.py", _line(CAPTURED, "synchronize")),
            ("helpers.py", _line(HELPERS, ".cpu()"))}
    assert set(hits) == want
    assert not any(f.waived for f in hits.values())


def test_rpr003_flags_each_nondeterministic_source(tmp_path):
    root = _plant(tmp_path, {"core/rng.py": RNG})
    hits = _hits(lint.lint_paths([root]), "RPR003")
    want = {("rng.py", i) for i, ln in enumerate(textwrap.dedent(RNG).splitlines(), 1)
            if "# RPR003" in ln}
    assert set(hits) == want and len(want) == 7


def test_rpr003_only_in_library_code(tmp_path):
    """Outside ``src/repro_torch`` (a script, a test) the rule is silent."""
    path = tmp_path / "script.py"
    path.write_text(textwrap.dedent(RNG))
    assert not lint.lint_paths([str(path)])


def test_waiver_is_honoured_and_reported_with_its_reason(tmp_path):
    src = textwrap.dedent(RNG).replace(
        "a = np.random.rand(3)                          # RPR003 legacy global state",
        "a = np.random.rand(3)  # repro-lint: disable=RPR003  -- a demo of the waiver")
    src = src.replace("    d = random.random()",
                      "    # repro-lint: disable=RPR003,RPR002 -- the line below\n"
                      "    d = random.random()")
    root = _plant(tmp_path, {"core/rng.py": src})
    findings = [f for f in lint.lint_paths([root]) if f.code == "RPR003"]
    waived = {f.line: f.reason for f in findings if f.waived}
    assert len(findings) == 7 and len(waived) == 2
    assert sorted(waived.values()) == ["a demo of the waiver", "the line below"]
    assert "waived: a demo of the waiver" in str(next(f for f in findings if f.waived))


def test_cli_exit_codes_and_report(tmp_path, capsys):
    dirty = _plant(tmp_path / "dirty", {"core/rng.py": RNG})
    clean = _plant(tmp_path / "clean", {"core/ok.py": "import numpy as np\n\n\n"
                                        "def f(s):\n    return np.random.default_rng(s)\n"})
    report = tmp_path / "lint.json"
    assert main([dirty, "--json", str(report)]) == 1
    data = json.loads(report.read_text())
    assert data["ok"] is False and data["lint"]["unwaived"] == 7
    assert main([clean]) == 0
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in ("RPR002", "RPR003"):
        assert code in out
    for code in ("RPR001", "RPR004", "RPR005"):
        assert f"{code}  (no counterpart)" in out


def test_cli_module_entry_point(tmp_path):
    """``python -m repro_torch.analysis`` lints the package by default."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stderr
    assert "lint: 0 unwaived finding(s)" in r.stdout


def test_port_lints_clean_with_reasoned_waivers():
    findings = lint.lint_paths([PORT])
    assert [str(f) for f in findings if not f.waived] == []
    assert all(f.reason for f in findings if f.waived), [str(f) for f in findings]


@pytest.mark.parametrize("root,callee", [("serve/fleet.py", "_fleet_step"),
                                         ("serve/fleet.py", "_fleet_adapt"),
                                         ("serve/engine.py", "_serve_dispatch")])
def test_port_capture_roots_reach_the_serving_steps(root, callee):
    """The port's captured bodies are found, and reach the three step
    functions the CUDA graphs hold."""
    modules = {}
    for f in lint.iter_py_files([PORT]):
        with open(f) as fh:
            modules[f] = lint._parse_module(f, fh.read())
    reached = lint._captured_fixpoint(modules)
    assert (os.path.join(PORT, root), callee) in reached
