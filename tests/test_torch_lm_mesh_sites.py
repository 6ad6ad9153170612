"""The LM's placement sites, counted: each of the reference's 37
``constrain(`` sites in ``src/repro/models/{model,attention,mamba,serve,
moe}.py`` (8/7/2/14/6) has its counterpart in the port's file of the same
name, and every redistribution the reference does not have (the port's
``shd.reshard(`` calls in ``src/repro_torch/models/``, each with its
reason) is listed in ``ROADMAP.md`` beside item 10 (e), file by file.  And the selective scan on a 2-rank
mesh makes no collective (``CommDebugMode``), its blocks equal bit for bit
to the unsharded chunk's.
"""

import os
import re

import pytest

import mesh_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("model", "attention", "mamba", "serve", "moe")
SITES = {"model": 8, "attention": 7, "mamba": 2, "serve": 14, "moe": 6}


def _count(path: str, pattern: str) -> int:
    """Calls matching ``pattern`` outside comments."""
    with open(path) as f:
        return sum(len(re.findall(pattern, line)) for line in f
                   if not line.lstrip().startswith("#"))


@pytest.mark.parametrize("name", FILES)
def test_constrain_sites_match_reference(name):
    ref = _count(os.path.join(ROOT, "src", "repro", "models", f"{name}.py"), r"\bconstrain\(")
    port = _count(os.path.join(ROOT, "src", "repro_torch", "models", f"{name}.py"),
                  r"(?<![.\w])constrain\(")
    assert ref == SITES[name]
    assert port == ref, (name, port, ref)


def test_extra_redistributions_are_listed():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        listed: dict = {}
        for m in re.finditer(r"reshard `models/(\w+)\.py` x (\d+)", f.read()):
            listed[m.group(1)] = listed.get(m.group(1), 0) + int(m.group(2))
    models = os.path.join(ROOT, "src", "repro_torch", "models")
    found = {f[:-3]: _count(os.path.join(models, f), r"\bshd\.reshard\(")
             for f in sorted(os.listdir(models)) if f.endswith(".py")}
    assert {k: v for k, v in found.items() if v} == listed


def test_scan_makes_no_collective(tmp_path):
    mesh_worker.spawn("scan", {"mesh": [2, 2], "axes": ["data", "model"]}, str(tmp_path))
