"""The program's spans (``repro_torch.runtime.spans``): under a
``torch.profiler`` profile the onboarding and review entry points open
exactly their named ranges, nested as the layers are; with no profile
running no range is entered; the outputs are the same bit for bit either
way; and no captured body reaches a span.

These checks are structural; no numerical tolerance is involved.
"""

import ast
import os

import pytest
import torch

from repro_torch.analysis import lint
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.kernels.lbp.ops import lbp_codes
from repro_torch.runtime import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

CFG = dict(dim=256, segments=8, channels=8, window=32)
FRAMES = 12


def _inputs():
    g = torch.Generator().manual_seed(29)
    x = torch.randn((1, FRAMES * CFG["window"] + 6, CFG["channels"]), generator=g)
    labels = torch.tensor([[0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0]])
    return x, labels


def _job(variant="sparse_compim"):
    """Onboarding then review on one recording: every span site once."""
    cfg = HDCConfig(variant=variant, **CFG)
    pipe = HDCPipeline.init(torch.Generator().manual_seed(7), cfg, device="cpu")
    x, labels = _inputs()
    codes = lbp_codes(x, bits=cfg.lbp_bits)
    pipe = pipe.calibrate_density(codes, target=0.25)
    pipe = pipe.fit_iterative(codes, labels, epochs=3)
    scores, preds = pipe.infer(lbp_codes(x, bits=cfg.lbp_bits))
    return (codes, torch.tensor(pipe.cfg.temporal_threshold), pipe.class_hvs,
            pipe.am_state.counts, pipe.am_state.n, scores, preds)


def _ranges(variant="sparse_compim"):
    """The job's outputs, and its ``repro_torch.*`` ranges as (start, end,
    name), sorted by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _job(variant)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.name().startswith("repro_torch."))
    return out, ranges


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_the_entry_points_open_exactly_their_ranges():
    _, ranges = _ranges()
    names = [r[2] for r in ranges]
    assert names == ["repro_torch.lbp", "repro_torch.calibrate",
                     "repro_torch.calibrate.counts", "repro_torch.calibrate.threshold",
                     "repro_torch.fit", "repro_torch.fit.labels", "repro_torch.fit.encode",
                     "repro_torch.fit.epoch", "repro_torch.fit.epoch",
                     "repro_torch.fit.epoch", "repro_torch.lbp", "repro_torch.infer"]
    by = {}
    for r in ranges:
        by.setdefault(r[2], []).append(r)
    (calib,), (fit,) = by["repro_torch.calibrate"], by["repro_torch.fit"]
    for name in ("repro_torch.calibrate.counts", "repro_torch.calibrate.threshold"):
        assert _inside(by[name][0], calib)
    for name in ("repro_torch.fit.labels", "repro_torch.fit.encode", "repro_torch.fit.epoch"):
        assert all(_inside(r, fit) for r in by[name])
    # siblings follow one another; the top-level calls do not overlap
    kids = by["repro_torch.fit.labels"] + by["repro_torch.fit.encode"] + by["repro_torch.fit.epoch"]
    assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))
    tops = [r for r in ranges if r[2].count(".") == 1]
    assert all(a[1] <= b[0] for a, b in zip(tops, tops[1:]))


def test_dense_calibration_opens_no_span():
    _, ranges = _ranges("dense")
    names = [r[2] for r in ranges]
    assert not any(n.startswith("repro_torch.calibrate") for n in names)
    assert names.count("repro_torch.fit.epoch") == 3
    assert names.count("repro_torch.lbp") == 2 and names.count("repro_torch.infer") == 1


def test_no_range_is_entered_without_a_profile(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profile recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _job()
    _job("dense")
    assert spans.span("lbp") is spans.span("fit.epoch")   # one shared no-op


def test_outputs_are_bit_identical_with_and_without_the_profiler():
    plain = _job()
    traced, _ = _ranges()
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_span_is_a_profiler_range_only_while_a_profile_records():
    assert isinstance(spans.span("x"), type(spans._OFF))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = spans.span("x")
        assert not isinstance(on, type(spans._OFF))
    assert spans.span("x") is spans._OFF


def test_the_span_module_imports_only_contextlib_and_torch():
    with open(spans.__file__) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            imported.add(node.module)
    assert imported == {"contextlib", "torch"}


@pytest.mark.parametrize("site", ["runtime/spans.py:span", "kernels/lbp/ops.py:lbp_codes",
                                  "core/pipeline.py:HDCPipeline.infer",
                                  "core/pipeline.py:_fit_iterative",
                                  "core/classifier.py:with_density_target"])
def test_no_captured_body_reaches_a_span(site):
    modules = {}
    for f in lint.iter_py_files([PORT]):
        with open(f) as fh:
            modules[f] = lint._parse_module(f, fh.read())
    reached = lint._captured_fixpoint(modules)
    path, fn = site.split(":")
    assert fn in modules[os.path.join(PORT, path)].functions
    assert (os.path.join(PORT, path), fn) not in reached
