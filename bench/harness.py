"""The benchmark's harness: one cell, one run.

Everything particular to a cell is found by name from ``BENCHMARK.json``:
the configuration's file (``configs``), the traffic's data file
``bench/traffic/<traffic>.json``, whose ``loop`` names the request loop in
``bench/loops/<loop>.py``, and one reader per per-layer metric in
``bench/metrics/<metric>.py``.  A new cell, mix or metric is new files and
new entries; no file here changes.

A run: set-up (its parts timed and printed), then the window of
``seconds`` (traced by ``torch.profiler`` with ``trace``), then the
window's peak memory, the program's state freed, and the comparison with
the plain reference.  The result is one JSON object, returned to ``run.py``, which
checks that nothing of JAX or the JAX package was loaded and prints it.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from bench import trace_summary as trace_mod
from bench.util import Spans, sync

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    hdc_config: object = None
    metrics: dict = field(default_factory=dict)   # per-layer metric entries


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def context(workload: str, seed: int, device,
            traffic_overrides: dict | None = None) -> Context:
    """The cell ``workload``: its configuration, traffic and metrics."""
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    traffic.update(traffic_overrides or {})
    metrics = {m["name"]: m for m in bench["per_layer"]
               if workload in m.get("workloads", [workload])}
    from repro_torch.core.classifier import HDCConfig

    return Context(cell, cfg, traffic, seed, torch.device(device),
                   HDCConfig(**cfg["hdc"]), metrics)


def loop_for(ctx: Context):
    name = ctx.traffic["loop"]
    return importlib.import_module(f"bench.loops.{name}").Loop(ctx)


def reader(name: str):
    """The ``read(run)`` function of per-layer metric ``name``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class RunData:
    """What a per-layer reader reads: the loop's records and spans, and the
    trace's summary (None untraced)."""
    data: dict
    summary: object = None

    @property
    def kind(self) -> str:
        return self.data["kind"]


class SetupClock:
    """Set-up's parts, each timed and printed as it ends."""

    def __init__(self):
        self.parts: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        yield
        self.parts[name] = time.perf_counter() - t
        print(f"setup: {name} {self.parts[name]:.3f} s", flush=True)


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it: the peaks behind
    every roofline share assume 700 W."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def _summarize(prof) -> object:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.summarize_file(path)
    finally:
        os.unlink(path)


def run(workload: str, seed: int, seconds: float, traced: bool, *, device,
        t0: float | None = None, traffic_overrides: dict | None = None,
        setup_parts: dict | None = None) -> dict:
    """Run one cell once; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with a trace
    ``breakdown``, and the compared numbers under ``checks``)."""
    t0 = time.perf_counter() if t0 is None else t0
    clock = SetupClock()
    clock.parts.update(setup_parts or {})
    ctx = context(workload, seed, device, traffic_overrides=traffic_overrides)
    loop = loop_for(ctx)
    loop.setup(clock)
    sync(ctx.device)
    setup_s = time.perf_counter() - t0
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    spans = Spans(traced)
    prof = _profiler() if traced else contextlib.nullcontext()
    with prof:
        res = loop.window(seconds, spans)
        sync(ctx.device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loop.finish()
    summary = _summarize(prof) if traced else None

    got = loop.program_outputs()
    want = loop.reference()
    checks = loop.compare(got, want)
    correct = (res["attempted"] > 0 and res["failed"] == 0
               and all(v <= lim for v, lim in checks.values()))

    if traced:
        data = RunData(res["data"], summary)
        metrics = {}
        for name, m in ctx.metrics.items():
            value = reader(name)(data)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        metrics = dict(res["metrics"])
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": device_info}
    if traced:
        if dev.type == "cuda":
            device_info["power_limit"] = power_limit()
        if summary is not None:
            device_info["busy_s"] = summary.busy_s
            device_info["window_s"] = summary.window_s
            result["breakdown"] = summary.breakdown()
    result["setup_parts_s"] = dict(clock.parts)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result

