"""The comparison's control and its planted faults, read at a cell's size.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed the cell's inputs are made as a run makes them (signal,
labels, codebooks), and the numbers that decide ``correct`` are read for:

* ``control``: the plain reference put in the program's place, its signal
  in bfloat16, the precision below the float32 the configurations state;
* the faults a cell can have, planted in the reference put in the
  program's place: ``half`` (half of the frames left out), ``altered``
  (one answer changed where it is produced), and for onboarding ``frozen``
  (the retraining epochs return the state unchanged).

It prints one JSON line a seed and reading.  The benchmark's runs do not
run it; ``bench/test_bench_control.py`` runs it at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import harness  # noqa: E402
from bench.reference import hdc as ref  # noqa: E402


def _review_faults(loop, want: dict) -> dict:
    got = loop.as_outputs(want)
    half = {rec: [(s[: s.shape[0] // 2], p[: p.shape[0] // 2]) for s, p in outs]
            for rec, outs in got["outputs"].items()}
    altered = {}
    for rec, outs in got["outputs"].items():
        s, p = outs[0]
        s, p = s.copy(), p.copy()
        p[0] = 1 - p[0]
        altered[rec] = [(s, p)]
    return {"half": dict(got, outputs=half), "altered": dict(got, outputs=altered)}


def _onboard_half(loop, job: int) -> dict:
    cfg, hdc = loop.cfg, loop.hdc
    x, lab = (v.to(loop.dev) for v in loop.records[job % len(loop.records)])
    book = loop._book(job)
    counts = ref.sparse_counts(ref.lbp(x, hdc["lbp_bits"]), book["item"], book["elec"], hdc)
    thr = ref.calib_threshold(counts, cfg["calibrate_target"])
    half = counts.shape[0] // 2
    cbits, c, n = ref.fit(counts[:half] >= thr, lab[:half], hdc, loop.traffic["epochs"])
    return {"threshold": thr, "class_hvs": ref.pack(cbits).cpu(), "counts": c.cpu(),
            "n": n.cpu()}


def readings(workload: str, seed: int, device, traffic_overrides: dict | None = None,
             jobs: int = 100) -> dict:
    """{reading: {number: value}} for the control and each fault at the
    cell's size (or the overrides'); ``jobs``: how many jobs the onboarding
    sample is drawn from, about as many as a run finishes."""
    ctx = harness.context(workload, seed, device, traffic_overrides=traffic_overrides)
    loop = harness.loop_for(ctx)
    out = {}
    if loop.kind == "review":
        loop._plan()
        loop._inputs()
        want = loop.reference()
        control = loop.as_outputs(loop.reference(torch.bfloat16))
        out["control"] = loop.compare(control, want)
        for name, got in _review_faults(loop, want).items():
            out[name] = loop.compare(got, want)
    else:
        loop._inputs()
        loop.banks = dict.fromkeys(range(jobs))
        want = loop.reference()
        out["control"] = loop.compare(loop.reference(torch.bfloat16), want)
        out["frozen"] = loop.compare(loop.reference(epochs=0), want)
        out["half"] = loop.compare({j: _onboard_half(loop, j) for j in want}, want)
        altered = {j: dict(w, threshold=w["threshold"] + 1) for j, w in want.items()}
        out["altered"] = loop.compare(altered, want)
    return {k: {n: v for n, (v, _) in checks.items()} for k, checks in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench: no CUDA device is available")
    for seed in args.seeds:
        for name, nums in readings(args.workload, seed, "cuda:0").items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              **nums}), flush=True)


if __name__ == "__main__":
    main()
