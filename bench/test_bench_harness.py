"""The harness finds every piece by name, BENCHMARK.json keeps to its
contract, the generator follows the seed, the frozen counts give the
kernel table's bounds, and nothing the harness loads is JAX's."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness, ieeg_gen, roofline
from bench.conftest import SEED

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    ctx = harness.context(cell, SEED, "cpu")
    loop = harness.loop_for(ctx)
    assert loop.kind == ctx.traffic["loop"]
    assert ctx.cfg["name"] == ctx.cell["config"]
    assert ctx.hdc_config.variant == ctx.cfg["hdc"]["variant"]
    # every per-layer metric of the cell moves an end-to-end metric the cell reports
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in ctx.metrics.values():
        assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_generator_follows_the_seed():
    pat = ieeg_gen.patient(SEED, 0, 8)
    sz = ieeg_gen.place_seizures(SEED, ("t",), 4096, 2, (1.0, 2.0))
    a = ieeg_gen.recording(SEED, ("t",), pat, 4096, 8, sz, "cpu")
    b = ieeg_gen.recording(SEED, ("t",), pat, 4096, 8, sz, "cpu")
    c = ieeg_gen.recording(SEED + 1, ("t",), pat, 4096, 8, sz, "cpu")
    assert a.dtype == torch.float32 and a.shape == (4096, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert sz == ieeg_gen.place_seizures(SEED, ("t",), 4096, 2, (1.0, 2.0))
    assert sz != ieeg_gen.place_seizures(SEED + 1, ("t",), 4096, 2, (1.0, 2.0))


def test_background_is_the_ar2_recursion():
    g = ieeg_gen.generator(SEED, "cpu", "ar2")
    t, c = 600, 3
    x = ieeg_gen.background(g, t, c, "cpu").double()
    g = ieeg_gen.generator(SEED, "cpu", "ar2")
    e = torch.randn((t + ieeg_gen.TAPS - 1, c), generator=g).double()
    y = torch.zeros_like(e)
    a1, a2 = ieeg_gen.A1, ieeg_gen.A2
    for i in range(e.shape[0]):
        y[i] = e[i] + (a1 * y[i - 1] if i else 0) + (a2 * y[i - 2] if i > 1 else 0)
    # the filter starts from rest TAPS - 1 samples early: equal to the
    # recursion's float32 rounding once those samples have passed
    assert torch.allclose(x, y[ieeg_gen.TAPS - 1:], atol=1e-5)


def test_frame_labels_need_half_a_frame():
    lab = ieeg_gen.frame_labels([(100, 200)], 1024, 256)
    assert lab.tolist() == [1, 0, 0, 0]          # 156 of 256 ictal, then 44
    assert ieeg_gen.frame_labels([(128, 128)], 512, 256).tolist() == [1, 0]


def test_roofline_gives_the_kernel_tables_bounds():
    # lbp at (4, 40960, 64): 52.4 MB; encoder over 477 frames: 7.91 MB;
    # dense over 477 frames: 254 M word operations
    assert roofline.lbp_work(4, 40960, 64, 6)[0] == 52_427_264
    assert roofline.encoder_work(477, 256, 64, 64, 8, 128)[0] == 7_909_504
    assert roofline.dense_work(477, 256, 64, 64, 32)[1] == 253_992_960
    b, o = roofline.lbp_work(4, 40960, 64, 6)
    assert roofline.bound_s(b, o) == pytest.approx(0.0156e-3, rel=0.01)
    hdc = json.loads((ROOT / "bench/configs/sparse_compim.json").read_text())["hdc"]
    # an hour of signal is 471.9 MB, 0.141 ms at 3.35 TB/s; its 2.42 G
    # operations at the 16.75 T/s integer rate take a little longer
    t = 512 * 3600
    n_bytes, n_ops = roofline.review_work(hdc, t)
    assert n_bytes == pytest.approx(471.9e6, rel=1e-3)
    assert n_bytes / roofline.HBM_BW == pytest.approx(0.141e-3, rel=0.01)
    assert roofline.PEAK_INT_OPS == 16.75e12
    assert roofline.bound_s(n_bytes, n_ops) == pytest.approx(0.1444e-3, rel=0.01)
    # the dense launch over 477 frames is bound by its operations
    b, o = roofline.dense_work(477, 256, 64, 64, 32)
    assert roofline.bound_s(b, o) == pytest.approx(0.0152e-3, rel=0.01)


def test_the_harness_loads_nothing_of_jax():
    code = (
        "import sys, runpy;"
        "import bench.harness, bench.control, bench.loops.review, bench.loops.onboard;"
        "import bench.reference.hdc, repro_torch.core.pipeline, repro_torch.kernels.lbp.ops;"
        "from bench import harness;"
        "[harness.reader(m['name']) for m in harness.load_benchmark()['per_layer']];"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'});"
        "print(bad); sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", "compim.review",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout.strip().endswith("}")
