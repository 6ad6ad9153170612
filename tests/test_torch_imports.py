"""Import and dispatch rules of the PyTorch/CUDA port.

* No module of ``src/repro_torch/`` and nothing in ``chip_smoke.py``
  imports JAX or anything of the JAX package ``repro`` (the port keeps its
  own copies of the numpy-only modules it needs).
* Importing the port builds nothing and needs no CUDA toolkit.
* Entry points run on the card by default: without a card and without
  ``device=``, they raise instead of falling back to the CPU, and nothing
  built on them (engine, session, fleet) detours to the CPU either.
* Kernel wrappers, the engine and the session take CPU tensors to their
  plain versions and refuse tensors on any other non-CUDA device.

These checks are structural; no numerical tolerance is involved.
"""

import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert, device
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.kernels import build
from repro_torch.kernels.dense_hdc.ops import dense_encoder
from repro_torch.kernels.hdc_am.ops import am_search
from repro_torch.kernels.hdc_encoder.ops import encoder
from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
from repro_torch.kernels.lbp.ops import lbp_codes

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_import_scan_covers_every_package():
    """The scan above reads every package of the port, ``ckpt`` included."""
    packages = {p.parent.name for p in PORT_FILES}
    assert {"core", "kernels", "serve", "ckpt", "data", "reliability", "runtime",
            "analysis", "launch", "models", "configs", "optim"} <= packages
    assert ROOT / "src" / "repro_torch" / "ckpt" / "checkpoint.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "serve" / "lifecycle.py" in PORT_FILES
    for name in ("ecc", "faults", "sweep", "channels"):
        assert ROOT / "src" / "repro_torch" / "reliability" / f"{name}.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "core" / "hwmodel.py" in PORT_FILES
    for rel in ("runtime/aot.py", "runtime/graphs.py", "analysis/guards.py",
                "launch/serve.py", "runtime/steps.py", "data/lm.py",
                "configs/registry.py", "configs/hdc_ieeg.py", "optim/adamw.py",
                "optim/compress.py", "data/pipeline.py", "launch/train.py",
                "analysis/lint.py", "analysis/__main__.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_reference(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_every_port_module_imports_without_building():
    """Importing every module of the package starts no build (the CPU has
    no nvcc) and loads no kernel library."""
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert {"repro_torch.serve.fleet", "repro_torch.serve.engine",
            "repro_torch.serve.lifecycle", "repro_torch.ckpt.checkpoint",
            "repro_torch.convert", "repro_torch.core.hwmodel",
            "repro_torch.reliability", "repro_torch.reliability.ecc",
            "repro_torch.reliability.faults", "repro_torch.reliability.sweep",
            "repro_torch.reliability.channels", "repro_torch.runtime.aot",
            "repro_torch.runtime.graphs", "repro_torch.analysis.guards",
            "repro_torch.launch.serve", "repro_torch.runtime.steps",
            "repro_torch.data.lm", "repro_torch.configs.registry",
            "repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.analysis.lint", "repro_torch.analysis.__main__"} | {
                f"repro_torch.models.{m}" for m in (
                    "config", "params", "layers", "attention", "moe", "model",
                    "serve")} <= set(names)
    for name in names:
        importlib.import_module(name)
    assert build._lib is None


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    """Without a card, ``device=None`` raises; ``device="cpu"`` is the only
    way onto the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HDCConfig(dim=256, channels=4, window=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HDCPipeline.init(torch.Generator().manual_seed(0), cfg)
    from repro_torch.serve.fleet import DEFAULT_TILE, derive_tile
    with pytest.raises(RuntimeError, match="no CUDA device"):
        derive_tile(cfg)
    assert derive_tile(cfg, device="cpu") == DEFAULT_TILE
    fields = {"dim": 256, "channels": 4, "window": 32}
    item = np.zeros((4, 64, 8), np.uint8)
    elec = np.zeros((4, 8), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.pipeline_from_arrays(fields, item, elec)
    pipe = HDCPipeline.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert pipe.device == torch.device("cpu")
    assert convert.pipeline_from_arrays(fields, item, elec,
                                        device="cpu").device.type == "cpu"


def test_wrappers_dispatch_on_tensor_device_only():
    """CPU tensors take the plain version without counting a launch;
    tensors on another device are refused, never moved."""
    before = (lbp_codes.launches, encoder.launches, am_search.launches,
              fleet_counts_kernel.launches, dense_encoder.launches)
    x = torch.zeros(1, 10, 3)
    assert lbp_codes(x).shape == (1, 4, 3)
    q = torch.zeros(2, 8, dtype=torch.int32)
    assert am_search(q, q, mode="overlap", dim=256).shape == (2, 2)
    codes = torch.zeros(3, 32, 4, dtype=torch.uint8)
    table = torch.zeros(4, 64, 8, dtype=torch.int32)
    assert dense_encoder(codes, table, table[:, 0], window=32,
                         dim=256).shape == (3, 8)
    item_pos = torch.zeros(4, 64, 8, dtype=torch.uint8)
    assert encoder(codes, item_pos, item_pos[:, 0], window=32, segments=8,
                   seg_len=32, temporal_threshold=1).shape == (3, 8)
    assert (lbp_codes.launches, encoder.launches, am_search.launches,
            fleet_counts_kernel.launches, dense_encoder.launches) == before
    with pytest.raises(ValueError, match="unsupported devices"):
        lbp_codes(x.to("meta"))
    with pytest.raises(ValueError, match="unsupported devices"):
        am_search(q, q.to("meta"), mode="overlap", dim=256)
    with pytest.raises(ValueError, match="unsupported devices"):
        encoder(codes.to("meta"), item_pos, item_pos[:, 0], window=32,
                segments=8, seg_len=32, temporal_threshold=1)
    with pytest.raises(ValueError, match="unsupported devices"):
        dense_encoder(codes.to("meta"), table, table[:, 0], window=32, dim=256)


def test_fused_wrappers_dispatch_on_tensor_device_only():
    """The encoders with their AM epilogue (``encode_score_fused``): CPU
    tensors take the plain versions without counting a launch; tensors on
    another device are refused, never moved."""
    from repro_torch.core.im import DenseIMParams, IMParams
    from repro_torch.kernels.dense_hdc import ops as dense_ops
    from repro_torch.kernels.hdc_encoder import ops as enc_ops

    codes = torch.zeros(2, 70, 4, dtype=torch.uint8)
    cls = torch.zeros(3, 8, dtype=torch.int32)
    sparse = (enc_ops, IMParams(torch.zeros(4, 64, 8, dtype=torch.uint8),
                                torch.zeros(4, 8, dtype=torch.uint8), 256, 8),
              HDCConfig(dim=256, channels=4, window=32))
    dense = (dense_ops, DenseIMParams(torch.zeros(4, 64, 8, dtype=torch.int32),
                                      torch.zeros(4, 8, dtype=torch.int32), 256),
             HDCConfig(dim=256, channels=4, window=32, variant="dense"))
    for ops, params, cfg in (sparse, dense):
        before = (ops.encode_score_fused.launches, encoder.launches, dense_encoder.launches)
        scores, preds = ops.encode_score_fused(params, codes, cfg, cls)
        assert scores.shape == (2, 2, 3) and preds.shape == (2, 2)
        assert not preds.any()       # all-zero frames and classes tie at class 0
        assert (ops.encode_score_fused.launches, encoder.launches,
                dense_encoder.launches) == before
        with pytest.raises(ValueError, match="unsupported devices"):
            ops.encode_score_fused(params, codes.to("meta"), cfg, cls)
        with pytest.raises(ValueError, match="unsupported devices"):
            ops.encode_score_fused(params, codes, cfg, cls.to("meta"))


def _small_bank(device="cpu"):
    cfg = HDCConfig(dim=256, channels=4, window=32, temporal_threshold=3)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 64, (1, 4 * 32, 4), np.uint8)
    labels = np.asarray([[0, 1, 0, 1]])
    pipe = HDCPipeline.init(torch.Generator().manual_seed(0), cfg, device=device)
    return {"p": pipe.train_one_shot(codes, labels)}


@pytest.mark.parametrize("kind", ["engine", "session", "fleet", "elastic", "faulted"])
def test_serving_objects_without_a_card_raise(monkeypatch, kind):
    """Without a card, a bank built with ``device=None`` raises at its
    pipelines, so no engine, session or fleet (faulted or not) is built on
    the CPU behind the caller's back; they have no device argument of their
    own and run where their pipelines lie, and a faulted fleet draws its
    masks there."""
    from repro_torch.reliability.faults import FaultConfig
    from repro_torch.serve.engine import SeizureSession, ServingEngine
    from repro_torch.serve.fleet import StreamingFleet
    from repro_torch.serve.lifecycle import ElasticFleet

    build_obj = {"engine": lambda bank: ServingEngine(bank),
                 "session": lambda bank: SeizureSession(bank["p"]),
                 "fleet": lambda bank: StreamingFleet(bank, ["p"]),
                 "elastic": lambda bank: ElasticFleet(bank),
                 "faulted": lambda bank: StreamingFleet(
                     bank, ["p"], faults=FaultConfig(tables=0.1, am=0.1, counts=0.1,
                                                     ecc="secded"))}[kind]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_obj(_small_bank(device=None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fields = {"dim": 256, "channels": 4, "window": 32}
        build_obj({"p": convert.pipeline_from_arrays(
            fields, np.zeros((4, 64, 8), np.uint8), np.zeros((4, 8), np.uint8),
            class_hvs=np.zeros((2, 8), np.uint32))})
    obj = build_obj(_small_bank())
    assert obj.device.type == "cpu" if kind != "session" else obj.class_hvs.is_cpu


def test_engine_and_session_dispatch_on_tensor_device_only():
    """On CPU tensors the engine and the session reach the kernels' plain
    versions and count no launch; on another device they are refused,
    never moved."""
    from repro_torch.serve.engine import SeizureSession, ServingEngine

    bank = _small_bank()
    codes = np.zeros((2 * 32, 4), np.uint8)
    before = (am_search.launches, fleet_counts_kernel.launches, encoder.launches)
    (dec,) = ServingEngine(bank).serve([("p", codes)])
    assert dec.scores.shape == (2, 2)
    assert len(SeizureSession(bank["p"]).push(codes)) == 2
    assert (am_search.launches, fleet_counts_kernel.launches, encoder.launches) == before
    meta = {"p": bank["p"].to("meta")}
    with pytest.raises(ValueError, match="unsupported devices"):
        ServingEngine(meta).serve([("p", codes)])
    with pytest.raises(ValueError, match="unsupported devices"):
        SeizureSession(meta["p"]).push(codes)


def test_sweep_without_a_card_raises(monkeypatch):
    """The sweep's entry points run on the card by default: without one,
    they raise; ``device="cpu"`` is the only way onto the plain path.  A
    faulted CPU fleet's draws lie on the CPU."""
    from repro_torch.reliability import faults, sweep
    from repro_torch.serve.fleet import StreamingFleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HDCConfig(dim=256, channels=4, window=32)
    sessions = {"train": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.train_pipelines("sparse_opt", 0.25, sessions, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sweep(base_cfg=cfg, n_patients=1, n_test=1,
                        record_kw=dict(pre_s=0.2, ictal_s=0.2, post_s=0.1))
    fleet = StreamingFleet(_small_bank(), ["p"], faults=faults.FaultConfig(
        tables=0.1, am=0.1, counts=0.1, ecc="secded", mode="stuck"))
    draw = fleet._step_draw(0, 0)
    for d in (draw.tables, draw.am, draw.am_check, draw.counts):
        assert d.sel.device.type == "cpu" and d.val.device.type == "cpu"
