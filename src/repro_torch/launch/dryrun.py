"""Multi-pod dry-run: trace every (architecture x input shape x mesh) cell
as one rank of 256 or 512 fake ranks and read its roofline terms (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's analyses of the compiled, partitioned module.  The
port compiles nothing: one process joins the ``"fake"`` process group as
rank 0 of the production mesh (``launch/mesh.py::fake_world``) and runs
that rank's train step, prefill or decode step on fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory, no arithmetic; the fake
group's collectives return at once), under ``runtime/op_cost.py``'s
counter.  So ``lower_s`` is the trace's host time; there is no
``compile_s`` and no ``xla_cost_analysis``.  It needs no card and no
``nvcc``: the fake tensors sit on device ``cuda`` where this torch is
built for CUDA, and on ``cpu`` in a CPU-only build (whose CUDA device
guard cannot index a fake CUDA tensor).  On a CPU mesh DTensor turns a
shard-dim all-to-all into an all-gather and a chunk (gloo has no
all-to-all), so the CPU build counts that all-gather where the card's
build counts the all-to-all.  Nothing falls back: a cell the port cannot
trace is recorded as ``error``.

Per cell ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` holds:

  memory        bytes per device: arguments / outputs / temporaries / peak
  cost          per-device flops and bytes accessed
  collectives   per-kind local output bytes, ``n_ops``
  roofline      compute / memory / collective seconds on the card
                (``runtime/roofline.py``) and the dominant term
  site_flops, site_collectives   with ``--sites``: both by model line

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --hdc            # the paper's HDC system
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single \
      --sites --tag sites     # + flops and collectives by model line
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from contextlib import nullcontext
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCH_IDS, get_config, shape_applicable
from repro_torch.data import lm as lmdata
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import params as pmod
from repro_torch.models.config import param_count
from repro_torch.models.serve import cache_shardings
from repro_torch.optim import adamw
from repro_torch.runtime import op_cost, roofline
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as steps_mod

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

HDC_STREAMS, HDC_CYCLES = 8192, 2048     # 8192 concurrent streams, 8 frames each


def fake_device() -> torch.device:
    """Where the fake tensors sit: ``cuda:0`` in a CUDA build of torch (no
    card needed), ``cpu`` in a CPU-only one."""
    return torch.device("cuda", 0) if torch.backends.cuda.is_built() else torch.device("cpu")


def production_mesh(mesh_kind: str):
    """The fake world of the production mesh (256 or 512 ranks, restarted
    at the other size when one is running) and its mesh."""
    multi = mesh_kind == "multi"
    n = 512 if multi else 256
    if mesh_mod.is_fake_world() and dist.get_world_size() != n:
        dist.destroy_process_group()
    mesh_mod.fake_world(n)
    return mesh_mod.make_production_mesh(multi_pod=multi, device=fake_device())


def abstract_opt_state(spec, opt: adamw.OptConfig) -> dict:
    """AdamW state stand-ins on the ``meta`` device."""
    mv = pmod.abstract(spec, getattr(torch, opt.state_dtype))
    return {"m": mv, "v": mv, "step": torch.empty((), dtype=torch.int32, device="meta")}


def _materialize(tree: Any, device, real: bool, gen: torch.Generator | None) -> Any:
    """``meta`` stand-ins -> tensors on ``device``: empty (fake, under the
    caller's ``FakeTensorMode``) or, for a real run, small normals and
    zero integers drawn from ``gen``."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not real:
            return torch.empty(t.shape, dtype=t.dtype, device=device)
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype).to(device)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return pmod.tree_map(one, tree) if isinstance(tree, dict) else one(tree)


def _placed(tree: Any, shardings: Any) -> Any:
    return pmod.tree_map(shd.place, tree, shardings)


def cell_step(cfg, shape: lmdata.ShapeSpec, mesh, *, device, real: bool = False,
              opt: adamw.OptConfig | None = None, seq_sharded_kv: bool | None = None):
    """One rank's step of ``cfg`` at ``shape`` on ``mesh`` (None: one
    device) -> ``(step, args)``: the reference's ``jit_*`` step and its
    inputs, placed by the step's own shardings (the step's own placing is
    then a no-op).  Inputs come from ``data/lm.py::input_specs``: fake
    tensors (call under ``FakeTensorMode``) or, ``real``, drawn from seed
    0.  A decode step runs at ``pos = seq_len - 1`` (an int), with
    ``seq_sharded_kv`` (None: for a global batch under 16, long_500k)."""
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(0) if real else None
    specs = lmdata.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = opt or adamw.OptConfig()
        step, ctx, spec = steps_mod.jit_train_step(cfg, opt, mesh, specs)
        params = _materialize(pmod.abstract(spec, dtype), device, real, gen)
        state = _materialize(abstract_opt_state(spec, opt), device, real, gen)
        batch = _materialize(specs, device, real, gen)
        if mesh is not None:
            params = _placed(params, shd.tree_shardings(spec, ctx))
            state = _placed(state, steps_mod.opt_state_shardings(spec, ctx))
            batch = _placed(batch, steps_mod.batch_shardings(specs, ctx))
        return step, (params, state, batch)
    if shape.kind == "prefill":
        step, ctx, spec = steps_mod.jit_prefill(cfg, mesh, specs, cache_seq=shape.seq_len)
        params = _materialize(pmod.abstract(spec, dtype), device, real, gen)
        batch = _materialize(specs, device, real, gen)
        if mesh is not None:
            params = _placed(params, shd.tree_shardings(spec, ctx))
            batch = _placed(batch, steps_mod.batch_shardings(specs, ctx))
        return step, (params, batch)
    if seq_sharded_kv is None:
        seq_sharded_kv = shape.global_batch < 16
    step, ctx, spec = steps_mod.jit_decode_step(cfg, mesh, specs, seq_sharded_kv=seq_sharded_kv)
    params = _materialize(pmod.abstract(spec, dtype), device, real, gen)
    tokens = _materialize(specs["tokens"], device, real, gen)
    caches = _materialize(specs["caches"], device, real, gen)
    if mesh is not None:
        params = _placed(params, shd.tree_shardings(spec, ctx))
        tokens = shd.place(tokens, shd.sharding_for(("batch", None), ctx, tuple(tokens.shape)))
        caches = _placed(caches, cache_shardings(caches, ctx))
    return step, (params, tokens, caches, shape.seq_len - 1)


def trace_cell(cfg, shape: lmdata.ShapeSpec, mesh, *, device=None, real: bool = False,
               opt: adamw.OptConfig | None = None, seq_sharded_kv: bool | None = None,
               sites: bool = False) -> dict:
    """Run one rank's step of the cell under the op counter -> ``{"lower_s",
    "cost", "collectives", "memory", "kernels"}`` (per device).  Fake
    tensors unless ``real`` (then on ``device``, a real mesh's rank).
    ``sites``: also ``"site_flops"`` and ``"site_collectives"``, the flops
    and each collective kind's bytes by model line (the backward's under
    anomaly mode's tracebacks)."""
    device = torch.device(device or fake_device())
    with (nullcontext() if real else _fake_mode()):
        step, args = cell_step(cfg, shape, mesh, device=device, real=real, opt=opt,
                               seq_sharded_kv=seq_sharded_kv)
        anomaly = torch.autograd.set_detect_anomaly(True, check_nan=False) if sites \
            else nullcontext()
        t0 = time.perf_counter()
        with anomaly, op_cost.OpCounter(args, sites=sites) as counter:
            out = step(*args)
        lower_s = time.perf_counter() - t0
        res = counter.result(out)
    return {"lower_s": lower_s,
            "cost": {"flops": res["flops"], "bytes accessed": res["bytes"]},
            "collectives": res["collectives"], "memory": res["memory"],
            "kernels": res["kernels"], "site_flops": counter.site_flops,
            "site_collectives": counter.site_collectives}


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=False)


def lower_cell(arch_id: str, shape_name: str, mesh_kind: str,
               overrides: dict | None = None, sites: bool = False):
    """-> ``(cfg, shape, mesh, traced)`` of one production cell (the
    reference's ``lower_cell``, tracing where it lowers)."""
    cfg = get_config(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = lmdata.SHAPES[shape_name]
    mesh = production_mesh(mesh_kind)
    opt = adamw.OptConfig(state_dtype="bfloat16" if "398b" in arch_id else "float32")
    return cfg, shape, mesh, trace_cell(cfg, shape, mesh, opt=opt, sites=sites)


def _out_path(out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, name)


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, overrides: dict | None = None,
             tag: str = "", sites: bool = False) -> dict:
    suffix = f"__{tag}" if tag else ""
    out_path = _out_path(out_dir, f"{arch_id}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch_id)
    shape = lmdata.SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    record = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
              "kind": shape.kind, "tag": tag, "overrides": overrides or {}}
    if not ok:
        record |= {"status": "skipped", "reason": reason}
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
        return record

    try:
        cfg, shape, mesh, tr = lower_cell(arch_id, shape_name, mesh_kind, overrides, sites)
        mem = tr["memory"]
        print(f"[{arch_id} {shape_name} {mesh_kind}] memory:", mem)
        cost, colls = tr["cost"], tr["collectives"]
        print(f"[{arch_id} {shape_name} {mesh_kind}] op_cost: "
              f"flops={cost['flops']:.3e} bytes={cost['bytes accessed']:.3e} "
              f"colls={ {k: f'{v:.2e}' for k, v in colls.items()} }")
        n_total, n_active = param_count(cfg)
        terms = roofline.roofline_terms(cost, colls, cfg, shape, mesh,
                                        n_total=n_total, n_active=n_active)
        record |= {"status": "ok", "lower_s": round(tr["lower_s"], 1), "memory": mem,
                   "cost": cost, "collectives": colls, "roofline": terms,
                   "params_total": n_total, "params_active": n_active,
                   "fake_device": fake_device().type, "card": roofline.CARD}
        if sites:
            record |= {"site_flops": tr["site_flops"],
                       "site_collectives": tr["site_collectives"]}
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record |= {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        print(f"[{arch_id} {shape_name} {mesh_kind}] FAILED: {record['error']}")
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def trace_hdc(mesh, *, batch: int = HDC_STREAMS, t: int = HDC_CYCLES, device=None) -> dict:
    """The paper's sparse-HDC inference as a serving cell: ``batch``
    streams of ``t`` cycles sharded over the batch's mesh axes (pod, data),
    the CompIM table and the class rows replicated; each rank runs
    ``encode_score_fused`` (the card's route: the encoder kernel with its
    AM epilogue, one launch) on its block of streams, on fake tensors (the
    kernel's wrapper records the launch, launching nothing)."""
    from repro_torch.core.classifier import HDCConfig
    from repro_torch.core.im import IMParams
    from repro_torch.kernels.hdc_encoder.ops import encode_score_fused

    cfg = HDCConfig()
    device = torch.device(device or fake_device())
    ctx = shd.make_ctx(mesh)
    with _fake_mode():
        item = torch.empty((cfg.channels, 64, cfg.segments), dtype=torch.uint8, device=device)
        elec = torch.empty((cfg.channels, cfg.segments), dtype=torch.uint8, device=device)
        codes = torch.empty((batch, t, cfg.channels), dtype=torch.uint8, device=device)
        classes = torch.empty((2, cfg.words), dtype=torch.int32, device=device)
        rep = lambda x: shd.constrain(x, (None,) * x.ndim, ctx)  # noqa: E731
        item, elec, classes = rep(item), rep(elec), rep(classes)
        codes = shd.constrain(codes, ("batch", None, None), ctx)

        def serve(item_, elec_, codes_, classes_):
            params = IMParams(item_pos=item_, elec_pos=elec_, dim=cfg.dim,
                              segments=cfg.segments)
            return encode_score_fused(params, codes_, cfg, classes_)

        fn = serve
        if shd.on_mesh(ctx):
            rows = shd.placements(("batch", None, None), ctx, (batch, t // cfg.window, 2))
            fn = shd.local(serve, ctx, tuple(tuple(x.placements) for x in
                                             (item, elec, codes, classes)), (rows, rows))
        args = (item, elec, codes, classes)
        t0 = time.perf_counter()
        with op_cost.OpCounter(args) as counter:
            out = fn(*args)
        lower_s = time.perf_counter() - t0
        res = counter.result(out)
    return {"lower_s": lower_s,
            "cost": {"flops": res["flops"], "bytes accessed": res["bytes"]},
            "collectives": res["collectives"], "memory": res["memory"],
            "kernels": res["kernels"],
            "predictions_per_call": batch * (t // cfg.window)}


def run_hdc(out_dir: str, mesh_kind: str = "single", force: bool = False) -> dict:
    """Dry-run the paper's sparse-HDC inference as a serving cell: batched
    streams sharded over (pod,) data; AM classes replicated."""
    out_path = _out_path(out_dir, f"hdc-ieeg__serve__{mesh_kind}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    record = {"arch": "hdc-ieeg", "shape": "serve", "mesh": mesh_kind, "kind": "serve"}
    try:
        tr = trace_hdc(production_mesh(mesh_kind))
        record |= {"status": "ok", "lower_s": round(tr["lower_s"], 1),
                   "memory": tr["memory"], "cost": tr["cost"],
                   "collectives": tr["collectives"], "kernels": tr["kernels"],
                   "predictions_per_call": tr["predictions_per_call"],
                   "fake_device": fake_device().type, "card": roofline.CARD}
        print(f"[hdc {mesh_kind}] mem={tr['memory']} flops={tr['cost']['flops']} "
              f"bytes={tr['cost']['bytes accessed']} kernels={tr['kernels']}")
    except Exception as e:  # noqa: BLE001
        record |= {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        print(f"[hdc {mesh_kind}] FAILED: {record['error']}")
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def parse_override(kv: str) -> tuple[str, Any]:
    """``k=v`` with the reference's value parsing: True/False, int, float,
    else the string."""
    k, v = kv.split("=", 1)
    if v in ("True", "False"):
        return k, v == "True"
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(lmdata.SHAPES) + [None])
    ap.add_argument("--mesh", default=None, choices=["single", "multi", None])
    ap.add_argument("--hdc", action="store_true")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix for overrides")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. moe_dispatch=local_index")
    ap.add_argument("--sites", action="store_true",
                    help="also record flops and collectives by model line (slower)")
    args = ap.parse_args(argv)
    overrides = dict(parse_override(kv) for kv in args.override)

    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    try:
        if args.hdc:
            n_err = 0
            for mk in meshes:
                n_err += run_hdc(args.out, mk, force=args.force).get("status") == "error"
            if n_err:
                raise SystemExit(1)
            return
        archs = [args.arch] if args.arch else list(ARCH_IDS)
        shapes = [args.shape] if args.shape else list(lmdata.SHAPES)
        n_ok = n_skip = n_err = 0
        for mk in meshes:
            for a in archs:
                for s in shapes:
                    rec = run_cell(a, s, mk, args.out, force=args.force,
                                   overrides=overrides, tag=args.tag, sites=args.sites)
                    status = rec.get("status")
                    n_ok += status == "ok"
                    n_skip += status == "skipped"
                    n_err += status == "error"
                    print(f"== {a} {s} {mk}: {status}", flush=True)
        print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
        if n_err:
            raise SystemExit(1)
    finally:
        if mesh_mod.is_fake_world():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
