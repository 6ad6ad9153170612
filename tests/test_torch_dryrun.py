"""``launch/dryrun.py`` held against the reference's dry-run.

* Per-device flops of the reference's small-mesh cells (qwen3-0.6b reduced
  to d_model 256, 4 query heads, 2 KV heads, vocab 1024, d_ff 512; batch
  4 x 64, float32) against ``repro.runtime.hlo_cost.analyze_hlo`` of the
  reference's compiled step, lowered in a subprocess on 8 host devices
  with a mesh whose axes are ``Auto`` (jax 0.9's ``jax.make_mesh`` makes
  Explicit axes, on which the reference's ``with_sharding_constraint``
  raises).
  - 1x1: prefill and decode equal.  The train step counts one more
    unembedding product (2 x B x L x d x V): ``chunked_xent``'s single
    chunk is recomputed in the backward (a checkpoint), which XLA folds
    when there is one chunk; at L = 1024 (two chunks) XLA recomputes each
    chunk too and the counts are equal.
  - 2x4 (data x model, 2 KV heads over 4 ranks): each product's flops
    by model line (``op_cost``'s sites) against its 1x1 count / 8.  Every
    site within 1%, except the named ones: ``_proj``, whose K/V
    projections run replicated over ``model`` (the reference's
    ``_sanitize`` drops the split; XLA's partitioner splits the
    projection over ``model`` anyway and gathers after), at 2.5x its share
    forward and backward, and the MLP's backward, at 2.25x (DTensor's
    strategies for the weight gradients' products gather d_ff over
    ``model``).  Prefill and decode equal the reference plus the named
    excess exactly; the train step is within 1.5x of the reference.
* ``roofline_terms`` against the reference's with the reference's
  constants in place: equal to 1e-12 relative.
* ``run_cell``/``main``: a skipped long_500k cell, an error recorded with
  exit code 1, an existing record kept unless ``--force``, ``--sites``.
* ``--hdc``: the encoder kernel's fake launch on a small fake mesh, and
  the production cell on 256 fake ranks.
* ``_chunked_attention``'s scale, rounded without a tensor, bit-equal to
  ``torch.tensor(x, dtype).item()`` in float32, bfloat16 and float16.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as j_registry
from repro.data import lm as j_lmdata
from repro.runtime import roofline as j_roofline
from repro_torch.configs import registry
from repro_torch.data import lm as lmdata
from repro_torch.kernels.hdc_encoder import ops as enc_ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention
from repro_torch.runtime import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, vocab=1024, d_ff=512)
B, L = 4, 64
CELLS = ["train:1x1:64", "prefill:1x1:64", "decode:1x1:64", "train:1x1:1024",
         "train:2x4:64", "prefill:2x4:64", "decode:2x4:64"]
# site (file and function) -> (factor of its 1x1 share, why)
NAMED = {
    "attention.py _proj": (2.5, "K/V projections replicated over model (KV % tp)"),
    "grad of attention.py _proj": (2.5, "their backward, replicated too"),
    "grad of layers.py mlp": (2.25, "DTensor gathers d_ff for the weight gradients"),
}

# the 2x4 counts chip_smoke.py phase 16 (a) holds on the card's torch build
MESH_FLOPS = {"prefill:2x4:64": 105_119_744, "decode:2x4:64": 1_900_544}
MESH_ARG_BYTES = {"train:2x4:64": 2_771_972, "prefill:2x4:64": 924_160,
                  "decode:2x4:64": 989_192}

DECODE_ATTENTION = {"attention.py attend", "attention.py _grouped_scores",
                    "attention.py _attend_cache"}

_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.data import lm as lmdata
from repro.models import params as pmod
from repro.optim import adamw
from repro.runtime import steps as steps_mod
from repro.runtime.hlo_cost import analyze_hlo

cfg = get_config("qwen3-0.6b").reduced(**json.loads(sys.argv[1]))
out = {}
for cell in sys.argv[2:]:
    kind, m, seq = cell.split(":")
    shape_ = tuple(int(x) for x in m.split("x"))
    mesh = jax.make_mesh(shape_, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shape = lmdata.ShapeSpec("x", int(seq), %(batch)d, kind)
    specs = lmdata.input_specs(cfg, shape)
    if kind == "train":
        f, _, spec = steps_mod.jit_train_step(cfg, adamw.OptConfig(), mesh, specs)
        mv = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), spec,
                          is_leaf=lambda s: isinstance(s, pmod.ParamSpec))
        lo = f.lower(pmod.abstract(spec, jnp.float32),
                     dict(m=mv, v=mv, step=jax.ShapeDtypeStruct((), jnp.int32)), specs)
    elif kind == "prefill":
        f, _, spec = steps_mod.jit_prefill(cfg, mesh, specs, int(seq))
        lo = f.lower(pmod.abstract(spec, jnp.float32), specs)
    else:
        f, _, spec = steps_mod.jit_decode_step(cfg, mesh, specs)
        lo = f.lower(pmod.abstract(spec, jnp.float32), specs["tokens"], specs["caches"],
                     specs["pos"])
    out[cell] = analyze_hlo(lo.compile().as_text())["flops"]
print("FLOPS", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_flops():
    """The reference's counts, computed in two subprocesses that run while
    the port traces its cells."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE % {"batch": B}),
         json.dumps(OVERRIDES), *cells],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cells in (CELLS[::2], CELLS[1::2])]

    def result() -> dict:
        flops = {}
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            flops.update(json.loads(out.split("FLOPS", 1)[1]))
        return flops
    yield result
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _cfg():
    return registry.get_config("qwen3-0.6b").reduced(**OVERRIDES)


def _by_function(site_flops: dict) -> dict:
    """``op_cost`` sites ("file:line function") summed by file and function."""
    out: dict = {}
    for site, f in site_flops.items():
        key = re.sub(r":\d+", "", site)
        out[key] = out.get(key, 0) + f
    return out


@pytest.fixture(scope="module")
def port_cells():
    cfg = _cfg()
    out = {}
    for kind in ("train", "prefill", "decode"):
        out[f"{kind}:1x1:64"] = dryrun.trace_cell(cfg, lmdata.ShapeSpec(kind, L, B, kind), None,
                                                  sites=True, seq_sharded_kv=False)
    out["train:1x1:1024"] = dryrun.trace_cell(cfg, lmdata.ShapeSpec("t", 1024, B, "train"),
                                              None)
    mesh_mod.fake_world(8)
    try:
        mesh = mesh_mod.make_mesh((2, 4), ("data", "model"), device=dryrun.fake_device())
        for kind in ("train", "prefill", "decode"):
            out[f"{kind}:2x4:64"] = dryrun.trace_cell(
                cfg, lmdata.ShapeSpec(kind, L, B, kind), mesh, sites=True,
                seq_sharded_kv=False)
    finally:
        dist.destroy_process_group()
    return out


def test_flops_per_device_against_reference(port_cells, reference_flops):
    ref = reference_flops()
    flops = {k: v["cost"]["flops"] for k, v in port_cells.items()}
    assert flops["prefill:1x1:64"] == ref["prefill:1x1:64"] == 639_631_360
    assert flops["decode:1x1:64"] == ref["decode:1x1:64"] == 12_058_624
    unembed = 2 * B * L * OVERRIDES["d_model"] * OVERRIDES["vocab"]
    assert flops["train:1x1:64"] - ref["train:1x1:64"] == unembed
    assert flops["train:1x1:1024"] == ref["train:1x1:1024"]

    for kind in ("train", "prefill", "decode"):
        one = _by_function(port_cells[f"{kind}:1x1:64"]["site_flops"])
        mesh = _by_function(port_cells[f"{kind}:2x4:64"]["site_flops"])
        assert sum(mesh.values()) == flops[f"{kind}:2x4:64"]
        colls = port_cells[f"{kind}:2x4:64"]["collectives"]
        by_site = port_cells[f"{kind}:2x4:64"]["site_collectives"]
        for k in colls:
            assert sum(d.get(k, 0) for d in by_site.values()) == colls[k], (kind, k)
        excess = 0.0
        for site in set(one) | set(mesh):
            share, got = one.get(site, 0) / 8, mesh.get(site, 0)
            if site in DECODE_ATTENTION:
                continue      # sharded and unsharded decode differ in function
            factor = NAMED.get(site, (1.0, ""))[0]
            assert got == pytest.approx(factor * share, rel=0.01), (kind, site, got, share)
            excess += got - share
        attend = [sum(v for k, v in d.items() if k in DECODE_ATTENTION) for d in (one, mesh)]
        assert attend[1] == attend[0] / 8, kind
        if kind != "train":
            assert flops[f"{kind}:2x4:64"] == ref[f"{kind}:2x4:64"] + excess, kind
            assert ref[f"{kind}:2x4:64"] == ref[f"{kind}:1x1:64"] / 8
    assert flops["train:2x4:64"] <= 1.5 * ref["train:2x4:64"]
    assert ref["train:2x4:64"] == 339_738_624
    for cell, want in MESH_FLOPS.items():
        assert flops[cell] == want, cell
    for cell, want in MESH_ARG_BYTES.items():
        assert port_cells[cell]["memory"]["argument_size_in_bytes"] == want, cell


def test_roofline_terms_equal_the_reference(monkeypatch):
    for name, value in (("PEAK_FLOPS", j_roofline.PEAK_FLOPS), ("HBM_BW", j_roofline.HBM_BW),
                        ("LINK_BW", j_roofline.ICI_BW)):
        monkeypatch.setattr(roofline, name, value)
    cost = {"flops": 3.1e15, "bytes accessed": 7.7e12}
    colls = {"all-gather": 2.5e10, "all-reduce": 1.25e10, "reduce-scatter": 3e9,
             "all-to-all": 7e8, "collective-permute": 1e8, "n_ops": 421}
    for arch in ("qwen3-0.6b", "deepseek-moe-16b", "seamless-m4t-medium"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            for dims in ((16, 16), (2, 16, 16)):
                kw = dict(n_total=1_234_567_890, n_active=456_789_012)
                want = j_roofline.roofline_terms(
                    cost, colls, j_registry.get_config(arch), j_lmdata.SHAPES[shape],
                    SimpleNamespace(devices=np.empty(dims)), **kw)
                got = roofline.roofline_terms(cost, colls, registry.get_config(arch),
                                              lmdata.SHAPES[shape], int(np.prod(dims)), **kw)
                assert got.keys() == want.keys()
                for k in want:
                    if isinstance(want[k], str):
                        assert got[k] == want[k]
                    else:
                        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    mem = {"argument_size_in_bytes": 10, "output_size_in_bytes": 4,
           "temp_size_in_bytes": 7, "alias_size_in_bytes": 3}
    assert roofline.memory_analysis_dict(mem) == j_roofline.memory_analysis_dict(
        SimpleNamespace(**mem))


def test_run_cell_records_and_statuses(tmp_path, capsys):
    out = str(tmp_path)
    argv = ["--arch", "qwen3-0.6b", "--mesh", "single", "--out", out]
    dryrun.main(argv + ["--shape", "long_500k"])
    assert "done: 0 ok, 1 skipped, 0 errors" in capsys.readouterr().out
    path = tmp_path / "qwen3-0.6b__long_500k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
    path.write_text(json.dumps({**rec, "reason": "kept"}))
    assert dryrun.run_cell("qwen3-0.6b", "long_500k", "single", out)["reason"] == "kept"
    assert "quadratic" in dryrun.run_cell("qwen3-0.6b", "long_500k", "single", out,
                                          force=True)["reason"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv + ["--shape", "decode_32k", "--override", "no_such_field=1",
                            "--tag", "bad"])
    assert e.value.code == 1
    assert "done: 0 ok, 0 skipped, 1 errors" in capsys.readouterr().out
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single__bad.json").read_text())
    assert rec["status"] == "error" and "no_such_field" in rec["error"] and rec["trace"]
    assert rec["overrides"] == {"no_such_field": 1}
    assert [dryrun.parse_override(kv) for kv in
            ("a=True", "b=False", "c=3", "d=0.5", "e=local_index")] == [
        ("a", True), ("b", False), ("c", 3), ("d", 0.5), ("e", "local_index")]
    # --sites: flops and collectives by model line, summing to the totals
    dryrun.main(argv + ["--shape", "decode_32k", "--override", "n_layers=1", "--sites",
                        "--tag", "sites"])
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single__sites.json").read_text())
    assert rec["status"] == "ok" and sum(rec["site_flops"].values()) == rec["cost"]["flops"]
    assert {k: sum(d.get(k, 0) for d in rec["site_collectives"].values())
            for k in rec["collectives"]} == rec["collectives"]
    assert not mesh_mod.is_fake_world()


def test_hdc_cell_records_the_encoder_launch(tmp_path):
    """The fake launch is recorded in op_cost only: the wrappers' launch
    counts, which chip_smoke.py reads, stay as they were."""
    counts = enc_ops.encoder.launches, enc_ops.encode_score_fused.launches
    mesh_mod.fake_world(4)
    try:
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device=dryrun.fake_device())
        r = dryrun.trace_hdc(mesh, batch=16, t=512)
    finally:
        dist.destroy_process_group()
    # each rank: 8 streams of 2 frames of 256 cycles, 64 channels, CompIM
    # (64, 64, 8), 2 class rows of 32 words
    want = enc_ops.work(16, 256, 64, 64, 8, 128, n_classes=2)
    assert r["kernels"] == {"hdc_encoder": {"launches": 1, "bytes": want[0],
                                            "int_ops": want[1]}}
    assert r["predictions_per_call"] == 32
    assert r["collectives"] == {"n_ops": 0}
    assert r["memory"]["output_size_in_bytes"] == 8 * 2 * (2 + 1) * 4
    rec = dryrun.run_hdc(str(tmp_path), "single")
    assert rec["status"] == "ok" and rec["kernels"]["hdc_encoder"]["launches"] == 1
    assert rec["predictions_per_call"] == 8192 * 8
    dist.destroy_process_group()
    assert (enc_ops.encoder.launches, enc_ops.encode_score_fused.launches) == counts


def test_attention_scale_rounds_without_a_tensor():
    for hd in range(1, 1025):
        x = attention._scale(hd)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            assert attention._rounded(x, dt) == torch.tensor(x, dtype=dt).item(), (hd, dt)


def test_fake_world_refuses_a_real_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="real process group"):
            mesh_mod.fake_world(8)
    finally:
        dist.destroy_process_group()


def test_kernel_wrappers_take_fake_tensors_only_together():
    """Fake operands go the kernel's way (the wrapper traces the launch);
    fake beside real operands raise."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.common import use_plain

    real = torch.zeros(4, dtype=torch.uint8)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.empty(4, dtype=torch.uint8)
        assert use_plain(fake, fake) is False
        with pytest.raises(ValueError, match="mix fake and real"):
            use_plain(fake, real)
    assert use_plain(real) is True
