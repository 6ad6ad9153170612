"""The port's mesh and sharding modules (``launch/mesh.py``,
``runtime/sharding.py``), checkpoints restored by placements, batch
placement, and the mesh fleet across mesh sizes and through the CLI.

Placements are held against the reference's ``to_pspec`` and ``_sanitize``
(a ``PartitionSpec`` per TENSOR dim, turned into one placement per MESH dim
here) for both rule sets and every config's parameter tree at 16 x 16 and
2 x 16 x 16, with a stand-in mesh object (``axis_names``,
``devices.shape``), so no devices are needed.  Multi-rank cases start one
plain process a rank (``tests/mesh_worker.py``) over ``gloo``.

Tolerance: exact equality.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import mesh_worker
from repro.configs import registry as j_registry
from repro.models import model as j_model
from repro.runtime import sharding as j_shd
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.configs import registry
from repro_torch.models import model, params
from repro_torch.runtime import sharding as shd
from repro_torch.serve.fleet import StreamingFleet
from test_torch_fleet import _banks, _cycle
from test_torch_fleet_mesh import BUCKETS, CHANNELS, _data_dir, _reference_run, _schedule

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(shape, names):
    """What the reference's ``_sanitize`` reads of a mesh."""
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _from_pspec(pspec, names, rank: int) -> tuple:
    """A reference ``PartitionSpec`` as one placement a mesh dim: the mesh
    axes of tensor dim d, which must come in mesh order, shard d."""
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(pspec) + (None,) * (rank - len(pspec))):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        assert dims == sorted(dims), (pspec, names)
        for m in dims:
            assert out[m] == Replicate(), f"{pspec}: mesh axis used twice"
            out[m] = Shard(d)
    return tuple(out)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_placements_match_reference(arch, mesh):
    """Every leaf of the config's parameter tree, under the default rules
    and ``seq_sharded_kv``: the port's placements (``tree_shardings``'s
    rule, ``placements_for``) equal the reference's sanitised
    ``PartitionSpec``."""
    shape, names = MESHES[mesh]
    stand_in = _stand_in(shape, names)
    jspec = _leaves(j_model.model_spec(j_registry.get_config(arch)))
    tspec = params.flatten(model.model_spec(registry.get_config(arch)))
    assert sorted(jspec) == sorted(tspec)
    sharded = 0
    for seq_kv in (False, True):
        jrules = j_shd.make_ctx(None).rules or j_shd._base_rules(names)
        if seq_kv:
            jrules = jrules | {"batch": (), "kv_seq": jrules["fsdp"], "kv_tp": ("model",)}
        rules = shd.rules_for(names, seq_sharded_kv=seq_kv)
        assert rules == jrules
        for key, js in jspec.items():
            ts = tspec[key]
            assert (ts.shape, ts.axes) == (js.shape, js.axes)
            want = _from_pspec(j_shd._sanitize(j_shd.to_pspec(js.axes, jrules), js.shape,
                                               stand_in), names, len(js.shape))
            got = shd.placements_for(ts.axes, rules, ts.shape, names, shape)
            assert got == want, (key, seq_kv)
            sharded += any(p != Replicate() for p in got)
    assert sharded > 0


ACTIVATIONS = [
    (("batch", None), (64, 32)),
    (("batch", "kv_seq", None, "kv_tp"), (32, 1024, 8, 128)),
    (("batch", "kv_seq", None, "kv_tp"), (1, 4096, 8, 64)),
    ((None, "tp"), (24, 8)),                 # 8 over a 16-way model axis: replicated
    (("tp", "fsdp", None), (64, 4096, 1408)),
    ((("batch", "tp"), None), (512, 3)),     # one tensor dim over data and model
    (("stage", None, "tp"), (2, 48, 32)),
    (("fsdp", None), (17, 3)),               # 17 rows divide nothing
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_placements_and_sanitize_match_reference(mesh):
    """Activation and cache axes, dims that do and do not divide their mesh
    axes, both rule sets; without a shape nothing is sanitised."""
    shape, names = MESHES[mesh]
    stand_in = _stand_in(shape, names)
    for seq_kv in (False, True):
        rules = shd.rules_for(names, seq_sharded_kv=seq_kv)
        for axes, tshape in ACTIVATIONS:
            pspec = j_shd.to_pspec(axes, rules)
            want = _from_pspec(j_shd._sanitize(pspec, tshape, stand_in), names, len(tshape))
            assert shd.placements_for(axes, rules, tshape, names, shape) == want, axes
            assert shd.placements_for(axes, rules, None, names, shape) == \
                _from_pspec(pspec, names, len(tshape))
    with pytest.raises(ValueError, match="two tensor dims"):
        shd.placements_for(("batch", "fsdp"), shd.rules_for(names), None, names, shape)


def test_sharding_without_a_mesh_is_the_identity():
    ctx = shd.make_ctx(None)
    x = torch.arange(6)
    assert ctx.axis_sizes == {} and shd.sharding_for(("batch",), ctx) is None
    assert shd.constrain(x, ("batch",), ctx) is x
    assert shd.place(x, None) is x
    assert shd.tree_shardings({"w": params.ParamSpec((4, 2), ("fsdp", None))}, ctx) == {"w": None}
    sh = shd.Sharding(SimpleNamespace(shape=(2, 2)), (Shard(0), Replicate()))
    assert shd.local_rows(8, sh, (1, 0)) == slice(4, 8)
    assert shd.local_rows(8, sh, (1, 1)) == slice(4, 8)
    assert shd.local_rows(8, None, (1, 1)) == slice(0, 8)


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_guards_and_parse_mesh(no_group):
    """A one-rank group over a FileStore; a mesh larger than the world
    raises naming ``torch.distributed.run``; a CUDA mesh without a card
    raises; ``parse_mesh`` names the reference's axes."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import parse_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_mod.make_mesh((1,), ("data",))
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_mod.make_mesh((1,), ("data",), device="cuda:0")
    assert parse_mesh(None) is None and parse_mesh("none") is None
    for spec, axes in (("1", ("data",)), ("1x1", ("data", "model")),
                       ("1x1x1", ("pod", "data", "model"))):
        m = parse_mesh(spec, device="cpu")
        assert m.mesh_dim_names == axes and m.device_type == "cpu"
        assert shd.make_ctx(m).axis_sizes == dict.fromkeys(axes, 1)
    assert dist.get_world_size() == 1
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        mesh_mod.make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        mesh_mod.make_mesh((1, 1), ("data",), device="cpu")
    with pytest.raises(ValueError, match="1 to 3 sizes"):
        parse_mesh("1x1x1x1", device="cpu")
    mesh_mod.device_count_or_die(1)


def test_checkpoint_placements_and_batches_on_two_ranks(tmp_path):
    """On 2 gloo ranks: ``restore(shardings=)`` of placements (each rank
    its block, no broadcast) and of a device, ``restore_latest``, a sharded
    leaf saved whole by rank 0, ``shard_to_devices`` and ``constrain``."""
    mesh_worker.spawn("ckpt", {"mesh": [2], "axes": ["data"]}, str(tmp_path))


def test_mesh_restore_across_mesh_sizes(tmp_path):
    """A reference checkpoint restores onto 2 ranks, their save onto 4, and
    the 4 ranks' save onto an unsharded port fleet; each continues with the
    reference's decisions."""
    jbank, tbank = _banks(CHANNELS)
    owners = _cycle(24)
    sched = _schedule(24, seed=11)
    jf = JFleet(jbank, owners, buckets=BUCKETS, backend="jnp")
    for i in range(2):
        jf.push(mesh_worker.chunks_of(sched[f"batch{i}"], sched[f"lens{i}"]))
        if f"labels{i}" in sched:
            jf.adapt(sched[f"labels{i}"])
    roots = [str(tmp_path / f"ck{i}") for i in range(3)]
    jf.save(roots[0], step=0)
    want = _reference_run(jf, sched, parts=(2, 3, 4))
    data = _data_dir(tmp_path, tbank, sched, want)
    for part, (mesh, src, dst) in enumerate(
            [((2,), roots[0], roots[1]), ((4,), roots[1], roots[2])], start=2):
        mesh_worker.spawn("restore", {"mesh": list(mesh), "axes": ["data"], "owners": owners,
                                      "buckets": list(BUCKETS), "data": data,
                                      "restore": src, "save": dst, "part": part},
                          str(tmp_path / f"group{part}"))
    plain = StreamingFleet(tbank, owners, buckets=BUCKETS)
    assert plain.restore(roots[2]) == 0
    np.testing.assert_array_equal(plain.fill_levels, want["fill4"])
    got = mesh_worker.flat_decisions(
        plain.push(mesh_worker.chunks_of(sched["batch4"], sched["lens4"])))
    for k, v in got.items():
        np.testing.assert_array_equal(v.reshape(-1), want[f"p4.{k}"].reshape(-1))


def test_mesh_cli_two_ranks(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.serve --hdc-fleet --mesh 2 --device cpu`` exits 0,
    prints once (rank 0), makes the unsharded CLI's decisions and writes
    one checkpoint; ``compile --mesh`` is refused (the LM's ``--mesh``,
    refused until the LM-on-a-mesh slice, runs: tests/test_torch_lm_serve.py)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    args = ["--hdc-fleet", "--device", "cpu", "--sessions", "8", "--patients", "2",
            "--rounds", "3", "--adapt-every", "2"]
    mesh = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", *args, "--mesh", "2",
         "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=240)
    assert mesh.returncode == 0, mesh.stdout + mesh.stderr
    plain = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                           env=env, capture_output=True, text=True, timeout=240)
    assert plain.returncode == 0, plain.stderr
    fleet_lines = [ln for ln in mesh.stdout.splitlines() if ln.startswith("fleet:")]
    assert len(fleet_lines) == 1 and "mesh 2 (data)" in fleet_lines[0]

    def decisions(out):
        return [ln.split("(", 1)[1].split(",")[1] for ln in out.splitlines()
                if ln.startswith("stream:")]

    assert len(decisions(mesh.stdout)) == 1
    assert decisions(mesh.stdout) == decisions(plain.stdout)
    from repro_torch.ckpt import checkpoint as ckpt

    assert ckpt.list_steps(str(tmp_path / "ck")) == [0]    # rank 0 wrote it once
    for bad, msg in ((["compile", "--aot-dir", str(tmp_path / "aot"), "--mesh", "2"], "drop --mesh"),):
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *bad,
                              "--device", "cpu"], env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and msg in out.stderr, out.stderr


def test_pad_runs_on_each_ranks_shards():
    """``shd.pad`` pads unsharded dims on each rank's shards (placements
    kept, a fake (2, 2) world), equals ``F.pad`` without a mesh, and
    refuses to pad a sharded dim."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import mesh as mesh_mod

    x = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(shd.pad(x, (0, 0, 2, 0), None),
                       torch.nn.functional.pad(x, (0, 0, 2, 0)))
    mesh_mod.fake_world(4)
    try:
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
        ctx = shd.make_ctx(mesh)
        with FakeTensorMode():
            xd = distribute_tensor(torch.empty(4, 6, 8), mesh, [Shard(0), Shard(2)],
                                   src_data_rank=None)
            y = shd.pad(xd, (0, 0, 3, 0), ctx)
            assert tuple(y.placements) == (Shard(0), Shard(2))
            assert tuple(y.shape) == (4, 9, 8) and tuple(y.to_local().shape) == (2, 9, 4)
            with pytest.raises(ValueError, match="sharded"):
                shd.pad(xd, (1, 0), ctx)
    finally:
        dist.destroy_process_group()
