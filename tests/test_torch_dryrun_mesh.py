"""The dry-run is faithful: a cell traced as rank 0 of a fake world
(``launch/mesh.py::fake_world``, fake tensors) counts what a real rank of
as many gloo ranks counts running the same step on real tensors, under the
same counter (``runtime/op_cost.py``).

Cells: the reduced qwen3-0.6b of the reference's small-mesh dry-run
(d_model 256, 4 query heads, 2 KV heads, vocab 1024, d_ff 512), batch
4 x 64, train step, prefill and decode step, on ``1x2`` (data x model)
and on ``2x2``.  The real ranks are ``tests/mesh_worker.py``'s ``dryrun``
case; the fake world runs in this process and is destroyed after.

Tolerance: exact equality of flops, bytes, each collective kind's bytes,
``n_ops``, argument bytes and the peak estimate.
"""

import json

import pytest
import torch.distributed as dist

import mesh_worker
from repro_torch.configs import registry
from repro_torch.data import lm as lmdata
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

OVERRIDES = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, vocab=1024, d_ff=512)
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 4, 64


def _fake(shape: tuple) -> dict:
    cfg = registry.get_config("qwen3-0.6b").reduced(**OVERRIDES)
    mesh_mod.fake_world(shape[0] * shape[1])
    try:
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), device="cpu")
        return {k: dryrun.trace_cell(cfg, lmdata.ShapeSpec(k, SEQ, BATCH, k), mesh,
                                     device="cpu", seq_sharded_kv=False) for k in KINDS}
    finally:
        dist.destroy_process_group()


MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def real_counts(tmp_path_factory) -> dict:
    """Each mesh's real ranks, all started at once."""
    root = tmp_path_factory.mktemp("dryrun_mesh")
    groups = {shape: str(root / "x".join(map(str, shape))) for shape in MESHES}
    mesh_worker.spawn_all([("dryrun", {"mesh": list(shape), "axes": ["data", "model"],
                                       "arch": "qwen3-0.6b", "overrides": OVERRIDES,
                                       "kinds": list(KINDS), "batch": BATCH, "seq": SEQ},
                            group) for shape, group in groups.items()])
    out = {}
    for shape, group in groups.items():
        with open(f"{group}/dryrun.json") as f:
            out[shape] = json.load(f)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
def test_fake_world_counts_what_real_ranks_count(real_counts, shape):
    real = real_counts[shape]
    fake = _fake(shape)
    for kind in KINDS:
        got, want = fake[kind], real[kind]
        assert got["cost"] == want["cost"], kind
        assert got["collectives"] == want["collectives"], kind
        for key in ("argument_size_in_bytes", "peak_bytes_per_device_est"):
            assert got["memory"][key] == want["memory"][key], (kind, key)
        assert got["collectives"]["n_ops"] > 0, kind
