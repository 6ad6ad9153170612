"""``runtime/op_cost.py``: one rank's work counted per device, at the local
shapes DTensor dispatches, outside and inside ``local_map`` regions.

* a (4096, 4096) x (4096, 8192) product, rows over ``data`` and columns
  over ``model`` of a fake (16, 32) world, counts one rank's
  2 x 256 x 4096 x 256 = 536,870,912 flops, not the global
  2 x 4096 x 8192 x 4096 that ``FlopCounterMode`` reports at DTensor's
  level;
  the same product written inside ``shd.local`` counts the same;
* planted redistributions count as their collective kinds, with each
  kind's local output bytes and ``n_ops``;
* planted steps with a known peak give the reference's memory keys;
* DTensor's bookkeeping is paused only while a counter is active: its
  functions are the originals again after the outermost counter exits,
  and a torch that lacks one of them raises rather than count
  global-shape ops.

Tolerance: exact equality.
"""

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime import op_cost
from repro_torch.runtime import sharding as shd

MIB = 1 << 20


@pytest.fixture()
def world_16x32():
    mesh_mod.fake_world(512)
    try:
        yield mesh_mod.make_mesh((16, 32), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def _operands(mesh):
    x = distribute_tensor(torch.empty(4096, 4096), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(4096, 8192), mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    return x, w


def test_product_counts_one_ranks_flops(world_16x32):
    with FakeTensorMode():
        x, w = _operands(world_16x32)
        with FlopCounterMode(display=False) as global_count:
            x @ w
        with op_cost.OpCounter((x, w)) as c:
            y = x @ w
    # DTensor's level sees the global product (some torch versions add the
    # local one to it: 275,414,777,856)
    assert global_count.get_total_flops() in (274_877_906_944, 275_414_777_856)
    assert c.flops == 2 * 256 * 4096 * 256 == 536_870_912
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert c.result(y)["collectives"] == {"n_ops": 0}


def test_product_inside_local_counts_the_same(world_16x32):
    ctx = shd.make_ctx(world_16x32)
    with FakeTensorMode():
        x, w = _operands(world_16x32)
        with op_cost.OpCounter((x, w)) as c:
            shd.local(lambda a, b: a @ b, ctx, (x.placements, w.placements),
                      ((Shard(0), Shard(1)),))(x, w)
    assert c.flops == 536_870_912


def test_collective_kinds_and_bytes(world_16x32):
    """x (256, 4096) float32 a rank: an all-gather over data (16 ranks:
    64 MiB out), a reduce-scatter of a partial sum over model (32 ranks:
    32 KiB out) and an all-reduce of one over model (4 MiB out)."""
    mesh = world_16x32
    with FakeTensorMode():
        x, _ = _operands(mesh)
        part = distribute_tensor(torch.empty(4096, 4096), mesh, [Shard(0), Replicate()],
                                 src_data_rank=None)
        part = part.redistribute(mesh, [Shard(0), Replicate()])
        with op_cost.OpCounter((x,)) as c:
            x.redistribute(mesh, [Replicate(), Replicate()])
        with op_cost.OpCounter((x,), sites=True) as c2:
            p = torch.distributed.tensor.DTensor.from_local(
                part.to_local(), mesh, [Shard(0), Partial()], run_check=False)
            p.redistribute(mesh, [Shard(0), Shard(0)])
            p.redistribute(mesh, [Shard(0), Replicate()])
    assert c.result()["collectives"] == {"all-gather": 64 * MIB, "n_ops": 1}
    assert c2.result()["collectives"] == {"reduce-scatter": 4 * MIB // 32,
                                          "all-reduce": 4 * MIB, "n_ops": 2}
    # no model line issued them: one site, "?", holds both
    assert c2.site_collectives == {"?": {"reduce-scatter": 4 * MIB // 32,
                                         "all-reduce": 4 * MIB, "n_ops": 2}}
    assert c.site_collectives == {}


def test_memory_of_planted_steps():
    """b = a * 2 and c = b + 1 live together (2 MiB), b dies, e = c * c
    (2 MiB again), the sum returned: temporaries 2 MiB beyond the 1 MiB
    argument; an in-place step aliases its argument; in a backward, the
    product w * 3 and exp's output live together (2 MiB), then exp's output
    (saved for the backward: its name is deleted before) and its gradient
    (2 MiB), then that gradient and w's (2 MiB), beside the loss and the
    loss's gradient (4 bytes each)."""
    a = torch.ones(256, 1024)

    def step(a):
        b = a * 2
        c = b + 1
        del b
        e = c * c
        return e.sum()

    with op_cost.OpCounter((a,)) as c:
        out = step(a)
    assert c.memory(out) == {"argument_size_in_bytes": MIB, "output_size_in_bytes": 4,
                             "temp_size_in_bytes": 2 * MIB, "alias_size_in_bytes": 0,
                             "peak_bytes_per_device_est": 3 * MIB + 4}
    with op_cost.OpCounter((a,)) as c:
        out = a.mul_(2)
    assert c.memory(out) == {"argument_size_in_bytes": MIB, "output_size_in_bytes": MIB,
                             "temp_size_in_bytes": 0, "alias_size_in_bytes": MIB,
                             "peak_bytes_per_device_est": MIB}
    w = torch.ones(256, 1024, requires_grad=True)
    live_after_del = []

    def train(w):
        s = (w * 3).exp()     # exp saves its output for the backward
        loss = s.sum()
        del s
        w.sum()               # an op: the counter looks at what died
        live_after_del.append(op_cost.active().live_bytes)
        if not torch.is_grad_enabled():
            return loss
        (g,) = torch.autograd.grad(loss, [w])
        return g

    with op_cost.OpCounter((w,)) as c:
        g = train(w)
    assert live_after_del == [MIB + 8]     # exp's output, the loss, the probe's sum
    assert c.peak_live == 2 * MIB + 8       # the probe's sum died; the loss and its gradient
    assert c.memory(g) == {"argument_size_in_bytes": MIB, "output_size_in_bytes": MIB,
                           "temp_size_in_bytes": MIB + 8, "alias_size_in_bytes": 0,
                           "peak_bytes_per_device_est": 3 * MIB + 8}
    with op_cost.OpCounter((w,)) as c, torch.no_grad():
        train(w)
    assert live_after_del[1] == 8          # nothing saved: exp's output died
    assert c.peak_live == 2 * MIB


def test_dtensor_bookkeeping_patched_only_inside_a_counter(monkeypatch):
    from torch.distributed.tensor import _sharding_prop, placement_types

    prop = _sharding_prop.ShardingPropagator
    names = ((prop, "propagate_op_sharding_non_cached"),
             (prop, "_propagate_tensor_meta_non_cached"),
             (placement_types._StridedShard, "local_shard_size_and_offset"))
    before = [cls.__dict__[n] for cls, n in names]
    with op_cost.OpCounter():
        assert all(cls.__dict__[n] is not b for (cls, n), b in zip(names, before))
        with op_cost.OpCounter():
            pass
        assert all(cls.__dict__[n] is not b for (cls, n), b in zip(names, before))
    assert [cls.__dict__[n] for cls, n in names] == before

    monkeypatch.delattr(prop, "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta_non_cached"):
        with op_cost.OpCounter():
            pass
    assert op_cost.active() is None
    assert [cls.__dict__.get(n) for cls, n in names[::2]] == before[::2]
