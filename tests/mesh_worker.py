"""One rank of a CPU mesh for ``tests/test_torch_mesh.py`` and
``tests/test_torch_fleet_mesh.py`` (not a test module: pytest does not
collect it).

    python tests/mesh_worker.py CASE RANK WORLD WORKDIR

The rank joins a ``gloo`` group over ``file://WORKDIR/store`` (no TCP port
to collide with other test workers), builds its mesh from
``WORKDIR/spec.json`` and runs ``CASE`` against what the parent process
wrote to ``spec["data"]`` (the reference's decisions, computed there with the
JAX package; this process imports only torch and the port).  Any mismatch
raises, and the rank exits non-zero; a rank whose peer died fails at its
next collective after the group's timeout.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 60


def flat_decisions(decisions) -> dict:
    """A fleet push's decisions as arrays: session, frame index,
    prediction, scores and frame HV of every decision, in session order."""
    rows = [(i, d) for i, ds in enumerate(decisions) for d in ds]
    return {
        "session": np.asarray([i for i, _ in rows], np.int64),
        "frame_index": np.asarray([d.frame_index for _, d in rows], np.int64),
        "prediction": np.asarray([d.prediction for _, d in rows], np.int64),
        "scores": np.asarray([np.asarray(d.scores) for _, d in rows], np.int64),
        "frame_hv": np.asarray([np.asarray(d.frame_hv) for _, d in rows], np.uint32),
    }


def assert_same_decisions(got, want, what: str) -> None:
    a, b = flat_decisions(got), flat_decisions(want)
    for k in a:
        np.testing.assert_array_equal(a[k].reshape(-1), b[k].reshape(-1),
                                      err_msg=f"{what}: {k}")


def save_bank(path: str, bank: dict) -> None:
    """A port bank (sparse pipelines on the CPU) as arrays a rank rebuilds
    it from."""
    import dataclasses

    from repro_torch.core import hv

    arrays, cfgs = {}, {}
    for pid, p in bank.items():
        cfgs[pid] = dataclasses.asdict(p.cfg)
        arrays[f"{pid}.item"] = p.params.item_pos.cpu().numpy()
        arrays[f"{pid}.elec"] = p.params.elec_pos.cpu().numpy()
        arrays[f"{pid}.class_hvs"] = hv.to_u32(p.class_hvs)
        arrays[f"{pid}.am_counts"] = p.am_state.counts.cpu().numpy()
        arrays[f"{pid}.am_n"] = p.am_state.n.cpu().numpy()
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(cfgs, f)


def load_bank(path: str) -> dict:
    from repro_torch import convert

    with open(path + ".json") as f:
        cfgs = json.load(f)
    a = np.load(path + ".npz")
    return {pid: convert.pipeline_from_arrays(
        cfg, a[f"{pid}.item"], a[f"{pid}.elec"], class_hvs=a[f"{pid}.class_hvs"],
        am_counts=a[f"{pid}.am_counts"], am_n=a[f"{pid}.am_n"], device="cpu")
        for pid, cfg in cfgs.items()}


def chunks_of(batch: np.ndarray, lens: np.ndarray) -> list:
    return [batch[i, :int(t)] for i, t in enumerate(lens)]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_fleet(spec: dict, mesh, work: str) -> None:
    """The mesh fleet on the parent's schedule against the reference's
    unsharded fleet: decisions, adapt verdicts, class rows, fill levels and
    the gathered state; then masked and faulted mesh fleets against the
    port's unsharded ones on the same schedule."""
    from repro_torch.reliability.faults import FaultConfig
    from repro_torch.serve.fleet import StreamingFleet

    bank = load_bank(os.path.join(work, "bank"))
    owners = spec["owners"]
    buckets = tuple(spec["buckets"])
    sched = np.load(os.path.join(work, "schedule.npz"))
    want = np.load(os.path.join(work, "expect.npz"))
    fleet = StreamingFleet(bank, owners, buckets=buckets, mesh=mesh)
    assert fleet.state.counts.shape[0] == int(want["rows"])
    held = fleet._state_t[0].counts.shape[0]
    assert held == spec["local_rows"], (held, spec["local_rows"])
    for i in range(int(sched["n_push"])):
        got = flat_decisions(fleet.push(chunks_of(sched[f"batch{i}"], sched[f"lens{i}"])))
        for k, v in got.items():
            np.testing.assert_array_equal(v.reshape(-1), want[f"p{i}.{k}"].reshape(-1),
                                          err_msg=f"push {i}: {k}")
        if f"labels{i}" in sched:
            np.testing.assert_array_equal(fleet.adapt(sched[f"labels{i}"]),
                                          want[f"adapt{i}"])
    np.testing.assert_array_equal(fleet.fill_levels, want["fill_levels"])
    np.testing.assert_array_equal(fleet.class_rows, want["class_rows"])
    np.testing.assert_array_equal(fleet.state.counts.numpy(), want["counts"])

    rng = np.random.default_rng(7)
    masks = (rng.random((len(owners), bank[owners[0]].cfg.channels)) > 0.3).astype(np.uint8)
    faults = FaultConfig(tables=1e-2, am=1e-2, counts=1e-2, ecc="secded", seed=3)
    for kw in ({"channel_masking": True}, {"faults": faults}):
        sharded = StreamingFleet(bank, owners, buckets=buckets, mesh=mesh, **kw)
        plain = StreamingFleet(bank, owners, buckets=buckets, tile=sharded.state.counts.shape[0],
                               **kw)
        if "channel_masking" in kw:
            for f in (sharded, plain):
                f.set_channel_mask(masks)
        for i in range(int(sched["n_push"])):
            chunks = chunks_of(sched[f"batch{i}"], sched[f"lens{i}"])
            assert_same_decisions(sharded.push(chunks), plain.push(chunks), f"{kw} push {i}")
            if i == 1 and "faults" in kw:
                for f in (sharded, plain):
                    f.set_ber(5e-2)
        np.testing.assert_array_equal(sharded.ecc_stats, plain.ecc_stats)
        np.testing.assert_array_equal(sharded.channel_masks, plain.channel_masks)
        np.testing.assert_array_equal(sharded.state.counts.numpy(),
                                      plain.state.counts.numpy())
        if "faults" in kw:
            assert sharded.ecc_stats.sum() > 0


def case_restore(spec: dict, mesh, work: str) -> None:
    """Restore ``spec["restore"]`` (saved by the reference, another mesh or
    an unsharded fleet) onto this mesh, push the next part of the schedule
    against the reference's decisions, and save to ``spec["save"]``."""
    from repro_torch.serve.fleet import StreamingFleet

    bank = load_bank(os.path.join(work, "bank"))
    sched = np.load(os.path.join(work, "schedule.npz"))
    want = np.load(os.path.join(work, "expect.npz"))
    fleet = StreamingFleet(bank, spec["owners"], buckets=tuple(spec["buckets"]), mesh=mesh)
    fleet.restore(spec["restore"])
    np.testing.assert_array_equal(fleet.fill_levels, want[f"fill{spec['part']}"])
    i = spec["part"]
    got = flat_decisions(fleet.push(chunks_of(sched[f"batch{i}"], sched[f"lens{i}"])))
    for k, v in got.items():
        np.testing.assert_array_equal(v.reshape(-1), want[f"p{i}.{k}"].reshape(-1),
                                      err_msg=f"part {i}: {k}")
    fleet.save(spec["save"], step=0)


def case_ckpt(spec: dict, mesh, work: str) -> None:
    """``ckpt.restore(shardings=)``, ``save`` of a sharded leaf and
    ``shard_to_devices`` on this mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import shard_to_devices
    from repro_torch.runtime import sharding as shd

    ctx = shd.make_ctx(mesh)
    rank, world = dist.get_rank(), dist.get_world_size()
    full = {"w": torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6),
            "b": torch.arange(5, dtype=torch.int32)}
    root = os.path.join(work, "ck")
    ckpt.save(root, 0, full)                       # every rank calls; rank 0 writes
    assert ckpt.list_steps(root) == [0]
    places = {"w": shd.sharding_for(("batch", None), ctx, (8, 6)),
              "b": torch.device("cpu")}
    like = {"w": torch.empty(8, 6, device="meta"), "b": torch.empty(5, dtype=torch.int32)}
    got = ckpt.restore(root, 0, like, shardings=places)
    assert isinstance(got["w"], DTensor) and got["w"].placements == (Shard(0),)
    np.testing.assert_array_equal(got["w"].to_local().numpy(),
                                  full["w"][rank * 8 // world:(rank + 1) * 8 // world].numpy())
    np.testing.assert_array_equal(got["w"].full_tensor().numpy(), full["w"].numpy())
    np.testing.assert_array_equal(got["b"].numpy(), full["b"].numpy())
    step, again = ckpt.restore_latest(root, like, shardings=places)
    assert step == 0 and again["w"].placements == (Shard(0),)
    # a sharded leaf saves its full array
    ckpt.save(root, 1, {"w": got["w"], "b": got["b"]})
    np.testing.assert_array_equal(ckpt.restore(root, 1, full)["w"].numpy(), full["w"].numpy())
    # a batch placed by a tree of placements and devices; None passes through
    batch = {"tokens": torch.arange(world * 3 * 4).reshape(world * 3, 4),
             "mask": torch.ones(2, 2)}
    assert shard_to_devices(batch, None) is batch
    placed = shard_to_devices(batch, {"tokens": shd.sharding_for(("batch", None), ctx),
                                      "mask": None})
    np.testing.assert_array_equal(placed["tokens"].to_local().numpy(),
                                  batch["tokens"][rank * 3:(rank + 1) * 3].numpy())
    assert placed["mask"] is batch["mask"]
    rep = shd.constrain(placed["tokens"], (None, None), ctx)
    assert rep.placements == (Replicate(),)
    np.testing.assert_array_equal(rep.to_local().numpy(), batch["tokens"].numpy())


CASES = {"fleet": case_fleet, "restore": case_restore, "ckpt": case_ckpt}


def spawn(case: str, spec: dict, group: str, timeout: float = 180) -> None:
    """Run ``case`` on ``prod(spec["mesh"])`` ranks, one process each (the
    parent's side); raises with every failing rank's output."""
    import math
    import subprocess

    os.makedirs(group, exist_ok=True)
    with open(os.path.join(group, "spec.json"), "w") as f:
        json.dump(spec, f)
    world = math.prod(spec["mesh"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), group], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    failed = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("\n".join(failed))


def main(argv: list[str]) -> int:
    case, rank, world, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    data = spec.get("data", work)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh(tuple(spec["mesh"]), tuple(spec["axes"]), device="cpu")
        CASES[case](spec, mesh, data)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
