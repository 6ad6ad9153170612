"""One rank of a CPU mesh for ``tests/test_torch_mesh.py``,
``tests/test_torch_fleet_mesh.py`` and ``tests/test_torch_lm_mesh*.py``
(not a test module: pytest does not collect it).

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


# ---------------------------------------------------------------------------
# the LM on a mesh (tests/test_torch_lm_mesh*.py; the reference's answers
# from tests/lm_mesh_cases.py)
# ---------------------------------------------------------------------------

GRAD_TOL = 1e-4      # a gradient leaf: of its largest |value|
STEP_TOL = 1e-2      # a parameter after a step: of its leaf's largest |update|
LOSS_RTOL = 1e-5
FLIP_SHARE, FLIP_TOL = 1e-3, 0.5   # grad_compress: int8 rounding flips (_lm_train)
TIE = (1e-5, 1e-3)   # a routed id may differ where the reference's top-k margin
#                      is below 1e-5, on at most 1e-3 of the routed slots
LM_OPT = dict(warmup_steps=1, total_steps=10, eps=1e-4)


def _tree_of(a, prefix: str) -> dict:
    tree: dict = {}
    for key in a.files:
        if not key.startswith(prefix + "."):
            continue
        node = tree
        *head, last = key[len(prefix) + 1:].split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = a[key]
    return tree


def _full(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


def _local_shape(x) -> tuple:
    from torch.distributed.tensor import DTensor

    return tuple((x.to_local() if isinstance(x, DTensor) else x).shape)


def _check_local_shapes(tree, a, prefix: str, what: str) -> int:
    """Every leaf's local shape equals the reference rules' (``prefix``
    keys of ``a``); -> the number of leaves that are split."""
    from repro_torch.models.params import flatten

    split = 0
    for k, leaf in flatten(tree).items():
        want = tuple(int(n) for n in a[f"{prefix}.{k}"])
        got = _local_shape(leaf)
        assert got == want, f"{what} {k}: local {got}, the rules {want}"
        split += got != tuple(leaf.shape)
    return split


def _leaf_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, what: str, cache: bool = False) -> None:
    got, want = _full(got), np.asarray(want, np.float32)
    rtol, atol = (1e-3, 2e-4) if what.endswith("ssm") else (1e-4, 1e-4)
    if cache:
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _lm_train(case, tc, tree, a, mesh, tag: str) -> None:
    """Loss, gradients and two AdamW steps on the mesh against the
    reference; the parameters', gradients' and moments' local shapes."""
    from repro_torch import convert
    from repro_torch.data.pipeline import shard_to_devices
    from repro_torch.models.params import flatten
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime import steps

    batch = {k: torch.from_numpy(v) for k, v in _tree_of(a, "tb").items()}
    opt = adamw.OptConfig(**LM_OPT)
    step, ctx, _ = steps.jit_train_step(tc, opt, mesh, batch,
                                        grad_compress=case["grad_compress"])
    p = convert.lm_params_from_reference(tc, tree, device="cpu").place(ctx).params()
    split = _check_local_shapes(p, a, f"ls.{tag}", "parameter")
    assert split > 0, "no parameter is split on this mesh"
    loss, metrics, grads = steps._value_and_grad(
        p, shard_to_devices(batch, steps.batch_shardings(batch, ctx)), tc, ctx)
    np.testing.assert_allclose(_full(loss), a["loss"], rtol=LOSS_RTOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(_full(metrics[k]), a[k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    _check_local_shapes(grads, a, f"ls.{tag}", "gradient")
    for k, g in flatten(grads).items():
        got, want, w64 = _full(g), a[f"g.{k}"], a[f"g64.{k}"]
        err = _leaf_err(got, want)
        if err > GRAD_TOL:
            # float32 itself is that far off here: the mesh's float32 stands
            # at most twice as far from a float64 run as the reference's
            assert _leaf_err(got, w64) <= 2 * _leaf_err(want, w64), (k, err)
    state = adamw.init_state(p, opt, device="cpu")
    extra = (compress.init_residual(p),) if case["grad_compress"] else ()
    p0 = {k: a[f"w.{k}"] for k in flatten(p)}
    for i in range(2):
        out = step(p, state, batch, *extra)
        if case["grad_compress"]:
            p, state, res, loss, met = out
            extra = (res,)
            _check_local_shapes(res, a, f"ls.{tag}", "residual")
        else:
            p, state, loss, met = out
        np.testing.assert_allclose(_full(loss), a[f"s{i}.loss"], rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
        for k in ("xent", "aux", "grad_norm", "lr"):
            rtol = GRAD_TOL * (1 + 9 * i) if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(_full(met[k]), a[f"s{i}.{k}"], rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        for k, got in flatten(p).items():
            want = a[f"p{i}.{k}"]
            update = np.abs(want - p0[k]).max()
            err = np.abs(_full(got) - want)
            bound = STEP_TOL * max(update, 1e-12)
            if case["grad_compress"]:
                # the int8 round trip rounds g / scale half to even: a rounding
                # of the sharded sums moves an element across a rounding
                # boundary, one quantum in its gradient, a share of its update
                flips = int((err > bound).sum())
                assert flips <= max(1, FLIP_SHARE * err.size), (i, k, flips, err.size)
                assert err.max() <= FLIP_TOL * max(update, 1e-12), (i, k, err.max(), update)
            else:
                assert err.max() <= bound, (i, k, err.max(), update)
        for part in ("m", "v"):
            _check_local_shapes(state[part], a, f"ls.{tag}", f"moment {part}")
    assert int(_full(state["step"])) == 2


def _lm_serve(case, tc, tree, a, mesh, tag: str, seq_sharded_kv: bool) -> None:
    """Prefill and 8 greedy decode steps on the mesh, fed the reference's
    tokens: every step's logits, the greedy tokens, the caches after
    prefill and after the last step with their local shapes, and the
    routed expert ids (near-ties counted)."""
    from repro_torch import convert
    from repro_torch.models import moe
    from repro_torch.models.params import flatten
    from repro_torch.runtime import steps

    sb = {k: torch.from_numpy(v) for k, v in _tree_of(a, "sb").items()}
    seq = sb["tokens"].shape[1] + (tc.num_media_tokens if tc.family == "vlm" else 0)
    gen = sum(1 for k in a.files if k.startswith("tok")) - 1
    prefill, ctx, _ = steps.jit_prefill(tc, mesh, sb, seq + gen,
                                        seq_sharded_kv=seq_sharded_kv)
    p = convert.lm_params_from_reference(tc, tree, device="cpu").place(ctx).params()
    routed: list = []
    orig = moe._route

    def route(params_, xf, cfg):
        out = orig(params_, xf, cfg)
        routed.append(_full(out[1]).astype(np.int64))
        return out

    moe._route = route
    try:
        logits, caches = prefill(p, sb)
        _close(logits, a["logits0"], "prefill logits")
        for k, c in flatten(caches).items():
            _close(c, a[f"pc.{k}"], f"prefill cache {k}", cache=True)
        tok = torch.from_numpy(a["tok0"])
        decode, _, _ = steps.jit_decode_step(tc, mesh, {"tokens": tok, "caches": caches},
                                             seq_sharded_kv=seq_sharded_kv)
        for i in range(gen):
            np.testing.assert_array_equal(_full(logits).argmax(-1), a[f"tok{i}"][:, 0],
                                          err_msg=f"greedy token {i}")
            logits, caches = decode(p, torch.from_numpy(a[f"tok{i}"]), caches, seq + i)
            _close(logits, a[f"logits{i + 1}"], f"logits of step {i}")
        np.testing.assert_array_equal(_full(logits).argmax(-1), a[f"tok{gen}"][:, 0])
    finally:
        moe._route = orig
    for k, c in flatten(caches).items():
        _close(c, a[f"c.{k}"], f"cache {k}", cache=True)
    split = _check_local_shapes(caches, a, f"lc.{tag}.{int(seq_sharded_kv)}", "cache")
    assert split > 0, "no cache is split on this mesh"
    assert len(routed) == case["routed"], (len(routed), case["routed"])
    slots = flips = 0
    for i, got in enumerate(routed):
        want, margin = a[f"ids{i}"], a[f"margin{i}"]
        differ = (got != want).any(axis=1)
        assert not differ.any() or margin[differ].max() < TIE[0], (i, margin[differ])
        slots += want.size
        flips += int((got != want).sum())
    assert flips <= TIE[1] * max(slots, 1), (flips, slots)


def case_scan(spec: dict, mesh, work: str) -> None:
    """The selective scan's chunk (``mamba._on_shards`` of the train and
    the prefill chunk) on its (batch, d_inner) shards: no collective under
    ``CommDebugMode``, and each rank's block equal bit for bit to the same
    block of the unsharded chunk."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import mamba
    from repro_torch.runtime import sharding as shd

    ctx = shd.make_ctx(mesh)
    g = torch.Generator().manual_seed(0)
    b, q, di, st = 2, 16, 8, 4
    da = torch.rand(b, q, di, st, generator=g)
    dbx = torch.randn(b, q, di, st, generator=g)
    c = torch.randn(b, q, st, generator=g)
    h0 = torch.randn(b, di, st, generator=g)
    for core in (mamba._chunk_train, mamba._chunk_prefill):
        want = core(da.clone(), dbx.clone(), c, h0)
        args = [shd.constrain(t.clone(), axes, ctx) for t, axes in
                ((da, ("batch", None, "tp", None)), (dbx, ("batch", None, "tp", None)),
                 (c, ("batch", None, None)), (h0, ("batch", "tp", None)))]
        with CommDebugMode() as comm:
            got = mamba._on_shards(core, ctx, *args)
        assert comm.get_total_counts() == 0, comm.get_comm_counts()
        for gt, wt in zip(got, want):
            assert gt.placements == shd.placements(
                ("batch", "tp", None) if gt.dim() == 3 and gt.shape[1] == di
                else ("batch", None, "tp"), ctx, tuple(gt.shape))
            np.testing.assert_array_equal(gt.full_tensor().numpy(), wt.numpy())


def case_moe_local_index(spec: dict, mesh, work: str) -> None:
    """``moe_layer`` with ``local_index`` on this mesh against the parent's
    unsharded run at ``n_dp`` = the batch axes' size: output and
    load-balance loss (``rtol=2e-4, atol=2e-5``, ``test_torch_lm.py``'s
    MoE tolerance), each rank holding its batch rows."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    from repro_torch.runtime import sharding as shd

    a = np.load(os.path.join(work, "moe.npz"))
    cfg = registry.get_config("deepseek-moe-16b").reduced(**spec["overrides"])
    ctx = shd.make_ctx(mesh)
    w = shd.tree_shardings(moe.moe_spec(cfg), ctx)
    tree = {k[2:]: a[k] for k in a.files if k.startswith("w.")}
    nested: dict = {}
    for k, v in tree.items():
        node = nested
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(v)
    from repro_torch.models.params import tree_map

    p = tree_map(shd.place, nested, w)
    x = shd.constrain(torch.from_numpy(a["x"]), ("batch", None, None), ctx)
    with shd.replicated(ctx):
        out, aux = moe.moe_layer(p, x, cfg, ctx)
    assert _local_shape(out)[0] == a["x"].shape[0] // spec["n_dp"]
    np.testing.assert_allclose(_full(out), a["out"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_full(aux), a["aux"], rtol=2e-4)


def case_dryrun(spec: dict, mesh, work: str) -> None:
    """The dry-run's cells traced on this real mesh with real tensors
    (``launch/dryrun.py::trace_cell(real=True)``) under the op counter;
    rank 0 writes the counts to ``work/dryrun.json`` for the parent to hold
    against the same cells traced on a fake world of as many ranks."""
    from repro_torch.configs import registry
    from repro_torch.data import lm as lmdata
    from repro_torch.launch import dryrun

    cfg = registry.get_config(spec["arch"]).reduced(**spec["overrides"])
    out = {}
    for kind in spec["kinds"]:
        shape = lmdata.ShapeSpec(kind, spec["seq"], spec["batch"], kind)
        r = dryrun.trace_cell(cfg, shape, mesh, device="cpu", real=True,
                              seq_sharded_kv=False)
        out[kind] = {k: r[k] for k in ("cost", "collectives", "memory")}
    if dist.get_rank() == 0:
        with open(os.path.join(work, "dryrun.json"), "w") as f:
            json.dump(out, f)


def case_lm(spec: dict, mesh, work: str) -> None:
    """Each family of ``spec["cases"]`` on this mesh against the unsharded
    reference: training (loss, gradients, two steps) and serving (prefill,
    8 greedy steps; with ``seq_sharded_kv`` also under those rules)."""
    from repro_torch.configs import registry

    tag = "x".join(map(str, spec["mesh"]))
    for case in spec["cases"]:
        arch = case["arch"]
        tc = registry.get_config(arch).reduced(attn_kv_chunk=8, **case["overrides"])
        a = np.load(os.path.join(work, f"{case['name']}.npz"))
        tree = _tree_of(a, "w")
        _lm_train(case, tc, tree, a, mesh, tag)
        _lm_serve(case, tc, tree, a, mesh, tag, False)
        if case["seq_sharded_kv"]:
            _lm_serve(case, tc, tree, a, mesh, tag, True)


CASES = {"fleet": case_fleet, "restore": case_restore, "ckpt": case_ckpt, "lm": case_lm,
         "moe_local_index": case_moe_local_index, "scan": case_scan, "dryrun": case_dryrun}


def spawn(case: str, spec: dict, group: str, timeout: float = 180) -> None:
    """Run ``case`` on ``prod(spec["mesh"])`` ranks, one process each (the
    parent's side); raises with every failing rank's output."""
    spawn_all([(case, spec, group)], timeout)


def spawn_all(runs: list, timeout: float = 180) -> None:
    """``spawn`` of several (case, spec, group) at once, each its own
    group of ranks; raises with every failing rank's output."""
    import math
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    procs = []
    for case, spec, group in runs:
        os.makedirs(group, exist_ok=True)
        with open(os.path.join(group, "spec.json"), "w") as f:
            json.dump(spec, f)
        world = math.prod(spec["mesh"])
        procs += [(f"{group} rank {r}", subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world), group],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for r in range(world)]
    failed = []
    try:
        for name, p in procs:
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failed.append(f"{name} exited {p.returncode}:\n{out[-4000:]}")
    finally:
        for _, p in procs:
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
