"""Training launcher with fault tolerance (port of ``repro.launch.train``).

* **Checkpoint/restart**: asynchronous checkpoints every ``--ckpt-every``
  steps (``ckpt/checkpoint.py``: the tree is copied to host memory on the
  loop's thread, written on a background thread, renamed into place when
  whole); on (re)start the launcher restores the latest complete
  checkpoint and resumes at its step.  A batch is a pure function of the
  step (``data/lm.py:batch_for_step`` on the run's device), so a restart
  at step k draws the same batches.
* **Watchdog**: a step slower than ``--step-timeout-s`` aborts the attempt;
  an aborted attempt restarts from the latest checkpoint, at most
  ``--max-restarts`` times.  ``--fail-at`` injects one failure.
* ``--fresh`` starts at step 0 and deletes the checkpoints already in
  ``--ckpt-dir``; a restart then resumes from what this run saved.  (The
  reference's ``--fresh`` keeps the old checkpoints, and its restarts skip
  the restore too, so they begin again at step 0.)
* **Gradient compression**: ``--grad-compress`` runs the int8
  error-feedback round trip (``optim/compress.py``) before the update.
* **Elastic scaling**: ``--mesh`` (``1x2``, ``2x2`` ... ``2x16x16``) trains
  over a mesh of the ``torch.distributed.run`` ranks, one process a card:
  the weights and the AdamW state placed by ``tree_shardings``, each batch
  by ``batch_shardings`` (``runtime/steps.py::jit_train_step``).  A
  checkpoint holds full arrays, so a restart restores it onto whatever
  mesh it has (``ckpt.restore(shardings=)``: 1x2 to 2x1).  Rank 0 prints
  and writes the checkpoints.

``--device cpu`` runs the plain path on the CPU (the tests use it; with
``--mesh``, the ranks over gloo); without it the run takes the CUDA card
(each rank ``cuda:{LOCAL_RANK}``) and raises without one.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 20 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 5 --batch 4 --seq 512
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch qwen3-0.6b --reduced --device cpu \\
      --mesh 1x2 --steps 8 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import torch
import torch.distributed as dist


MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(s: str | None, device=None):
    """``"4"``, ``"2x2"`` or ``"2x16x16"`` -> a mesh with axes ``data``,
    ``data``/``model`` or ``pod``/``data``/``model`` (``launch/mesh.py``);
    ``None`` or ``"none"`` -> None."""
    if not s or s == "none":
        return None
    from repro_torch.launch.mesh import make_mesh

    dims = tuple(int(x) for x in s.split("x"))
    if len(dims) not in MESH_AXES:
        raise ValueError(f"--mesh {s!r}: want 1 to 3 sizes joined by 'x'")
    return make_mesh(dims, MESH_AXES[len(dims)], device=device)


def say(*parts, **kw) -> None:
    """``print`` on rank 0 only (every rank of a mesh runs the loop)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*parts, **kw)


def train_loop(args) -> dict:
    """The reference's ``train_loop``: on ``--mesh``, over the process
    group ``parse_mesh`` joins (or makes); ``main`` destroys it."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.models import params as pmod
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps as steps_mod

    mesh = parse_mesh(args.mesh, device=args.device)
    dev = mesh_device(mesh) if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = lmdata.ShapeSpec("train", args.seq, args.batch, "train")
    opt = adamw.OptConfig(total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                          accum_steps=args.accum, state_dtype=args.opt_dtype)
    batch0 = lmdata.input_specs(cfg, shape)
    step_fn, ctx, spec = steps_mod.jit_train_step(cfg, opt, mesh, batch0,
                                                  grad_compress=args.grad_compress)
    p_shard = shd.tree_shardings(spec, ctx)
    params = pmod.initialize(torch.Generator(device=dev).manual_seed(args.seed),
                             spec, getattr(torch, cfg.dtype), dev)
    if mesh is not None:
        params = pmod.tree_map(shd.place, params, p_shard)
    opt_state = adamw.init_state(params, opt, device=dev)
    residual = compress.init_residual(params) if args.grad_compress else None

    start_step = 0
    ckptr = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckptr and args.fresh:
        if not dist.is_initialized() or dist.get_rank() == 0:
            for s in ckpt.list_steps(args.ckpt_dir):
                shutil.rmtree(os.path.join(args.ckpt_dir, f"step_{s:08d}"))
        if dist.is_initialized():
            dist.all_reduce(torch.zeros(1))   # every rank past the deletion
    elif ckptr:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            like = {"params": params, "m": opt_state["m"], "v": opt_state["v"],
                    "step": opt_state["step"]}
            where = None
            if mesh is not None:    # onto this run's mesh, whatever saved it
                where = {"params": p_shard, "m": p_shard, "v": p_shard,
                         "step": shd.sharding_for((), ctx, ())}
            restored = ckpt.restore(args.ckpt_dir, latest, like, shardings=where)
            params = restored["params"]
            opt_state = {"m": restored["m"], "v": restored["v"], "step": restored["step"]}
            start_step = latest
            say(f"[resume] restored step {latest} from {args.ckpt_dir}")

    losses = []
    t_start = time.time()
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = lmdata.batch_for_step(cfg, shape, step, device=dev)
            if args.fail_at is not None and step == args.fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            if args.grad_compress:
                params, opt_state, residual, loss, metrics = step_fn(
                    params, opt_state, batch, residual)
            else:
                params, opt_state, loss, metrics = step_fn(params, opt_state, batch)
            loss = float(loss)
            dt = time.time() - t0
            if dt > args.step_timeout_s:
                raise TimeoutError(f"step {step} took {dt:.1f}s > {args.step_timeout_s}s "
                                   "(straggler watchdog)")
            losses.append(loss)
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:.4f} gnorm "
                    f"{float(metrics['grad_norm']):.3f} ({dt*1e3:.0f} ms)")
            if ckptr and (step + 1) % args.ckpt_every == 0:
                ckptr.save_async(step + 1, {"params": params, "m": opt_state["m"],
                                            "v": opt_state["v"], "step": opt_state["step"]})
    finally:
        # an attempt that fails still lands its checkpoint in flight, so
        # the restart resumes from it and not from the one before
        if ckptr:
            ckptr.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "steps": args.steps - start_step,
            "wall_s": time.time() - t_start}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="train over a mesh of the torch.distributed.run ranks: "
                         "'2', '1x2' or '2x16x16' (axes data, data/model, "
                         "pod/data/model)")
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the CUDA card; 'cpu' runs "
                         "the plain path)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--step-timeout-s", type=float, default=3600.0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure (fault-tolerance tests)")
    ap.add_argument("--max-restarts", type=int, default=2)
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    resolve_device(args.device)   # without a card, raise before any attempt
    try:
        # supervisor: restart from the latest checkpoint on failure
        for attempt in range(args.max_restarts + 1):
            try:
                out = train_loop(args)
                say(f"done: final_loss={out['final_loss']:.4f} "
                    f"wall={out['wall_s']:.1f}s")
                return
            except (RuntimeError, TimeoutError) as e:
                say(f"[watchdog] attempt {attempt} failed: {e}")
                if attempt == args.max_restarts or not args.ckpt_dir:
                    raise
                args.fail_at = None   # injected failures fire once
                args.fresh = False    # a restart resumes from this run's checkpoints
                say("[watchdog] restarting from latest checkpoint...")
    finally:
        if dist.is_initialized():   # a --mesh run's group
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
