"""Serving launcher: the LM zoo's prefill and greedy decode loop, or the
HDC streaming fleet (port of ``repro.launch.serve``).

LM zoo (every registered config; weights drawn from a seed; an audio
model's encoder is fed random frames):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --batch 2 --prompt-len 128 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --reduced --device cpu

Serve a fleet on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --hdc-fleet \
      --sessions 256 --patients 8 --rounds 4

Deploy flow, build once and start many: ``compile`` writes a versioned
artifact holding the built kernel library (``runtime/aot.py``); a later
``--hdc-fleet --aot-dir`` loads the library from it (no ``nvcc``) and warms
the fleet, capturing each step as a CUDA graph before the first push.  A
stale artifact (other torch or CUDA, card or kernel sources) warns and
builds from the sources:
  PYTHONPATH=src python -m repro_torch.launch.serve compile --aot-dir /tmp/aot \
      --sessions 256 --patients 8
  PYTHONPATH=src python -m repro_torch.launch.serve --hdc-fleet \
      --aot-dir /tmp/aot --sessions 256 --patients 8 --rounds 4

Durable adaptive fleet: ``--adapt-every N`` runs one fleet-wide online
update every N rounds; ``--ckpt-dir`` saves the fleet after the run (and
every ``--ckpt-every`` rounds), ``--resume`` restores the latest checkpoint
and continues mid-stream.  SIGTERM or SIGINT finishes the round, writes one
checkpoint and exits 0.  ``--channel-health`` runs the electrode-health
monitor (``reliability/channels.py``) over every round's codes and feeds
its masks to a masked fleet; ``--inject-fault CH:KIND`` faults a channel
of every stream.

``--device cpu`` runs the plain PyTorch path on the CPU (the tests use
it); ``compile`` then exits, since a CPU fleet has no kernel library to
ship.

A fleet over several cards, one process a card (an SPMD mesh fleet:
``serve/fleet.py``; rank 0 prints):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --hdc-fleet --mesh 4 --sessions 1024
``--mesh`` with ``--device cpu`` runs the ranks on the CPU over gloo.
``compile --mesh`` is refused (the deploy artifact warms one process's
tiles).

An LM over a mesh of ranks (the weights placed by ``tree_shardings``, the
prompt by ``batch_shardings``, the caches by ``cache_shardings``;
``--seq-sharded-kv`` shards the caches' sequence over the data axes
instead of the batch; rank 0 prints):
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch qwen3-0.6b --reduced --device cpu \
      --mesh 2 --seq-sharded-kv
"""

from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch


class _GracefulStop:
    """SIGTERM/SIGINT -> finish the in-flight round, write one final atomic
    checkpoint, exit 0.  The flag is read only at round boundaries, so the
    checkpoint the next worker resumes from is always a whole round."""

    def __init__(self):
        self.signum: int | None = None
        self._old: dict[int, object] = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            signal.signal(sig, old)
        return False

    def _handle(self, signum, frame):
        if self.signum is not None:  # second signal: give up immediately
            raise KeyboardInterrupt
        self.signum = signum

    @property
    def requested(self) -> bool:
        return self.signum is not None

    @property
    def name(self) -> str:
        return signal.Signals(self.signum).name if self.signum else ""


def say(*parts, **kw) -> None:
    """``print`` on rank 0 only (every rank of a mesh fleet runs the loop)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*parts, **kw)


def _build_hdc_fleet(args):
    """Train a small synthetic per-patient bank and assemble the fleet (the
    reference's bank recipe, codebooks drawn by torch); ``--mesh`` shards
    it over the ranks of ``torch.distributed.run``."""
    from repro_torch.core.pipeline import HDCConfig, HDCPipeline
    from repro_torch.launch.train import parse_mesh
    from repro_torch.serve.fleet import StreamingFleet

    mesh = parse_mesh(args.mesh, device=args.device)  # sets this rank's card
    cfg = HDCConfig(variant=args.variant)
    rng = np.random.default_rng(0)

    def trained(seed: int) -> HDCPipeline:
        codes = rng.integers(0, cfg.codes, (1, 4 * cfg.window, cfg.channels),
                             np.uint8)
        labels = np.asarray(rng.integers(0, 2, (1, 4), np.int32))
        labels[0, :2] = (0, 1)  # every class needs >= 1 example
        pipe = HDCPipeline.init(torch.Generator().manual_seed(seed), cfg,
                                device=args.device)
        # per-patient calibrated operating point (the programmed register)
        pipe = pipe.calibrate_density(codes, target=0.2 + 0.05 * (seed % 4))
        return pipe.train_one_shot(codes, labels)

    t0 = time.perf_counter()
    bank = {f"patient{p}": trained(p) for p in range(args.patients)}
    owners = [f"patient{i % args.patients}" for i in range(args.sessions)]
    fleet = StreamingFleet(bank, owners, channel_masking=args.channel_health,
                           mesh=mesh)
    where = ("single device" if mesh is None else
             f"mesh {'x'.join(map(str, mesh.shape))} ({', '.join(mesh.mesh_dim_names)})")
    say(f"fleet: {args.sessions} sessions over {args.patients} patients "
        f"({where}), built in {time.perf_counter() - t0:.1f} s")
    return fleet, cfg, rng


def _load_artifact(args):
    """The --aot-dir artifact, key-checked (None with a warning when
    stale); on the card its kernel library (or the usual build) is loaded
    before the bank trains."""
    from repro_torch.device import resolve_device
    from repro_torch.runtime import aot as aot_mod

    art = aot_mod.load_artifact(args.aot_dir, device=args.device)
    if resolve_device(args.device).type == "cuda":
        aot_mod.load_library(art)
    return art


def _kernel_line() -> str:
    from repro_torch.kernels import build

    return (f"kernel library: {len(build.BUILD_LOG)} nvcc build(s), "
            f"{len(build.LOAD_LOG)} load(s)"
            + (f" from {build.LOAD_LOG[-1]}" if build.LOAD_LOG else ""))


def run_hdc_compile(args) -> None:
    """``compile``: write the --aot-dir deploy artifact (the built kernel
    library and the fleet's entry names), so ``--hdc-fleet --aot-dir``
    workers start without ``nvcc``."""
    from repro_torch.device import resolve_device

    if not args.aot_dir:
        raise SystemExit("compile mode needs --aot-dir <artifact directory>")
    if args.mesh:
        raise SystemExit("compile mode writes one process's deploy artifact; "
                         "drop --mesh")
    if resolve_device(args.device).type != "cuda":
        raise SystemExit("compile ships the CUDA kernel library, and a CPU "
                         "fleet (--device cpu) has none: no artifact written")
    fleet, _, _ = _build_hdc_fleet(args)
    t0 = time.perf_counter()
    manifest = fleet.save_aot(args.aot_dir)
    dt = time.perf_counter() - t0
    print(f"AOT artifact -> {args.aot_dir}: {len(manifest['entries'])} "
          f"entries in {dt:.1f} s (key: {manifest['key']})")
    for e in manifest["entries"]:
        print(f"  {e['name']}  kind={e['kind']} library={manifest['library']}")
    print(_kernel_line())


def run_hdc_fleet(args, t_start: float) -> None:
    """Stream a fleet; --aot-dir warms it from a deploy artifact first."""
    art = _load_artifact(args) if args.aot_dir else None
    fleet, cfg, rng = _build_hdc_fleet(args)

    t0 = time.perf_counter()
    if args.aot_dir:
        stats = fleet.warmup(aot=art)
        say(f"warmup from {args.aot_dir}: {stats['loaded']} loaded, "
              f"{stats['compiled']} compiled in "
              f"{time.perf_counter() - t0:.2f} s"
              + ("" if art is not None else "  [stale artifact: built from sources]"))

    chunk_len = args.chunk or cfg.window
    chunks = [rng.integers(0, cfg.codes, (chunk_len, cfg.channels), np.uint8)
              for _ in range(args.sessions)]
    if args.inject_fault:
        from repro_torch.reliability import channels as chan_mod

        frng = np.random.default_rng(1)
        for spec in args.inject_fault:
            ch_s, _, kind = spec.partition(":")
            try:
                ch = int(ch_s)
            except ValueError:
                raise SystemExit(f"--inject-fault {spec!r}: want CH:KIND")
            if kind not in chan_mod.CODE_FAULT_TYPES:
                raise SystemExit(
                    f"--inject-fault kind {kind!r} must be one of "
                    f"{chan_mod.CODE_FAULT_TYPES}")
            if not 0 <= ch < cfg.channels:
                raise SystemExit(
                    f"--inject-fault channel {ch} outside "
                    f"[0, {cfg.channels})")
            chunks = [chan_mod.inject_code_fault(c, ch, kind, frng)
                      for c in chunks]
            say(f"injected {kind} fault on channel {ch} "
                  f"(all {args.sessions} sessions)")
    monitor = None
    if args.channel_health:
        from repro_torch.reliability.channels import FleetChannelMonitor

        monitor = FleetChannelMonitor(args.sessions, cfg.channels)
    fleet.push(chunks)  # the first push: eager shapes run here when not warmed
    say(f"first decision: {time.perf_counter() - t_start:.2f} s after start "
          f"({_kernel_line()})")

    # restore AFTER the first push: restore overwrites the fleet state, so
    # the first round never leaks into the resumed stream
    if args.resume and args.ckpt_dir:
        from repro_torch.ckpt import checkpoint as ckpt
        if ckpt.latest_step(args.ckpt_dir) is not None:
            step = fleet.restore(args.ckpt_dir)
            say(f"resumed fleet from {args.ckpt_dir} step {step} "
                  f"(frames so far: {int(fleet.frame_indices.sum())})")
        else:
            say(f"--resume: no checkpoint under {args.ckpt_dir}, cold start")
    decisions = 0
    adapted = 0
    rounds_done = 0
    t0 = time.perf_counter()
    with _GracefulStop() as stopper:
        for r in range(args.rounds):
            if stopper.requested:
                break
            out = fleet.push(chunks)
            decisions += sum(len(o) for o in out)
            rounds_done = r + 1
            if monitor is not None:
                masks = monitor.observe(np.stack(chunks))
                if not np.array_equal(masks, fleet.channel_masks):
                    fleet.set_channel_mask(masks)
            if args.adapt_every and (r + 1) % args.adapt_every == 0:
                # synthetic feedback: label each session's last frame at random
                labels = np.where([len(o) > 0 for o in out],
                                  rng.integers(0, cfg.n_classes, args.sessions),
                                  -1)
                adapted += int(fleet.adapt(labels).sum())
            if (args.ckpt_dir and args.ckpt_every
                    and (r + 1) % args.ckpt_every == 0):
                fleet.save(args.ckpt_dir)
    dt = time.perf_counter() - t0
    rate = args.sessions * rounds_done / max(dt, 1e-9)
    say(f"stream: {rounds_done} rounds x {chunk_len} cycles in {dt * 1e3:.1f} ms "
          f"({rate:.0f} session-chunks/s, {decisions} decisions, "
          f"{dt * 1e6 / max(decisions, 1):.1f} us/decision)")
    if args.adapt_every:
        say(f"online adaptation: {adapted} gated AM updates across the fleet")
    if monitor is not None:
        ev = monitor.events
        say(f"channel health: {monitor.n_quarantined} channel(s) "
              f"quarantined across the fleet ({len(ev)} events)")
        for e in ev[:20]:
            say(f"  round {e['block']} session {e['session']} "
                  f"ch {e['channel']}: {e['event']} "
                  f"(entropy {e['entropy']:.2f} bits, "
                  f"run {e['stuck_run']})")
        if len(ev) > 20:
            say(f"  ... {len(ev) - 20} more event(s)")
    say(f"compiled step executables: {fleet.compile_count} "
          f"(buckets: {fleet._buckets})")
    if args.ckpt_dir:
        path = fleet.save(args.ckpt_dir)
        say(f"saved fleet checkpoint -> {path}")
    if stopper.requested:
        # the final atomic checkpoint above is the shutdown contract; exit
        # clean so supervisors treat this as a graceful drain, not a crash
        say(f"caught {stopper.name}: checkpointed after round "
              f"{rounds_done}, exiting 0")
        raise SystemExit(0)


def run_lm(args) -> None:
    """Prefill a synthetic prompt, then decode ``--gen - 1`` greedy tokens
    after the first, printing the prefill time, the decode time and rate,
    and the generated token ids (the reference's ``run_lm``).  With
    ``--mesh`` every rank runs it (``jit_prefill``/``jit_decode_step``
    place the weights, the prompt and the caches) and rank 0 prints."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models.model import LanguageModel
    from repro_torch.runtime import steps as steps_mod

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = parse_mesh(args.mesh, device=args.device)  # sets this rank's card
    dev = mesh_device(mesh) if mesh is not None else resolve_device(args.device)
    cache_seq = args.prompt_len + args.gen
    shape = lmdata.ShapeSpec("serve", args.prompt_len, args.batch, "prefill")
    batch = lmdata.synth_batch(torch.Generator(device=dev).manual_seed(0), cfg, shape)
    prefill_fn, ctx, _ = steps_mod.jit_prefill(cfg, mesh, batch, cache_seq,
                                               seq_sharded_kv=args.seq_sharded_kv)
    model = LanguageModel.init(torch.Generator(device=dev).manual_seed(1), cfg, device=dev,
                               ctx=ctx)
    params = model.params()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def greedy(logits):
        # the pick reads the whole vocabulary row: a tp-sharded row is gathered
        if hasattr(logits, "full_tensor"):
            logits = logits.full_tensor()
        return logits.argmax(-1)[:, None].to(torch.int32)

    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    say(f"prefill: {args.batch} x {args.prompt_len} tokens in "
        f"{t_prefill * 1e3:.1f} ms")

    n_media = cfg.num_media_tokens if cfg.family == "vlm" else 0
    pos0 = batch["tokens"].shape[1] + n_media
    tok = greedy(logits)
    decode_fn, _, _ = steps_mod.jit_decode_step(cfg, mesh, {"tokens": tok, "caches": caches},
                                                seq_sharded_kv=args.seq_sharded_kv)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, caches = decode_fn(params, tok, caches, pos0 + i)
        tok = greedy(logits)
        out_tokens.append(tok)
    sync()
    t_dec = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu()
    say(f"decode: {args.gen - 1} steps in {t_dec * 1e3:.1f} ms "
        f"({(args.gen - 1) * args.batch / max(t_dec, 1e-9):.1f} tok/s)")
    say("generated token ids (greedy):")
    for b in range(min(args.batch, 4)):
        say(f"  [{b}] {gen[b].tolist()}")


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("command", nargs="?", default="serve",
                    choices=["serve", "compile"],
                    help="serve (default) or compile: write the --aot-dir "
                         "deploy artifact for the HDC fleet and exit")
    ap.add_argument("--arch", default=None,
                    help="LM zoo architecture to serve (any registered "
                         "config)")
    ap.add_argument("--reduced", action="store_true",
                    help="with --arch: the config's small same-family copy")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default=None,
                    help="shard the fleet (--hdc-fleet) or the LM (--arch) over a "
                         "mesh of the torch.distributed.run ranks ('4', '2x2' or "
                         "'2x2x2'; axes data, data/model, pod/data/model)")
    ap.add_argument("--seq-sharded-kv", action="store_true",
                    help="with --arch --mesh: shard the caches' sequence over the "
                         "data axes (batch unsharded), for long prompts at small "
                         "batches")
    ap.add_argument("--hdc-fleet", action="store_true",
                    help="serve the HDC seizure-detection streaming fleet")
    ap.add_argument("--device", default=None,
                    help="torch device of the model, or of the bank and fleet "
                         "(default: the CUDA card; 'cpu' runs the plain path)")
    ap.add_argument("--sessions", type=int, default=64)
    ap.add_argument("--patients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=None,
                    help="cycles per session per round (default: one window)")
    ap.add_argument("--variant", default="sparse_compim",
                    choices=["sparse_naive", "sparse_compim", "dense"])
    ap.add_argument("--channel-health", action="store_true",
                    help="build the fleet with channel masking and run the "
                         "online electrode-health monitor: channels whose "
                         "LBP code statistics collapse are quarantined out "
                         "of the spatial encoder and reinstated with "
                         "hysteresis")
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="CH:KIND",
                    help="inject a code-level electrode fault into channel "
                         "CH of every session's stream (KIND: dead, "
                         "saturated, line_noise, dropout); repeatable")
    ap.add_argument("--adapt-every", type=int, default=0,
                    help="run one fleet-wide online AM update every N rounds")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the fleet state here after the run")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="with --ckpt-dir: also checkpoint every N rounds")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --ckpt-dir "
                         "before streaming")
    ap.add_argument("--aot-dir", default=None,
                    help="deploy-artifact directory (runtime/aot.py): "
                         "`compile` writes it, `serve` warms the fleet from it")
    args = ap.parse_args()
    if args.command == "compile":
        run_hdc_compile(args)
        return
    if not args.hdc_fleet and not args.arch:
        ap.error("--arch is required (or pass --hdc-fleet)")
    try:
        if args.hdc_fleet:
            run_hdc_fleet(args, t_start)
        else:
            run_lm(args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():  # a --mesh run's group
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
