"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (one line each, any failure exits non-zero):

1. environment: the card (``nvidia-smi`` name and power limit), torch/CUDA;
2. build: the five CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``lbp``, ``hdc_encoder``, ``hdc_am``, ``hdc_fleet``, ``dense_hdc``) with
   ``nvcc`` for ``sm_90a``;
3. every kernel against its plain PyTorch version on the card, at the
   paths' shapes and one small odd shape, and for the two kernels with
   bit-sliced channel counters (``hdc_fleet``, ``dense_hdc``) wide shapes
   of 200 and 300 channels (8 and 15 counter planes) and a 256-code
   alphabet (narrowed table slabs); for ``hdc_encoder`` each of its paths
   (both modes at the main shape, S = 7, seg_len 48, D = 2048, windows 40
   and 48, spatial thresholds 0, 1, 2, 3, 5, C and C + 1, out-of-alphabet
   codes, a table too large for shared memory), for ``hdc_fleet`` also the
   elastic fleet's tile (S = 256, with and without a mask) and each mode
   on a faulted bank (one-hot pre-bound rows XORed with a BER 1e-2 draw
   made on the card), and for ``lbp`` 7 and 65
   channels (exact equality: all integer or bit arithmetic), with
   CUDA-event times (as the host issues the calls; beside it the device
   time, the calls queued behind a device-side sleep so that the host's
   launch cost is left out) and the card's least time for the same work;
   the fleet and encoder kernels are timed in each mode at the main shape
   (the encoder's thinning at spatial thresholds 2 and 5); ``hdc_am`` also
   at 33 classes and W = 64, and its wrapper's host path split piece by
   piece; both encoders with their AM epilogue (``encode_score_fused``,
   scores and predictions) at the main shape as ``infer(codes[1:])`` gives
   it (``or``, thinning at 2, dense; beside it the old five-launch chain),
   D = 2048, 1, 3 and 33 classes, tied class rows, window 40 and a strided
   batch; ``hdc_encoder`` with its counts epilogue (``frame_counts_fused``,
   calibration's counts) at the onboarding cell's shape (one hour, 7199
   frames), with thinning at 2 and 3 on a strided batch, in
   ``sparse_naive``'s forced thinning against its bit-domain datapath, and
   at the encoder's edges (S = 7, spatial thresholds 0 and C + 1, a table
   too large for shared memory);
4. the main path (``sparse_compim``) at the paper's geometry: raw iEEG ->
   LBP codes on the card for 16 synthetic patients, per-patient
   calibration + one-shot training, detection on the held-out seizures,
   then a 1024-session streaming fleet (warm-up, steady, profiled, ragged
   and longer-than-bucket rounds; fleet kernel in ``or`` mode);
5. the main path against the plain path on the CPU: one patient's
   training and inference, and the first 32 fleet sessions;
6. the dense path at the paper's geometry: the same 16 patients' codes
   through ``dense_hdc`` (one-shot training; detection with its AM
   epilogue in ``hamming`` mode), then a 1024-session dense fleet in the same rounds (fleet
   kernel in ``majority`` mode), held against the CPU plain path as in 5;
   The dense path also runs ``fit_iterative`` for patient 0 and two
   ``adapt`` rounds of a 64-session dense fleet, each against the CPU;
7. the ``sparse_naive`` path, short: 2 patients on 2048-cycle slices
   (calibration, training, inference through the encoder kernel with
   thinning forced on) and a 64-session fleet (``thin`` mode), all held
   against the CPU's bit-domain plain path;
8. online adaptation, sessions, the batched engine and checkpoints on the
   ``sparse_compim`` bank of phase 4: ``fit_iterative`` (5 epochs: the
   encoder kernel once, the standalone AM kernel each epoch) for every
   patient, detection before and after, patient 0's fit against the CPU and
   ``epochs=0`` against ``train_one_shot``; a 1024-session adaptive fleet
   (one capacity tile, as every fixed fleet of phases 4-8)
   over the retrained bank (4 rounds of 256 cycles and a ragged round, each
   followed by ``adapt`` with each session's true label, ``-1`` for every
   fourth), its first 32 sessions against a CPU fleet and 4 against
   ``SeizureSession`` loops on the card, saved mid-stream and restored into
   a fresh fleet that continues equal (another session count is refused);
   sessions on the card (the fleet kernel at S = 1) on ragged chunks
   against a fleet, one snapshot resumed on the CPU; and one
   ``ServingEngine.serve`` of 16 held-out records (the fleet kernel, one
   frame a session) against each patient's ``infer``;
9. the elastic fleet (``ElasticFleet``, tiles of 256, at most 4, queue of
   64, channel masking) on phase 8's bank: a seeded churn schedule rises to
   1024 live sessions (three spills, one fleet-kernel launch a tile a
   round), offers past capacity (queued, shed), quarantines two electrodes
   on 64 sessions, evicts about a tenth a round with snapshots readmitted
   the round after, adapts every other round (once while overloaded and
   shed), saves every two rounds (incremental: clean tiles hard-linked),
   recedes and compacts; crash recovery from the second-to-last checkpoint
   (``from_checkpoint`` + ``replay``, every replayed decision equal); 32
   streams followed through their whole life, two masked, against a CPU
   elastic fleet replaying their events.  Host-clock times of admit,
   evict, spill, compact, rounds at 256-1024 live sessions, saves,
   ``from_checkpoint`` and ``replay``;
10. reliability: a 1024-session fleet with every target faulted (SECDED)
   on phase 8's bank and on phase 6's dense bank: at BER 0 equal to an
   unfaulted fleet with no ECC event; one step at BER 1e-2 in each fault
   mode (transient, stuck) held against the CPU plain step given the draw
   the fleet made on the card (32 sessions: state, frames, scores, ECC
   counts); a ``set_ber`` walk over 0, 1e-4, 1e-3, 1e-2 (ECC sums, frame
   disagreement with the clean run); the clean and the faulted round timed
   in turns, one of each profiled, and the draw alone; the sweep's
   sparse_opt calibration on the card (the counts epilogue) against the
   CPU's, threshold for threshold; ``run_sweep`` at the
   paper's geometry (sparse_opt and dense, none and SECDED, BERs 0, 1e-3
   and 1e-2, 4 patients x 2 records; every BER-0 point bit-exact, the
   points printed on a line); and ``FleetChannelMonitor`` on 64 sessions
   that lose two electrodes (``degrade_batch``, dead), its masks fed to a
   masked card fleet and a masked CPU fleet each round (every decision
   equal; the quarantine equal to ``degrade_batch``'s mask), ``observe``
   timed per session-round;
11. deploy and tooling: the deploy artifact of phase 4's fleet shape
   (``save_aot``) and a fresh fleet warmed from it (no ``nvcc``, each
   step captured as a CUDA graph; capture times); under
   ``no_recompiles`` the warmed fleet's steady, ragged and 768-cycle
   pushes and an adapt equal an eager fleet's (decisions, verdicts, state
   after each); ``no_transfers``: ``push_raw`` clean under
   ``set_sync_debug_mode("error")``, ``collect_decisions`` refused; a
   warmed masked ``ElasticFleet`` (spills captured before their tile's
   first step, churn, compaction, a re-spill with no capture), a faulted
   round at BER 1e-2, the dense fleet and ``ServingEngine.prewarm`` each
   against eager; steady rounds replayed and eager in turns, one of each
   profiled (device busy, kernels, the fleet kernel under a graph launch),
   fixed and elastic at 1024 live; ``energy_per_prediction`` and
   ``area_inventory`` for the four variants equal on the card and the CPU,
   their ratios beside the paper's; and ``launch/serve.py`` in
   subprocesses: ``compile``, a warm start (0 compiled), a cold start from
   a copy of ``src/`` with an empty build directory with and without the
   artifact, a stale artifact, a SIGTERM drain and ``--resume``, the
   channel monitor;
12. the LM zoo's serving path (no kernel of its own: plain PyTorch, as the
   reference computes it in plain jnp), with the HDC phases' tensors freed:
   in float32 (TF32 off), one CPU draw of the weights copied to the card,
   qwen3-0.6b, deepseek-moe-16b and falcon-mamba-7b at full width cut to 2
   layers, seamless-m4t-medium whole and jamba-1.5-large-398b at
   ``reduced()`` (one period block of 8 sublayers), prefill of 2 x 64
   tokens (falcon: 300, two scan chunks, the second padded; seamless: 512
   encoder frames) and 8 decode steps on the CPU, then on the card fed the
   CPU's tokens (greedy tokens equal, logits and caches within 1e-3, the
   SSM, hybrid and audio models' logits and caches of their largest
   |value|, seamless's within 5e-3 and jamba's within 1e-2; each MoE
   layer's routed expert ids equal but for near-ties, counted: jamba's
   near-ties are margins below 1e-3), and the float32 prefill/decode
   consistency on the card within 1e-3; in bfloat16, qwen3-0.6b,
   internvl2-2b (256 media positions), deepseek-moe-16b, falcon-mamba-7b and
   seamless-m4t-medium (512 encoder frames, 64 text tokens) whole and
   jamba-1.5-large-398b cut to one period block with 4 of its 16 experts:
   weights drawn on the card, prefill of 4 x 512 positions and 32 greedy
   decode steps, parameters, weight and peak memory, prefill and decode
   times beside their bounds, logits and caches finite, prefill/decode
   consistency within 5e-2 (falcon: 0.35; the jamba cut's logits are all
   zero, and the run checks that its final rmsnorm's mean square
   overflows); and ``launch/serve.py --arch`` (qwen3-0.6b,
   seamless-m4t-medium) in subprocesses;
13. LM training (no kernel of its own: autograd through the plain modules,
   as the reference derives its backward with ``jax.grad``): in float32
   (TF32 off) at ``reduced()``, one config of each of the seven families
   (seamless also as ``encdec``; jamba and seamless on weights rescaled to
   std 1/sqrt(d_model), ill-conditioned at the reference's init), one CPU
   draw copied to the card, two ``make_train_step`` steps on the CPU and
   on the card (losses within 1e-5, grad norms 1e-4 then 1e-3, every
   parameter within 1e-2 of its leaf's largest update, routed ids equal
   but for phase 12's near-ties); qwen3-0.6b whole in bf16 (remat, float32
   AdamW state), 20 steps on one batch of 4 x 512 (every loss finite, the
   last below the first; step time, tokens/s, peak memory, one profiled
   step's busy and idle share and largest kernels, the bound); the
   selective scan's backward at full width (falcon-mamba-7b cut to 2
   layers, batch 1 x 512: loss and grad norm finite, time, peak memory);
   and ``launch/train.py`` in subprocesses: reduced qwen3 straight and
   with ``--fail-at 5`` (a restart from the step-4 checkpoint, the final
   losses within 1e-5), qwen3-0.6b whole for 5 steps;
14. the fleet on several cards, on phase 4's bank and 1024 sessions (run
   after phase 11, before phases 12 and 13 free the HDC tensors): (a) a
   one-rank mesh (``make_mesh((1,), ("data",))``, the group
   ``cpu:gloo,cuda:nccl`` at world size 1) against the unsharded fleet on
   steady, ragged and 300-cycle rounds, steady rounds timed in turns, the
   unsharded fleet's save restored onto the mesh; (b) two rank processes
   sharing the card (a gloo group: NCCL refuses two ranks on one device),
   512 sessions each: plain, masked and faulted (BER 1e-2, SECDED) mesh
   fleets against the unsharded fleet's decisions on both ranks, each
   rank's fleet-kernel launches, the 2-rank save restored at world size 1,
   the steady push and collect's copy-and-gather timed, and ``launch/serve.py
   --hdc-fleet --mesh 2`` under ``torch.distributed.run`` against the
   unsharded CLI; (c) four tiles of 256 over the card list and over a
   patched ``[cuda:0, cuda:0]``: fixed fleets eager and warmed, an elastic
   fleet through spills, eviction, compaction, save and
   ``from_checkpoint``, each equal to one device;
15. the LM on a mesh (run after 13; no kernel: the LM is plain PyTorch on
   ``torch.distributed.tensor``, and the five kernels' launches over the
   phase must be 0): a one-rank NCCL mesh, ``make_mesh((1, 1), ("data",
   "model"))``, against the unsharded port on the same card: (a) float32
   (TF32 off), qwen3-0.6b at full width cut to 2 layers: two sharded train
   steps against two unsharded steps (losses within 1e-5, every parameter
   within 1e-2 of its leaf's largest update), prefill of 2 x 64 tokens and
   8 greedy steps with and without ``seq_sharded_kv`` (tokens equal,
   logits within 1e-3); (b) deepseek-moe-16b at full width cut to 2
   layers, ``local_index``, float32: prefill and 8 greedy steps (tokens
   equal, routed ids equal but for counted near-ties); (c) qwen3-0.6b
   whole in bf16 (remat, float32 AdamW state, batch 4 x 512): 5 sharded
   and 5 unsharded steps from one draw in turns (losses within 1e-2
   relative), one profiled step each way, then prefill of 4 x 512 and 32
   decode steps each way, timed, and peak memory; (d) ``launch/train.py
   --reduced --mesh 1x1`` for 4 steps with checkpoints, resumed on
   ``--mesh 1`` to 8 (restored step 4, the final loss within 1e-5 of the
   same two runs unsharded), and ``launch/serve.py --arch qwen3-0.6b
   --reduced --mesh 1x1 --seq-sharded-kv`` (the unsharded CLI's greedy
   ids), under ``torch.distributed.run --nproc-per-node 1``;
16. the dry-run (run after 15, in a child process: the ``"fake"`` process
   group must not meet the NCCL groups): (a) ``launch/dryrun.py``'s cells
   ``qwen3-0.6b train_4k`` on 256 fake ranks, ``deepseek-moe-16b
   decode_32k`` on 512 and the HDC serving cell on 256, each ``ok``, with
   their trace time, per-device peak, bound and dominant term, and the
   reference's small-mesh qwen3 cells on a fake (2, 4) world held to the
   per-device counts the CPU tests hold; (b) the 1x1
   trace of phase 13's step (qwen3-0.6b whole, bf16, 4 x 512) against that
   step run on the card: argument bytes equal to the parameters', AdamW
   state's and batch's bytes, flops equal to ``FlopCounterMode``'s count of
   the real step, the peak estimate beside ``max_memory_allocated`` and the
   bound beside ``_train_work``'s; (c) the HDC cell at 1x1: the encoder
   wrapper's fake launch records the bytes and operations of phase 3's
   bound formula, and the child's kernel launches, counted over its whole
   run, are 0; (d) (checked beside phase 5, while phase 4's fleet
   lives) ``StreamingFleet.stage_probes`` raises on that card fleet and
   runs on a 64-session CPU fleet;
17. the program audit on the card (run right after phase 11, while its
   warmed fleets live; ``analysis/audit.py``): (a) ``run_audit()`` on
   ``cuda:0`` with capture, its entries the reference's four (the step
   and adapt at 2 sessions and bucket 32, the engine at batches 1 and 2),
   all ok and replayed from their graphs, the step's state in place 9 of
   9; (b) every program phase 11's warmed fleets captured at the paper's
   geometry (``sparse_compim``, ``dense``, the faulted fleet with its draw,
   the masked elastic fleet's tiles), each body audited and its own graph
   replayed, all ok, each entry's dtype histogram and seconds logged;
   (c) a leaf rebound instead of copied, a ``.item()``, an unpinned int32
   ``sum`` and an int32 buffer plus an ``arange``, each caught; the
   phase's seconds beside the card.

Each path's offline chain (calibration, training, inference) runs under
the profiler, which reports its device-busy time by kernel; on each path
one patient's ``scores(encode_frames(x))`` (the standalone AM kernel) must
equal its fused ``infer(x)``.  After each path, 50 ``infer(codes[1:])``
calls must run exactly one device kernel each: the wrappers' ``launches``
counters read 50 launches of one kernel, each with its AM epilogue, and
one profiler trace of the 50 calls between two bracket fills holds no
device event outside the kernel library and at most 50 of its kernels (a
trace that drops events can only lower these counts; the events lost are
logged); one call is timed against the old chain.  Each path's kernel launches are counted from zero just
before it and read just after.
The line before the last is a JSON object with every kernel's launches
over the paths, times and bound, and phase 15's, 16's and 17's numbers
(``lm_mesh``, ``dryrun``, ``audit``); the last line is the device summary.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.runtime import roofline  # noqa: E402

PATIENTS = 16
SESSIONS = 1024
SEIZURES = 4            # record 0 trains, records 1..3 are held out
CALIB_TARGET = 0.25     # max post-thinning frame density
STEADY_ROUNDS = 6
COMPARE_SESSIONS = 32
SEED = 0
# the sparse_naive check: its CPU plain path is bit-domain and slow at paper
# width, so it runs on 2048-cycle slices around the training onset
NAIVE_PATIENTS = 2
NAIVE_SESSIONS = 64
NAIVE_CYCLES = 2048
NAIVE_STEADY_ROUNDS = 2
# phase 8: online adaptation, sessions, the engine, checkpoints
ONLINE_EPOCHS = 5
ADAPT_ROUNDS = 4        # steady rounds of 256 cycles, each followed by adapt
LOOP_SESSIONS = 4       # fleet sessions replayed as SeizureSession loops,
                        # and the sessions run on ragged chunks
DENSE_ADAPT_SESSIONS = 64
DENSE_ADAPT_ROUNDS = 2
SESSION_PUSHES = 20     # 256-cycle pushes timed on one session
SERVE_REPS = 5
# phase 9: the elastic fleet
ELASTIC_TILE = 256
ELASTIC_MAX_TILES = 4
ELASTIC_QUEUE = 64
ELASTIC_RISE_ROUNDS = 5  # rounds at each of 256, 512, 768 and 1024 live sessions
                         # (the last at 1024 profiled)
ELASTIC_OFFERS = 80      # arrivals past capacity: 64 queued, the rest shed
ELASTIC_CHURN_ROUNDS = 5
ELASTIC_EVICT = 0.10     # the share of live sessions evicted a churn round
ELASTIC_MASKED = 64      # sessions with two electrodes quarantined
ELASTIC_FOLLOW = 32      # streams held against a CPU elastic fleet
# phase 10: reliability
REL_SESSIONS = 1024
REL_ROUNDS = 3           # rounds of 256 cycles at each point of the BER walk
REL_BERS = (0.0, 1e-4, 1e-3, 1e-2)
SWEEP_PATIENTS = 4
SWEEP_TESTS = 2
MONITOR_SESSIONS = 64
MONITOR_ROUNDS = 6

# the card's figures, one source (``runtime/roofline.py``): HBM bandwidth,
# and the 32-bit rate outside the tensor cores, used for the integer/bit
# operations
PEAK_BYTES_S = roofline.HBM_BW
PEAK_OPS_S = roofline.PEAK_OPS
# cycles a second that size a device-side sleep (at least the card's clock)
SLEEP_HZ = 2.0e9

KERNELS = {
    "lbp": ("src/repro_torch/kernels/csrc/lbp.cu",
            "src/repro/kernels/lbp/kernel.py:32"),
    "hdc_encoder": ("src/repro_torch/kernels/csrc/hdc_encoder.cu",
                    "src/repro/kernels/hdc_encoder/kernel.py:63"),
    "hdc_am": ("src/repro_torch/kernels/csrc/hdc_am.cu",
               "src/repro/kernels/hdc_am/kernel.py:42"),
    "hdc_fleet": ("src/repro_torch/kernels/csrc/hdc_fleet.cu",
                  "src/repro/kernels/hdc_fleet/kernel.py:134"),
    "dense_hdc": ("src/repro_torch/kernels/csrc/dense_hdc.cu",
                  "src/repro/kernels/dense_hdc/kernel.py:50"),
}
# the kernels each path must launch; am_epilogue_*: the encoder kernels
# launched with their AM epilogue (encode_score_fused, HDCPipeline.infer);
# counts_epilogue: the sparse encoder with its counts epilogue
# (frame_counts_fused, HDCPipeline.calibrate_density)
PATH_KERNELS = {
    "sparse_compim": ("lbp", "hdc_encoder", "hdc_am", "hdc_fleet", "am_epilogue_sparse",
                      "counts_epilogue"),
    "dense": ("dense_hdc", "hdc_am", "hdc_fleet", "am_epilogue_dense"),
    "sparse_naive": ("hdc_encoder", "hdc_am", "hdc_fleet", "am_epilogue_sparse",
                     "counts_epilogue"),
    "online": ("hdc_encoder", "hdc_am", "hdc_fleet"),
    "elastic": ("hdc_fleet",),
    "reliability": ("hdc_encoder", "dense_hdc", "hdc_fleet", "counts_epilogue"),
    "deploy": ("hdc_fleet",),
    "audit": ("hdc_fleet",),  # phase 17: bodies run eagerly, warm-ups, graph replays
    "mesh": ("hdc_fleet",),
    "lm_mesh": (),          # the LM path launches none of the five kernels
    "dryrun": (),           # phase 16's child traces on fake tensors: no launch
}


CARD = "not read"       # nvidia-smi's name and power limit, read in phase 1


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(RuntimeError):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` calls between CUDA events.

    By default the calls run as the host issues them: the larger of the
    host's and the device's time per call.  ``queued``: the calls wait
    behind a device-side sleep longer than the host takes to issue them, so
    they run back to back and the time is the device's alone (a wrapper's
    Python checks and ``ctypes`` call are not counted)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(1.0, 2 * reps * host_s + 1e-3) * SLEEP_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"[env] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| python {sys.version.split()[0]} | devices {torch.cuda.device_count()}")
    return card


def build_kernels() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.lib()
    log(f"[build] nvcc sm_90a -> {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def _rand_words(g, *shape) -> torch.Tensor:
    return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                         dtype=torch.int32).cuda()


class KernelCheck:
    """Collects equality, launches, times and bounds per kernel."""

    def __init__(self):
        self.rows: dict[str, dict] = {}

    def compare(self, name: str, case: str, wrapper, kernel, plain, *,
                n_bytes: float, n_ops: float, main: bool, reps: int = 10,
                plain_reps: int = 3) -> None:
        """Hold ``kernel()`` against ``plain()`` (a tensor, or a tuple of
        tensors held pairwise) and time both; ``main`` marks the case at the
        main path's shape that the kernel's JSON row reports.  ``launches``
        counts this check's own launches."""
        before = wrapper.launches
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        pairs = list(zip(got_t, want_t))
        equal = len(got_t) == len(want_t) and all(torch.equal(a, b) for a, b in pairs)
        err = max((float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   if a.shape == b.shape and a.numel() else
                   (0.0 if torch.equal(a, b) else float("inf"))) for a, b in pairs)
        row = self.rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        k_ms = cuda_ms(kernel, reps)
        dev_ms = cuda_ms(kernel, reps, queued=True)
        p_ms = cuda_ms(plain, plain_reps, warmup=1)
        r = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
             "device_ms": dev_ms}
        if main:
            row.update(r)
        log(f"[kernel] {name:12s} {case:40s} equal={equal} "
            f"launches={wrapper.launches - before} kernel {k_ms:.4f} ms "
            f"(device {dev_ms:.4f} ms) plain {p_ms:.4f} ms bound {b_ms:.4f} ms "
            f"({b_by}: {n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.2f} Mop)")
        expect(equal, f"{name} {case}: kernel differs from its plain version")
        return {**r, "max_abs_err": err}


def host_split(label: str, pieces: dict, calls: int = 2000, passes: int = 3) -> dict:
    """A wrapper's host path piece by piece: each piece alone ``calls``
    times between two ``time.perf_counter_ns`` readings, the least mean of
    ``passes`` passes, in microseconds a call; "rest" is the whole wrapper
    (the last piece) less the others."""
    split = {}
    for name, fn in pieces.items():
        best = float("inf")
        for _ in range(passes):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter_ns() - t0) / calls / 1e3)
            torch.cuda.synchronize()
        split[name] = best
    whole = list(pieces)[-1]
    split["rest"] = split[whole] - sum(v for k, v in split.items() if k != whole)
    log(f"[launch] {label}, us a call (least mean of {passes} x {calls} calls): "
        + "; ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return split


def am_launch_split(shape) -> dict:
    """The standalone AM wrapper's host path at the main shape: the checks,
    the output's allocation, the stream lookup, the ``ctypes`` call (the
    CUDA launch is inside it) and the error check; "rest" is the reshapes,
    ``build.lib()``, the mode lookup and the count."""
    from repro_torch.kernels import build
    from repro_torch.kernels.common import require, use_plain
    from repro_torch.kernels.hdc_am import ops as am_ops

    b, c, w = shape
    g = torch.Generator().manual_seed(SEED + 1)
    q, cls = _rand_words(g, b, w), _rand_words(g, c, w)
    lib = build.lib()
    out = torch.empty((b, c), dtype=torch.int32, device=q.device)
    stream = build.stream_ptr(q)
    return host_split(f"am_search host path at q{(b, w)} c{(c, w)}", {
        "use_plain+require": lambda: (use_plain(q, cls), require(q, "queries", torch.int32),
                                      require(cls, "classes", torch.int32, (c, w))),
        "torch.empty": lambda: torch.empty((b, c), dtype=torch.int32, device=q.device),
        "build.stream_ptr": lambda: build.stream_ptr(q),
        "ctypes call": lambda: lib.hdc_am_launch(q.data_ptr(), cls.data_ptr(), out.data_ptr(),
                                                 b, c, w, 0, w * 32, stream),
        "build.check": lambda: build.check(0, "hdc_am"),
        "whole wrapper": lambda: am_ops.am_search(q, cls, mode="overlap", dim=w * 32),
    })


def fused_launch_split(params, codes, cfg, cls) -> dict:
    """The sparse encoder's AM-epilogue wrapper at the main shape: its
    ``ctypes`` call (the launcher's own runtime calls and the launch) against
    the whole wrapper; "rest" is the wrapper's Python."""
    from repro_torch.kernels import build
    from repro_torch.kernels.common import stream_rows
    from repro_torch.kernels.hdc_encoder import ops as enc_ops

    per_row, pitch = stream_rows(codes, cfg.window)
    lead = (codes.shape[0], per_row)
    scores = torch.empty((*lead, cls.shape[0]), dtype=torch.int32, device=codes.device)
    preds = torch.empty(lead, dtype=torch.int32, device=codes.device)
    lib, stream = build.lib(), build.stream_ptr(codes)
    args = (codes.data_ptr(), params.item_pos.data_ptr(), params.elec_pos.data_ptr(), None,
            lead[0] * per_row, cfg.window, codes.shape[-1],
            params.item_pos.shape[1], cfg.segments, cfg.seg_len, cfg.temporal_threshold, 0,
            cfg.spatial_threshold, per_row, pitch, cls.data_ptr(), scores.data_ptr(),
            preds.data_ptr(), cls.shape[0], None, stream)
    return host_split(f"encode_score_fused host path at codes{tuple(codes.shape)}", {
        "ctypes call": lambda: lib.hdc_encoder_launch(*args),
        "whole wrapper": lambda: enc_ops.encode_score_fused(params, codes, cfg, cls),
    }, calls=1000)


def check_kernels(shapes: dict) -> KernelCheck:
    from repro_torch.kernels.dense_hdc import ops as dense_ops, ref as dense_ref
    from repro_torch.kernels.hdc_am import ops as am_ops, ref as am_ref
    from repro_torch.kernels.hdc_encoder import ops as enc_ops, ref as enc_ref
    from repro_torch.kernels.hdc_fleet import ops as fl_ops, ref as fl_ref
    from repro_torch.kernels.lbp import ops as lbp_ops, ref as lbp_ref

    g = torch.Generator().manual_seed(SEED)
    kc = KernelCheck()

    # lbp: (B, T, C) f32 -> (B, T - 6, C) uint8
    for case, (b, t, c) in (("main", shapes["lbp"]), ("odd", (3, 101, 7)),
                            ("c65", (2, 333, 65))):
        x = torch.randn(b, t, c, generator=g).cuda()
        x[0, 5, 0] = float("nan")
        t_out = t - 6
        kc.compare("lbp", f"{case} x{(b, t, c)}", lbp_ops.lbp_codes,
                   lambda: lbp_ops.lbp_codes(x), lambda: lbp_ref.lbp_ref(x),
                   n_bytes=b * t * c * 4 + b * t_out * c,
                   n_ops=b * t_out * c * 6 * 2, main=case == "main")

    # hdc_encoder: codes (B, F, window, C) uint8, CompIM table (C, K, S) and
    # electrode positions (C, S) -> (B, F, W); the kernel gathers itself.
    # The cases cover each of its paths: 8 segments a table load (S = 8) or
    # one (S = 7), one plane (OR), two (thinning at 2) or more (thresholds 3,
    # 5, C), every spatial bit on or off (thresholds 0, C + 1), seg_len 48
    # (segments across words), D = 2048, windows 40 and 48 (a masked tail
    # group), out-of-alphabet codes, and a table too large for shared memory
    # (C = 300, K = 256).  Bound: the codes, the table and the frames once;
    # one bind per (frame, cycle, channel, segment) and one word operation
    # per (frame, cycle, word).
    modes = {}
    for case, (b, f, win, c, s, seg_len, k, thin, thr) in (
            ("main", (*shapes["encoder"], 64, False, 2)),
            ("main", (*shapes["encoder"], 64, True, 2)),
            ("main", (*shapes["encoder"], 64, True, 5)),
            ("odd", (1, 2, 48, 5, 7, 32, 64, False, 1)),
            ("odd", (1, 2, 48, 5, 7, 32, 64, True, 2)),
            ("odd", (1, 2, 48, 5, 7, 32, 64, True, 3)),
            ("w40", (2, 3, 40, 64, 8, 128, 64, True, 5)),
            ("seg48", (2, 3, 40, 20, 8, 48, 16, True, 1)),
            ("d2048", (1, 3, 64, 33, 8, 256, 64, False, 1)),
            ("thr0", (1, 2, 48, 9, 8, 128, 64, True, 0)),
            ("thrC", (1, 2, 48, 9, 8, 128, 64, True, 9)),
            ("thrC1", (1, 2, 48, 9, 8, 128, 64, True, 10)),
            ("c300", (1, 2, 40, 300, 8, 64, 256, False, 1)),
            ("c300", (1, 2, 40, 300, 8, 64, 256, True, 2)),
            ("c300", (1, 2, 40, 300, 8, 64, 256, True, 150))):
        main = case == "main"
        codes = torch.randint(0, k if main else min(k + 8, 256), (b, f, win, c),
                              generator=g, dtype=torch.uint8).cuda()
        item = torch.randint(0, seg_len, (c, k, s), generator=g, dtype=torch.uint8).cuda()
        elec = torch.randint(0, seg_len, (c, s), generator=g, dtype=torch.uint8).cuda()
        kw = dict(window=win, segments=s, seg_len=seg_len,
                  temporal_threshold=max(1, win // 5),
                  spatial_thinning=thin, spatial_threshold=thr)
        enc_work = enc_ops.work(b * f, win, c, k, s, seg_len)
        r = kc.compare("hdc_encoder",
                       f"{case} codes{(b, f, win, c)} S={s} L={seg_len} K={k} "
                       f"thin={thin} thr={thr}", enc_ops.encoder,
                       lambda: enc_ops.encoder(codes, item, elec, **kw),
                       lambda: enc_ref.encoder_plain(codes, item, elec, **kw),
                       n_bytes=enc_work[0], n_ops=enc_work[1],
                       main=main and not thin, reps=10 if main else 5, plain_reps=2)
        if main:
            modes[f"thin_thr{thr}" if thin else "or"] = r
    kc.rows["hdc_encoder"]["modes"] = modes

    # hdc_am: (B, W) x (C, W) -> (B, C); a warp per row (rows share a warp
    # where W < 32); 33 classes take five passes of 8 and wrap the lanes
    # that store them
    for case, (b, c, w) in (("main", shapes["am"]), ("odd", (7, 5, 3)),
                            ("c33", (477, 33, 32)), ("w64", (300, 3, 64))):
        for mode in ("overlap", "hamming"):
            q, cls = _rand_words(g, b, w), _rand_words(g, c, w)
            kc.compare("hdc_am", f"{case} q{(b, w)} c{(c, w)} {mode}",
                       am_ops.am_search, lambda: am_ops.am_search(q, cls, mode=mode, dim=w * 32),
                       lambda: am_ref.am_search_ref(q, cls, mode=mode, dim=w * 32),
                       n_bytes=(b + c) * w * 4 + b * c * 4, n_ops=b * c * w * 3,
                       main=case == "main" and mode == "overlap", reps=20)
    kc.rows["hdc_am"]["launch_split_us"] = am_launch_split(shapes["am"])

    # Bounds of the two bit-sliced kernels count one operation per
    # (cycle, channel, word): a word operation on bit-sliced counter planes
    # advances the counts of 32 bit positions at once, so a per-bit count
    # (64 operations per word, as the first designs were counted) is no
    # lower bound.

    # hdc_fleet: tables (P, C, K, W), codes (S, T32, C) -> (S, K1, D); the
    # other cases are ragged (random fill levels, lengths 0 to t); "tile" is
    # a steady round at the elastic fleet's tile shape (S = 256)
    modes = {}
    for case, (p, s, t, c, k, w, window) in (("main", shapes["fleet"]),
                                            ("odd", (3, 5, 96, 33, 8, 5, 32)),
                                            ("wide", (3, 6, 96, 200, 16, 4, 32)),
                                            ("wider", (2, 5, 64, 300, 8, 2, 32)),
                                            ("k256", (2, 5, 64, 20, 256, 32, 32)),
                                            ("tile", shapes["fleet_tile"])):
        tables = _rand_words(g, p, c, k, w)
        owner = torch.randint(0, p, (s,), generator=g, dtype=torch.int32).cuda()
        codes = torch.randint(0, min(k + 4, 256), (s, t, c), generator=g,
                              dtype=torch.uint8).cuda()
        if case in ("main", "tile"):  # a steady round: every session streams t cycles
            filled = torch.zeros(s, dtype=torch.int32).cuda()
            lengths = torch.full((s,), t, dtype=torch.int32).cuda()
        else:               # ragged: random fill levels, lengths from 0 to t
            filled = torch.randint(0, window, (s,), generator=g, dtype=torch.int32).cuda()
            lengths = torch.randint(0, t + 1, (s,), generator=g, dtype=torch.int32).cuda()
            lengths[0] = 0
        tm = fl_ref.emission_masks(filled, lengths, t_pad=t, window=window)
        mask = (torch.rand(s, c, generator=g) > 0.25).to(torch.int32).cuda()
        k1, d = tm.shape[1], w * 32
        thin_thr = 3 if c < 100 else c // 3
        for mode, thr in (("or", 0), ("thin", thin_thr), ("majority", 0)):
            for cm in (None, mask):
                kw = dict(mode=mode, dim=d, threshold=thr, chan_mask=cm)
                n_bytes = (codes.numel() + tables.numel() * 4 + tm.numel() * 4
                           + s * 4 + s * k1 * d * 4 + (0 if cm is None else s * c * 4))
                n_ops = s * t * c * w + s * k1 * t * w * 3
                r = kc.compare("hdc_fleet",
                               f"{case} C={c} S={s} T={t} {mode} masked={cm is not None}",
                               fl_ops.fleet_counts_kernel,
                               lambda: fl_ops.fleet_counts_kernel(tables, owner, codes, tm, **kw),
                               lambda: fl_ref.fleet_counts_plain(tables, owner, codes, tm, **kw),
                               n_bytes=n_bytes, n_ops=n_ops,
                               main=case == "main" and mode == "or" and cm is None,
                               reps=10, plain_reps=2)
                if case == "main" and cm is None:
                    modes[mode] = r
    kc.rows["hdc_fleet"]["modes"] = modes
    log("[kernel] hdc_fleet modes at the main shape: " + "; ".join(
        f"{m} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, {r['bound_by']}; "
        f"plain {r['plain_ms']:.4f} ms)" for m, r in modes.items()))
    kc.rows["hdc_fleet"]["faulted_bank"] = faulted_bank_cases(kc, g, shapes["fleet"])

    # dense_hdc: codes (N, window, C) uint8, table (C, K, W) -> (N, W); the
    # other cases have windows that are no multiple of 16 (or of 32), odd C
    # and W, and out-of-alphabet codes
    for case, (n, win, c, k, w) in (("main", shapes["dense"]),
                                    ("odd", (6, 40, 7, 64, 3)),
                                    ("wide", (5, 72, 200, 64, 3)),
                                    ("wider", (3, 40, 300, 16, 2)),
                                    ("k256", (3, 40, 20, 256, 32))):
        codes = torch.randint(0, k if case == "main" else min(k + 8, 256), (n, win, c),
                              generator=g, dtype=torch.uint8).cuda()
        table, elec = _rand_words(g, c, k, w), _rand_words(g, c, w)
        d = w * 32
        kw = dict(window=win, dim=d)
        kc.compare("dense_hdc", f"{case} codes{(n, win, c)} table{(c, k, w)}",
                   dense_ops.dense_encoder,
                   lambda: dense_ops.dense_encoder(codes, table, elec, **kw),
                   lambda: dense_ref.dense_encoder_plain(codes, table, elec, **kw),
                   n_bytes=codes.numel() + (table.numel() + elec.numel() + n * w) * 4,
                   n_ops=n * win * w * (c + 1), main=case == "main", reps=10,
                   plain_reps=2)
    check_fused(kc, g, shapes)
    check_counts(kc, g, shapes)
    return kc


def faulted_bank_cases(kc: KernelCheck, g, shape) -> dict:
    """The fleet kernel on a faulted bank, each mode at the main shape (a
    steady round): pre-bound one-hot rows (8 segments of 128 positions)
    XORed with a BER 1e-2 draw made on the card, so that rows are no longer
    one-hot per segment."""
    from repro_torch.core import hv
    from repro_torch.kernels.hdc_fleet import ops as fl_ops, ref as fl_ref
    from repro_torch.reliability import faults

    p, s, t, c, k, w, window = shape
    pos = torch.randint(0, w * 32 // 8, (p, c, k, 8), generator=g, dtype=torch.uint8).cuda()
    clean = hv.positions_to_packed(pos, w * 32, 8)
    draw = faults.draw_words(torch.Generator(device="cuda").manual_seed(SEED), clean.shape,
                             1e-2)
    tables = faults.flip_words(clean, draw)
    per_seg = hv.popcount(tables.reshape(p, c, k, 8, w // 8))
    off = float((per_seg != 1).float().mean())
    expect(off > 0.1, f"hdc_fleet faulted bank: only {off:.3f} of segments are not one-hot")
    owner = torch.randint(0, p, (s,), generator=g, dtype=torch.int32).cuda()
    codes = torch.randint(0, k, (s, t, c), generator=g, dtype=torch.uint8).cuda()
    tm = fl_ref.emission_masks(torch.zeros(s, dtype=torch.int32).cuda(),
                               torch.full((s,), t, dtype=torch.int32).cuda(),
                               t_pad=t, window=window)
    k1, d = tm.shape[1], w * 32
    out = {}
    for mode, thr in (("or", 0), ("thin", 2), ("majority", 0)):
        kw = dict(mode=mode, dim=d, threshold=thr)
        out[mode] = kc.compare(
            "hdc_fleet", f"faulted bank C={c} S={s} T={t} {mode}", fl_ops.fleet_counts_kernel,
            lambda: fl_ops.fleet_counts_kernel(tables, owner, codes, tm, **kw),
            lambda: fl_ref.fleet_counts_plain(tables, owner, codes, tm, **kw),
            n_bytes=codes.numel() + tables.numel() * 4 + tm.numel() * 4 + s * 4
            + s * k1 * d * 4,
            n_ops=s * t * c * w + s * k1 * t * w * 3, main=False, reps=10, plain_reps=2)
    log(f"[kernel] hdc_fleet on a faulted bank (BER 1e-2, {100 * off:.1f}% of segments not "
        "one-hot): " + "; ".join(f"{m} {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms)"
                                  for m, r in out.items()))
    return out


def _old_chain(encode, frames, classes, mode: str, dim: int):
    """The offline inference as it ran before the AM epilogue: the frame
    view copied, the encoder, the standalone AM kernel, argmax and the cast
    to int32 (five launches)."""
    from repro_torch.core import am
    from repro_torch.kernels.hdc_am.ops import am_search

    s = am_search(encode(frames.contiguous()), classes, mode=mode, dim=dim)
    return s, am.am_predict(s)


def check_fused(kc: KernelCheck, g, shapes: dict) -> None:
    """The encoders with their AM epilogue (``encode_score_fused``) against
    their plain versions (encoder, ``am_search_ref``, ``am_predict``), scores
    and predictions equal: the main shape as ``infer(codes[1:])`` gives it
    (a strided batch of 159 frames a row) in ``or`` mode, with thinning at
    2, and dense; D = 2048 (the dense frame split over two blocks: the
    cross-block sum); 1, 3 and 33 classes; tied class rows (prediction 0);
    window 40; a strided batch of every other row at an odd offset.  At
    the main shape the encoders' rows also get the fused path's time and
    the old five-launch chain's on the same inputs."""
    from repro_torch.core.classifier import HDCConfig, frame_view
    from repro_torch.core.im import DenseIMParams, IMParams
    from repro_torch.kernels.dense_hdc import ops as dense_ops, ref as dense_ref
    from repro_torch.kernels.hdc_encoder import ops as enc_ops, ref as enc_ref

    r, t_main, c_main = shapes["codes"]
    # (case, (rows, T, C), rows taken, HDCConfig fields, classes, tied)
    cases = (
        ("main or", (r, t_main, c_main), slice(1, None), dict(temporal_threshold=114), 2, False),
        ("main thin2", (r, t_main, c_main), slice(1, None),
         dict(spatial_thinning=True, spatial_threshold=2, temporal_threshold=30), 2, False),
        ("main dense", (r, t_main, c_main), slice(1, None), dict(variant="dense"), 2, False),
        ("d2048", (3, 5 * 64 + 9, 33), slice(1, None),
         dict(dim=2048, channels=33, window=64, temporal_threshold=9), 2, False),
        ("d2048 dense", (3, 5 * 64 + 9, 33), slice(1, None),
         dict(variant="dense", dim=2048, channels=33, window=64), 3, False),
        ("c1", (3, 4 * 64 + 5, 64), slice(1, None), dict(window=64, temporal_threshold=20), 1, False),
        ("c3", (3, 4 * 64 + 5, 64), slice(1, None), dict(window=64, temporal_threshold=20), 3, False),
        ("c33", (3, 4 * 64 + 5, 64), slice(1, None), dict(window=64, temporal_threshold=20), 33, False),
        ("c1 dense", (3, 4 * 64 + 5, 64), slice(1, None), dict(variant="dense", window=64), 1, False),
        ("c33 dense", (3, 4 * 64 + 5, 64), slice(1, None), dict(variant="dense", window=64), 33, False),
        ("c33 d2048 dense", (2, 3 * 32 + 1, 20), slice(1, None),
         dict(variant="dense", dim=2048, channels=20, window=32), 33, False),
        ("tied", (3, 4 * 64 + 5, 64), slice(1, None), dict(window=64, temporal_threshold=20), 3, True),
        ("tied dense", (3, 4 * 64 + 5, 64), slice(1, None), dict(variant="dense", window=64), 3, True),
        ("w40", (3, 7 * 40 + 3, 64), slice(1, None),
         dict(window=40, spatial_thinning=True, spatial_threshold=2, temporal_threshold=6), 2, False),
        ("w40 dense", (3, 7 * 40 + 3, 64), slice(1, None), dict(variant="dense", window=40), 2, False),
        ("strided", (6, 3 * 48 + 11, 7), slice(1, None, 2),
         dict(segments=7, dim=224, channels=7, window=48, temporal_threshold=5), 2, False),
        ("strided dense", (6, 3 * 48 + 11, 7), slice(1, None, 2),
         dict(variant="dense", dim=96, channels=7, window=48), 2, False),
    )
    for case, (rows, t, c), take, fields, n_cls, tied in cases:
        cfg = HDCConfig(**{"channels": c, **fields})
        main = case.startswith("main")
        codes = torch.randint(0, cfg.codes if main else min(cfg.codes + 8, 256), (rows, t, c),
                              generator=g, dtype=torch.uint8).cuda()[take]
        words = cfg.dim // 32
        cls = _rand_words(g, 1 if tied else n_cls, words)
        cls = cls.expand(n_cls, words).contiguous() if tied else cls
        frames = frame_view(codes, cfg.window)
        n = frames.shape[0] * frames.shape[1]
        if cfg.variant == "dense":
            params = DenseIMParams(_rand_words(g, c, cfg.codes, words), _rand_words(g, c, words),
                                   cfg.dim)
            ops, name, mode = dense_ops, "dense_hdc", "hamming"
            plain_kw = dict(window=cfg.window, dim=cfg.dim)
            plain = lambda: dense_ref.encode_score_plain(  # noqa: E731
                frames, params.item_packed, params.elec_packed, cls, **plain_kw)
            encode = lambda f: dense_ops.dense_encoder(  # noqa: E731
                f, params.item_packed, params.elec_packed, **plain_kw)
            table_bytes = params.item_packed.numel() * 4 + params.elec_packed.numel() * 4
            work = (frames.numel() + table_bytes + cls.numel() * 4 + n * (n_cls + 1) * 4,
                    n * cfg.window * words * (c + 1) + n * n_cls * words * 2)
        else:
            s = cfg.segments
            params = IMParams(
                torch.randint(0, cfg.seg_len, (c, cfg.codes, s), generator=g,
                              dtype=torch.uint8).cuda(),
                torch.randint(0, cfg.seg_len, (c, s), generator=g, dtype=torch.uint8).cuda(),
                cfg.dim, s)
            ops, name, mode = enc_ops, "hdc_encoder", "overlap"
            plain_kw = enc_ops._cfg_kw(cfg)
            plain = lambda: enc_ref.encode_score_plain(  # noqa: E731
                frames, params.item_pos, params.elec_pos, cls, **plain_kw)
            encode = lambda f: enc_ops.encoder(  # noqa: E731
                f, params.item_pos, params.elec_pos, **plain_kw)
            work = enc_ops.work(n, cfg.window, c, cfg.codes, s, cfg.seg_len, n_cls)
        fused = lambda: ops.encode_score_fused(params, codes, cfg, cls)  # noqa: E731
        r = kc.compare(
            name, f"+AM {case} codes{tuple(codes.shape)} D={cfg.dim} "
            f"classes={n_cls}", ops.encode_score_fused, fused, plain,
            n_bytes=work[0], n_ops=work[1], main=False,
            reps=50 if main else 5, plain_reps=1)
        am_row = kc.rows["hdc_am"]
        am_row["max_abs_err"] = max(am_row["max_abs_err"], r["max_abs_err"])
        if tied:
            expect(bool((fused()[1] == 0).all()), f"{name} {case}: tied classes must predict 0")
        if case == "main or":
            kc.rows["hdc_am"]["fused_launch_split_us"] = fused_launch_split(params, codes, cfg, cls)
        if main:
            old = lambda: _old_chain(encode, frames, cls, mode, cfg.dim)  # noqa: E731
            expect(all(torch.equal(a, b) for a, b in zip(old(), fused())),
                   f"{name} {case}: the old chain differs from the fused path")
            o_ms, o_dev = cuda_ms(old, 50), cuda_ms(old, 50, queued=True)
            key = case.split()[1]
            kc.rows[name].setdefault("fused", {})[key] = {
                "ms": r["ms"], "device_ms": r["device_ms"],
                "unfused_ms": o_ms, "unfused_device_ms": o_dev}
            log(f"[kernel] {name:12s} {case}: fused {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f} ms), the old five-launch chain {o_ms:.4f} ms "
                f"(device {o_dev:.4f} ms)")


def check_counts(kc: KernelCheck, g, shapes: dict) -> None:
    """The sparse encoder with its counts epilogue (``frame_counts_fused``,
    calibration's counts) against its plain version, the position-domain
    ``classifier.frame_counts``, the (B, F, D) int32 counts equal: ``main``
    at the onboarding cell's shape (one hour of 64 channels, 7199 frames;
    ``or``), thinning at 2 and 3 on a strided batch (``codes[1:]``, window
    40), and ``sparse_naive``'s forced thinning (``pipeline._fused_sparse_cfg``)
    against the naive bit-domain datapath on codebooks drawn by ``make_im``.
    Beside them the encoder's edge cases in this mode: one segment a table
    load (S = 7), every spatial bit on or off (thresholds 0 and C + 1), and a
    table too large for shared memory (C = 300, K = 256)."""
    from repro_torch.core import classifier
    from repro_torch.core.classifier import HDCConfig
    from repro_torch.core.im import IMParams, make_im
    from repro_torch.core.pipeline import _fused_sparse_cfg
    from repro_torch.kernels.hdc_encoder import ops as enc_ops

    small = (3, 3 * 48 + 5)
    out = {}
    for case, (rows, t, c), take, fields in (
            ("main", shapes["onboard"], slice(None), {}),
            ("thin2", (3, 5 * 40 + 7, 64), slice(1, None),
             dict(window=40, spatial_thinning=True, spatial_threshold=2)),
            ("thin3", (3, 5 * 40 + 7, 64), slice(1, None),
             dict(window=40, spatial_thinning=True, spatial_threshold=3)),
            ("naive", (3, 6 * 256 + 9, 64), slice(1, None), dict(variant="sparse_naive")),
            ("s7", (*small, 5), slice(1, None), dict(segments=7, dim=224, window=48)),
            ("s7thin2", (*small, 5), slice(1, None),
             dict(segments=7, dim=224, window=48, spatial_thinning=True,
                  spatial_threshold=2)),
            ("thr0", (*small, 9), slice(1, None),
             dict(window=48, spatial_thinning=True, spatial_threshold=0)),
            ("thrC1", (*small, 9), slice(1, None),
             dict(window=48, spatial_thinning=True, spatial_threshold=10)),
            ("c300", (3, 2 * 40 + 3, 300), slice(1, None),
             dict(dim=512, lbp_bits=8, window=40)),
            ("c300thin2", (3, 2 * 40 + 3, 300), slice(1, None),
             dict(dim=512, lbp_bits=8, window=40, spatial_thinning=True,
                  spatial_threshold=2))):
        cfg = HDCConfig(**{"channels": c, **fields})
        codes = torch.randint(0, cfg.codes if case == "main" else min(cfg.codes + 8, 256),
                              (rows, t, c), generator=g, dtype=torch.uint8).cuda()[take]
        n = codes.shape[0] * (t // cfg.window)
        if case == "naive":
            params = make_im(torch.Generator(device="cuda").manual_seed(SEED), channels=c,
                             codes=cfg.codes, dim=cfg.dim, segments=cfg.segments,
                             device="cuda", precompute_packed=True)
            kcfg = _fused_sparse_cfg(cfg)
        else:
            params = IMParams(
                torch.randint(0, cfg.seg_len, (c, cfg.codes, cfg.segments), generator=g,
                              dtype=torch.uint8).cuda(),
                torch.randint(0, cfg.seg_len, (c, cfg.segments), generator=g,
                              dtype=torch.uint8).cuda(), cfg.dim, cfg.segments)
            kcfg = cfg
        work = enc_ops.work(n, cfg.window, c, cfg.codes, cfg.segments, cfg.seg_len,
                            counts=True)
        out[case] = kc.compare(
            "hdc_encoder", f"+counts {case} codes{tuple(codes.shape)} S={cfg.segments} "
            f"K={cfg.codes} thin={kcfg.spatial_thinning} thr={kcfg.spatial_threshold}",
            enc_ops.frame_counts_fused, lambda: enc_ops.frame_counts_fused(params, codes, kcfg),
            lambda: classifier.frame_counts(params, codes, cfg), n_bytes=work[0],
            n_ops=work[1], main=False, reps=20 if case == "main" else 5, plain_reps=1)
        del codes, params
        torch.cuda.empty_cache()
    kc.rows["hdc_encoder"]["counts"] = out


# ---------------------------------------------------------------------------
# phases 4-7: the paths
# ---------------------------------------------------------------------------

def make_patients():
    """Synthetic patients (the port's numpy data copy) with each record's raw
    (channels, T) signal kept through the identity ``signal_transform``."""
    from repro_torch.data import ieeg

    out = []
    for pid in range(PATIENTS):
        signals: list[np.ndarray] = []

        def keep(x, rng, signals=signals):
            signals.append(x)
            return x

        patient = ieeg.make_patient(pid, n_seizures=SEIZURES, signal_transform=keep)
        out.append((patient, signals))
    return out


def lbp_on_card(patients, bits: int) -> list[torch.Tensor]:
    """Raw signal -> LBP codes on the card, held against the numpy coder."""
    from repro_torch.kernels.lbp.ops import lbp_codes

    t0 = time.perf_counter()
    out = []
    for patient, signals in patients:
        x = torch.from_numpy(np.stack(signals)).cuda().transpose(1, 2).contiguous()
        codes = lbp_codes(x, bits=bits)                    # (R, T - 6, C)
        want = np.stack([r.codes for r in patient.records])
        expect(np.array_equal(codes.cpu().numpy(), want),
               f"patient {patient.pid}: LBP codes on the card differ from lbp_codes_np")
        out.append(codes)
    torch.cuda.synchronize()
    log(f"[sparse_compim] lbp: {PATIENTS} patients x {SEIZURES} records x "
        f"{tuple(out[0].shape[1:])} codes equal to lbp_codes_np "
        f"({time.perf_counter() - t0:.2f} s)")
    return out


def device_busy(prof) -> tuple[float, dict]:
    """Device-side time (ms) of a profiled window, and its entries (us) by
    name.  An operator's own entry repeats the device time of the kernels
    it launched, so only device-side events count; so does a program span's
    device-side annotation (``repro_torch.*``), which is left out."""
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and not e.key.startswith("repro_torch.")}
    return sum(dev_us.values()) / 1e3, dev_us


def train_and_detect(tag: str, cfg, records, calibrate: bool) -> dict:
    """Per patient: init from a CUDA generator, optional calibration, one-shot
    training on record 0 and inference on the others.  ``records`` is a list
    of (pid, codes (R, T, C) on the card, labels (R, F), onset frames (R,)).
    The whole offline chain runs under the profiler: its device-busy time
    and each kernel's share are logged."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = _train_and_detect(tag, cfg, records, calibrate)
        torch.cuda.synchronize()
    busy, dev_us = device_busy(prof)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{tag}] offline chain (profiled): device busy {busy:.3f} ms over "
        f"{len(records)} patients; "
        + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))
    return res


def _train_and_detect(tag: str, cfg, records, calibrate: bool) -> dict:
    from repro_torch.core import metrics
    from repro_torch.core.pipeline import HDCPipeline

    res = {"cfg": cfg, "calibrate": calibrate, "bank": {}, "records": records,
           "preds": {}, "scores": {}}
    t0 = time.perf_counter()
    thresholds = []
    for pid, codes, labels, _ in records:
        gen = torch.Generator(device="cuda").manual_seed(SEED + pid)
        pipe = HDCPipeline.init(gen, cfg)
        if calibrate:
            pipe = pipe.calibrate_density(codes[:1], target=CALIB_TARGET)
        pipe = pipe.train_one_shot(codes[:1], torch.as_tensor(labels[:1]).cuda())
        res["bank"][f"patient{pid}"] = pipe
        thresholds.append(pipe.cfg.temporal_threshold)
    torch.cuda.synchronize()
    log(f"[{tag}] bank: {len(records)} pipelines "
        + (f"calibrated (target density {CALIB_TARGET}) + " if calibrate else "")
        + f"trained in {time.perf_counter() - t0:.2f} s"
        + (f"; temporal thresholds {thresholds}" if calibrate else ""))

    t0 = time.perf_counter()
    results, correct, total = [], 0, 0
    for pid, codes, labels, onsets in records:
        scores, preds = res["bank"][f"patient{pid}"].infer(codes[1:])
        res["scores"][pid], res["preds"][pid] = scores, preds
        p_np = preds.cpu().numpy()
        correct += int((p_np == labels[1:]).sum())
        total += p_np.size
        for i in range(p_np.shape[0]):
            results.append(metrics.detection_metrics(p_np[i], onsets[1 + i]))
    # the standalone AM kernel (HDCPipeline.scores) on one patient's frames
    # against the fused infer's scores: it stays on every path
    pid, codes, _, _ = records[0]
    pipe = res["bank"][f"patient{pid}"]
    s = pipe.scores(pipe.encode_frames(codes[1:]))
    expect(torch.equal(s, res["scores"][pid]),
           f"{tag}: scores(encode_frames(x)) differ from infer(x)'s scores")
    agg = metrics.aggregate(results)
    log(f"[{tag}] detection: {agg['n']} held-out seizures, accuracy "
        f"{agg['detection_accuracy']:.4f}, mean delay {agg['mean_delay_s']:.3f} s, "
        f"false-alarm rate {agg['false_alarm_rate']:.4f}; frame accuracy "
        f"{correct / total:.4f} ({time.perf_counter() - t0:.2f} s)")
    expect(agg["n"] == sum(r[1].shape[0] - 1 for r in records), f"{tag}: detection count")
    return res


def serve_fleet(tag: str, res: dict, sessions: int, steady_rounds: int,
                profile: bool) -> None:
    """A streaming fleet over the bank: each session streams one of its
    patient's held-out records in a warm-up round, ``steady_rounds`` timed
    steady rounds of 256 cycles, one profiled round (``profile``), a ragged
    round and a 300-cycle round that splits."""
    from repro_torch.serve.fleet import StreamingFleet

    cfg, bank = res["cfg"], res["bank"]
    n_pat = len(bank)
    owners = [list(bank)[i % n_pat] for i in range(sessions)]
    fleet = StreamingFleet(bank, owners)
    expect(fleet.n_tiles == 1, f"{tag}: {sessions} sessions took {fleet.n_tiles} tiles, not one")
    rng = np.random.default_rng(SEED)
    host_codes = [r[1].cpu().numpy() for r in res["records"]]
    need = 256 * (2 + steady_rounds + int(profile)) + 300
    streams = np.empty((sessions, need, cfg.channels), np.uint8)
    for i in range(sessions):
        held_out = host_codes[i % n_pat][1:]
        rec = held_out[(i // n_pat) % held_out.shape[0]]
        off = int(rng.integers(0, rec.shape[0] - need))
        streams[i] = rec[off:off + need]
    pushes, decisions = [], [[] for _ in range(sessions)]
    pos = 0

    def take(lengths):
        nonlocal pos
        chunks = [streams[i, pos:pos + int(n)] for i, n in enumerate(lengths)]
        pos += int(max(lengths))
        pushes.append(chunks)
        return chunks

    def add(dec):
        for i, d in enumerate(dec):
            decisions[i].extend(d)

    add(fleet.push(take([256] * sessions)))                  # warm-up
    torch.cuda.synchronize()
    # a steady round is timed from the chunk list (validation, packing,
    # staging, the steps) to the collected decisions
    round_s = []
    for _ in range(steady_rounds):
        chunks = take([256] * sessions)
        t0 = time.perf_counter()
        dec = fleet.push(chunks)
        round_s.append(time.perf_counter() - t0)
        add(dec)
    med = float(np.median(round_s))
    if profile:
        # one more steady round under the profiler: device time by kernel
        chunks = take([256] * sessions)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            add(fleet.push(chunks))
            wall = time.perf_counter() - t0
        busy, dev_us = device_busy(prof)
        idle = (f"{100 * (1 - busy / (wall * 1e3)):.1f}% idle in this round, "
                f"{100 * (1 - busy / (med * 1e3)):.1f}% of the unprofiled median round"
                if dev_us else "idle share not measured")
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
        log(f"[{tag}] profiled steady round: wall {wall * 1e3:.3f} ms, device busy "
            f"{busy:.3f} ms ({idle}); "
            + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))
    ragged = rng.integers(0, 257, sessions)
    ragged[:8] = 0
    add(fleet.push(take(ragged)))                           # ragged round
    add(fleet.push(take([300] * sessions)))                 # splits: 256 + 44
    n_dec = sum(len(d) for d in decisions)
    expect(all(len(d) > 0 for d in decisions), f"{tag}: a session emitted no decision")
    expect(np.array_equal(fleet.frame_indices,
                          np.asarray([len(d) for d in decisions])),
           f"{tag}: frame indices disagree with the decisions collected")
    ictal = sum(d.prediction for ds in decisions for d in ds)
    log(f"[{tag}] fleet: {sessions} sessions, {len(pushes)} pushes, {n_dec} decisions "
        f"({ictal} ictal); steady round of 256 cycles/session: median "
        f"{med * 1e3:.3f} ms host+device, {sessions / med:.1f} session-rounds/s, "
        f"{sessions * 256 / med / 1e6:.3f} Mcycles/s "
        f"(all rounds ms: {', '.join(f'{x * 1e3:.3f}' for x in round_s)})")
    res.update(pushes=pushes, decisions=decisions, owners=owners, fleet=fleet)


def compare_with_plain(tag: str, res: dict, compare_sessions: int) -> None:
    """Patient 0's calibration (where the path calibrates), training and
    inference, and the first ``compare_sessions`` fleet sessions, on the
    CPU's plain path from the same codebooks."""
    from repro_torch.core.pipeline import HDCPipeline
    from repro_torch.serve.fleet import StreamingFleet

    t0 = time.perf_counter()
    pid, codes, labels, _ = res["records"][0]
    calibrate = res["calibrate"]
    card_pipe = res["bank"][f"patient{pid}"]
    cpu_codes = codes.cpu()
    untrained = HDCPipeline(params=card_pipe.params.to("cpu"), cfg=res["cfg"])
    if calibrate:
        untrained = untrained.calibrate_density(cpu_codes[:1], target=CALIB_TARGET)
        expect(untrained.cfg == card_pipe.cfg,
               f"{tag}: calibration on the card differs from the plain path")
    cpu_trained = untrained.train_one_shot(cpu_codes[:1], torch.as_tensor(labels[:1]))
    expect(torch.equal(cpu_trained.class_hvs, card_pipe.class_hvs.cpu())
           and torch.equal(cpu_trained.am_state.counts, card_pipe.am_state.counts.cpu()),
           f"{tag}: train_one_shot on the card differs from the plain path")
    cpu_pipe = card_pipe.to("cpu")
    for i in range(codes.shape[0] - 1):
        s, p = cpu_pipe.infer(cpu_codes[1 + i:2 + i])
        expect(torch.equal(s[0], res["scores"][pid][i].cpu())
               and torch.equal(p[0], res["preds"][pid][i].cpu()),
               f"{tag}: infer on record {i + 1} differs from the plain path")
    log(f"[{tag}] plain: patient {pid}: "
        + ("calibration + " if calibrate else "")
        + f"train_one_shot + infer on {codes.shape[0] - 1} records equal on the "
        f"CPU ({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    cpu_bank = {p: pipe.to("cpu") for p, pipe in res["bank"].items()}
    fleet = StreamingFleet(cpu_bank, res["owners"][:compare_sessions])
    got = [[] for _ in range(compare_sessions)]
    for chunks in res["pushes"]:
        for i, d in enumerate(fleet.push(chunks[:compare_sessions])):
            got[i].extend(d)
    n = 0
    for i in range(compare_sessions):
        card = res["decisions"][i]
        expect(len(card) == len(got[i]), f"{tag}: session {i}: decision count differs")
        for a, b in zip(card, got[i]):
            n += 1
            expect(a.frame_index == b.frame_index and a.prediction == b.prediction
                   and np.array_equal(a.scores, b.scores)
                   and np.array_equal(a.frame_hv, b.frame_hv),
                   f"{tag}: session {i}: decision {a.frame_index} differs from "
                   "the plain path")
    log(f"[{tag}] plain: fleet: first {compare_sessions} sessions, {n} decisions "
        f"equal to a CPU fleet ({time.perf_counter() - t0:.2f} s)")


def naive_records(patients, codes) -> list:
    """NAIVE_CYCLES-cycle slices of each record, centred on its onset frame
    so that training sees both classes."""
    from repro_torch.data import ieeg

    out = []
    frames = NAIVE_CYCLES // 256
    for (patient, _), c in zip(patients[:NAIVE_PATIENTS], codes):
        f0s = [ieeg.onset_frame(r, 256) - frames // 2 for r in patient.records]
        sl = torch.stack([c[i, f0 * 256:(f0 + frames) * 256]
                          for i, f0 in enumerate(f0s)])
        labels = np.stack([ieeg.frame_labels(r, 256)[f0:f0 + frames]
                           for r, f0 in zip(patient.records, f0s)])
        out.append((patient.pid, sl.contiguous(), labels,
                    [frames // 2] * len(f0s)))
    return out


def _old_infer(pipe, codes):
    """``HDCPipeline.infer`` as it ran before the AM epilogue (copy,
    encoder, standalone AM, argmax, cast)."""
    from repro_torch.core.classifier import frame_view
    from repro_torch.core.pipeline import _fused_sparse_cfg
    from repro_torch.kernels.dense_hdc.ops import dense_encoder
    from repro_torch.kernels.hdc_encoder.ops import _cfg_kw, encoder

    cfg, p = pipe.cfg, pipe.params
    if cfg.variant == "dense":
        encode = lambda f: dense_encoder(f, p.item_packed, p.elec_packed,  # noqa: E731
                                         window=cfg.window, dim=cfg.dim)
    else:
        encode = lambda f: encoder(f, p.item_pos, p.elec_pos,  # noqa: E731
                                   **_cfg_kw(_fused_sparse_cfg(cfg)))
    mode = "hamming" if cfg.variant == "dense" else "overlap"
    return _old_chain(encode, frame_view(codes, cfg.window), pipe.class_hvs, mode, cfg.dim)


PROBE_CALLS = 50         # infer calls the kernel count of one call is read over


def _probe_trace(fn, bracket) -> list[str]:
    """The device events (kernels, copies, fills) of ``PROBE_CALLS`` calls
    of ``fn`` in one profiler trace, between two bracket fills: one
    warm-up step under the profiler, then the counted step (the tracer may
    miss a short call's kernels in the step that starts it); the step's
    own device-side annotation is not a kernel, nor are those of the
    program's spans (``runtime/spans.py``: ``repro_torch.infer``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen: list[str] = []

    def read(p):
        seen.extend(e.name for e in p.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith(("ProfilerStep", "repro_torch.")))

    with torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=read) as prof:
        for _ in range(2):
            bracket.fill_(1)
            for _ in range(PROBE_CALLS):
                fn()
            bracket.fill_(2)
            torch.cuda.synchronize()
            prof.step()
    return seen


def infer_probe(tag: str, res: dict) -> dict:
    """One patient's ``infer(codes[1:])``: the device kernels one call runs
    (exactly one, the encoder with its AM epilogue), and its time as the
    host queues the calls and on the device against the old five-launch
    chain on the same inputs, timed in turns.

    The count rests on two readings of ``PROBE_CALLS`` calls, neither on
    one short trace: the wrappers' ``launches`` counters (exactly one
    launch a call, all of one kernel, each with its AM epilogue), and one
    profiler trace of the same calls between two bracket fills, in which
    no device event but the library's kernels and the two brackets may
    appear and the library's kernels number at most one a call.  A trace
    that drops events can only lower those counts; a stray kernel raises
    them even then."""
    pid, codes, _, _ = res["records"][0]
    pipe = res["bank"][f"patient{pid}"]
    x = codes[1:]
    fused, old = (lambda: pipe.infer(x)), (lambda: _old_infer(pipe, x))
    expect(all(torch.equal(a, b) for a, b in zip(fused(), old())),
           f"{tag}: the fused infer differs from the old chain")
    wrappers = kernel_wrappers()
    epilogue = "am_epilogue_dense" if pipe.cfg.variant == "dense" else "am_epilogue_sparse"
    torch.cuda.synchronize()
    before = {k: w.launches for k, w in wrappers.items()}
    for _ in range(PROBE_CALLS):
        fused()
    torch.cuda.synchronize()
    delta = {k: w.launches - before[k] for k, w in wrappers.items()}
    library = {k: delta[k] for k in KERNELS}
    launched = [k for k, n in library.items() if n]
    expect(sum(library.values()) == PROBE_CALLS and len(launched) == 1
           and delta[epilogue] == PROBE_CALLS,
           f"{tag}: {PROBE_CALLS} infer calls counted {delta} launches, not "
           f"{PROBE_CALLS} of one kernel with its AM epilogue")
    bracket = torch.zeros(1, dtype=torch.int32, device=x.device)
    lib_names = tuple(f"{k}_kernel" for k in KERNELS)
    traces = {}
    for name, fn in (("infer", fused), ("old chain", old)):
        seen = _probe_trace(fn, bracket)
        fills = [n for n in seen if "FillFunctor" in n]
        lib = [n for n in seen if any(k in n for k in lib_names)]
        other = [n for n in seen if n not in fills and n not in lib]
        traces[name] = {"events": len(seen), "fills": len(fills), "library": len(lib),
                        "other": len(other), "names": sorted(set(seen))}
    t = traces["infer"]
    lost = (PROBE_CALLS - t["library"]) + (2 - t["fills"])
    old_t = traces["old chain"]
    n_old = (old_t["events"] - min(old_t["fills"], 2)) / PROBE_CALLS
    log(f"[{tag}] {PROBE_CALLS} infer calls at codes{tuple(x.shape)}: {library[launched[0]]} "
        f"{launched[0]} launches by the counters ({delta[epilogue]} with the AM epilogue); "
        f"one trace: {t['library']} library kernels, {t['fills']} of 2 bracket fills, "
        f"{t['other']} other device events ({'; '.join(k[:50] for k in t['names'])}); "
        f"events lost {lost}; the old chain: {n_old:.2f} device events a call "
        f"({old_t['events']} in its trace: {'; '.join(k[:40] for k in old_t['names'])})")
    expect(t["other"] == 0 and t["fills"] <= 2 and t["library"] <= PROBE_CALLS,
           f"{tag}: the trace of {PROBE_CALLS} infer calls holds {t['other']} device "
           f"events not of the kernel library, {t['fills']} fills (2 brackets) and "
           f"{t['library']} library kernels (at most {PROBE_CALLS}): {t['names']}")
    n_infer = sum(library.values()) // PROBE_CALLS
    times = {}
    for name, fn in (("old", old), ("fused", fused), ("fused", fused), ("old", old)):
        times.setdefault(name, []).append((cuda_ms(fn, 50), cuda_ms(fn, 50, queued=True)))
    out = {"kernels_per_call": n_infer, "old_kernels_per_call": n_old,
           "trace_events_lost": lost, "trace_library_kernels": t["library"],
           "ms": [t[0] for t in times["fused"]], "device_ms": [t[1] for t in times["fused"]],
           "old_ms": [t[0] for t in times["old"]], "old_device_ms": [t[1] for t in times["old"]]}
    log(f"[{tag}] infer(codes{tuple(x.shape)}): fused {', '.join(f'{v:.4f}' for v in out['ms'])} "
        f"ms (device {', '.join(f'{v:.4f}' for v in out['device_ms'])}); the old chain "
        f"{', '.join(f'{v:.4f}' for v in out['old_ms'])} ms (device "
        f"{', '.join(f'{v:.4f}' for v in out['old_device_ms'])}); turns: old, fused, fused, old")
    return out


# ---------------------------------------------------------------------------
# phase 8: online adaptation, sessions, the batched engine, checkpoints
# ---------------------------------------------------------------------------

def _same_decisions(a, b) -> bool:
    return (len(a) == len(b) and all(
        x.frame_index == y.frame_index and x.prediction == y.prediction
        and np.array_equal(x.scores, y.scores) and np.array_equal(x.frame_hv, y.frame_hv)
        for x, y in zip(a, b)))


def fit_phase(tag: str, res: dict, patients: int) -> dict:
    """``fit_iterative`` on record 0 for the first ``patients`` patients of
    the bank, detection on their held-out records before (the one-shot
    bank) and after; patient 0's fit against the CPU plain path (class HVs,
    counter file, per-epoch gated-update counts), and ``epochs=0`` against
    its ``train_one_shot`` on the card.  Returns the retrained bank."""
    from repro_torch.core import metrics
    from repro_torch.core.pipeline import _fit_iterative

    records = res["records"][:patients]
    t0 = time.perf_counter()
    bank = {f"patient{pid}": res["bank"][f"patient{pid}"].fit_iterative(
        codes[:1], labels[:1], epochs=ONLINE_EPOCHS) for pid, codes, labels, _ in records}
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    before, after = [], []
    for pid, codes, _, onsets in records:
        p_one = res["preds"][pid].cpu().numpy()
        p_fit = bank[f"patient{pid}"].infer(codes[1:])[1].cpu().numpy()
        for i in range(p_one.shape[0]):
            before.append(metrics.detection_metrics(p_one[i], onsets[1 + i]))
            after.append(metrics.detection_metrics(p_fit[i], onsets[1 + i]))
    agg = [metrics.aggregate(r) for r in (before, after)]
    log(f"[{tag}] fit_iterative: {len(records)} patients x {ONLINE_EPOCHS} epochs in "
        f"{fit_s:.2f} s; detection on {agg[0]['n']} held-out seizures before / after: "
        f"accuracy {agg[0]['detection_accuracy']:.4f} / {agg[1]['detection_accuracy']:.4f}, "
        f"mean delay {agg[0]['mean_delay_s']:.3f} / {agg[1]['mean_delay_s']:.3f} s, "
        f"false-alarm rate {agg[0]['false_alarm_rate']:.4f} / {agg[1]['false_alarm_rate']:.4f}")

    t0 = time.perf_counter()
    pid, codes, labels, _ = records[0]
    pipe = res["bank"][f"patient{pid}"]
    lab = torch.as_tensor(labels[:1])
    card = _fit_iterative(pipe.params, codes[:1], lab.cuda(), 0.0, pipe.cfg, ONLINE_EPOCHS)
    cpu = _fit_iterative(pipe.params.to("cpu"), codes[:1].cpu(), lab, 0.0, pipe.cfg,
                         ONLINE_EPOCHS)
    fitted = bank[f"patient{pid}"]
    expect(torch.equal(card[0], fitted.class_hvs)
           and all(torch.equal(a.cpu(), b) for a, b in
                   zip((card[0], card[1].counts, card[1].n, card[2]),
                       (cpu[0], cpu[1].counts, cpu[1].n, cpu[2]))),
           f"{tag}: fit_iterative on the card differs from the plain path")
    zero = pipe.fit_iterative(codes[:1], labels[:1], epochs=0)
    expect(torch.equal(zero.class_hvs, pipe.class_hvs)
           and torch.equal(zero.am_state.counts, pipe.am_state.counts)
           and torch.equal(zero.am_state.n, pipe.am_state.n),
           f"{tag}: fit_iterative(epochs=0) differs from train_one_shot on the card")
    log(f"[{tag}] plain: patient {pid}: fit_iterative equal on the CPU (gated updates "
        f"per epoch {card[2].tolist()}); epochs=0 equals train_one_shot on the card "
        f"({time.perf_counter() - t0:.2f} s)")
    return bank


def fit_epoch_ms(tag: str, res: dict) -> dict:
    """Patient 0's ``_fit_iterative`` at 0 and ``ONLINE_EPOCHS`` epochs:
    host-paced between CUDA events, and its device-busy time and kernel
    count under the profiler (an epoch queues some 40 kernels, so many calls
    fill the launch queue and a queued timing would be host-paced too); an
    epoch is the difference over the epochs."""
    from repro_torch.core.pipeline import _fit_iterative

    pid, codes, labels, _ = res["records"][0]
    pipe = res["bank"][f"patient{pid}"]
    lab = torch.as_tensor(labels[:1]).cuda()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t = {}
    for e in (0, ONLINE_EPOCHS):
        fn = lambda e=e: _fit_iterative(pipe.params, codes[:1], lab, 0.0, pipe.cfg, e)  # noqa: E731
        host = cuda_ms(fn, 10)
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        busy, dev_us = device_busy(prof)
        n_kernels = sum(1 for ev in prof.events()
                        if ev.device_type == torch.autograd.DeviceType.CUDA)
        t[e] = (host, busy, n_kernels, dev_us)
    e = ONLINE_EPOCHS
    out = {"epochs0_ms": t[0][0], "epochs0_busy_ms": t[0][1], "fit_ms": t[e][0],
           "fit_busy_ms": t[e][1], "epoch_ms": (t[e][0] - t[0][0]) / e,
           "epoch_busy_ms": (t[e][1] - t[0][1]) / e,
           "epoch_kernels": (t[e][2] - t[0][2]) / e}
    top = sorted(t[e][3].items(), key=lambda kv: -kv[1])[:5]
    log(f"[{tag}] fit_iterative, one patient ({labels[:1].size} frames): {e} epochs "
        f"{out['fit_ms']:.4f} ms host-paced (device busy {out['fit_busy_ms']:.4f} ms), 0 epochs "
        f"{out['epochs0_ms']:.4f} ms ({out['epochs0_busy_ms']:.4f} ms): an epoch "
        f"{out['epoch_ms']:.4f} ms host-paced, {out['epoch_busy_ms']:.4f} ms device busy, "
        f"{out['epoch_kernels']:.1f} device kernels; "
        + "; ".join(f"{k[:50]} {v / 1e3:.3f} ms" for k, v in top))
    return out


def _adapt_streams(bank: dict, records, sessions: int, frames: int, rng):
    """Each session streams ``frames`` whole frames of one of its patient's
    held-out records, aligned to the record's frames and placed around its
    onset; returns the streams and each session's frame labels from its
    first frame on (``ieeg.frame_labels``)."""
    rec_of = {f"patient{r[0]}": r for r in records}
    names = list(bank)
    host = {n: rec_of[n][1].cpu().numpy() for n in names}
    channels = host[names[0]].shape[-1]
    streams = np.empty((sessions, frames * 256, channels), np.uint8)
    labels = []
    for i in range(sessions):
        name = names[i % len(names)]
        _, _, frame_labels, onsets = rec_of[name]
        r = 1 + (i // len(names)) % (frame_labels.shape[0] - 1)
        f0 = int(np.clip(onsets[r] - rng.integers(1, frames + 1), 0,
                         frame_labels.shape[1] - frames))
        streams[i] = host[name][r, f0 * 256:(f0 + frames) * 256]
        labels.append(frame_labels[r, f0:])
    return streams, labels


def hv_u32(words: torch.Tensor) -> np.ndarray:
    from repro_torch.core import hv

    return hv.to_u32(words)


def adaptive_fleet(tag: str, bank: dict, records, sessions: int, rounds: int,
                   compare: int, loops: int, checkpoint: bool) -> dict:
    """An adaptive fleet over ``bank``: ``rounds`` rounds of 256 cycles (and,
    with ``checkpoint``, a ragged round, a save mid-stream, a restore into a
    fresh fleet and two more rounds on both), each push followed by
    ``adapt`` with each session's true label of its last frame (-1 for
    every fourth session and for a session without a new frame).  The first
    ``compare`` sessions are replayed by a CPU fleet and the first ``loops``
    by ``SeizureSession`` loops on the card; all must agree."""
    import tempfile

    from repro_torch.serve.engine import SeizureSession
    from repro_torch.serve.fleet import StreamingFleet

    names = list(bank)
    owners = [names[i % len(names)] for i in range(sessions)]
    rng = np.random.default_rng(SEED + 8)
    steps = [("push", np.full(sessions, 256))] * rounds
    if checkpoint:
        ragged = rng.integers(0, 257, sessions)
        ragged[:8] = 0
        steps += [("push", ragged), ("checkpoint", None)]
        steps += [("push", np.full(sessions, 256))] * 2
    frames = -(-sum(int(n.max()) for k, n in steps if k == "push") // 256)
    streams, frame_labels = _adapt_streams(bank, records, sessions, frames, rng)
    fleet = StreamingFleet(bank, owners)
    expect(fleet.n_tiles == 1, f"{tag}: {sessions} sessions took {fleet.n_tiles} tiles, not one")
    cpu_fleet = StreamingFleet({n: p.to("cpu") for n, p in bank.items()}, owners[:compare])
    loop = [SeizureSession(bank[o]) for o in owners[:loops]]
    resumed, out = None, {"adapt_ms": [], "applied": [], "sessions": sessions}
    pos = 0
    for k, (kind, lengths) in enumerate(steps):
        if kind == "checkpoint":
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                fleet.save(tmp)
                out["save_ms"] = (time.perf_counter() - t0) * 1e3
                resumed = StreamingFleet(bank, owners)
                t0 = time.perf_counter()
                resumed.restore(tmp)
                torch.cuda.synchronize()
                out["restore_ms"] = (time.perf_counter() - t0) * 1e3
                try:
                    StreamingFleet(bank, owners[:sessions // 2]).restore(tmp)
                    refused = False
                except ValueError as exc:
                    refused = "does not match" in str(exc)
            expect(refused, f"{tag}: a fleet of another session count restored the checkpoint")
            log(f"[{tag}] checkpoint mid-stream ({int((fleet.fill_levels > 0).sum())} of "
                f"{sessions} sessions mid-window): save {out['save_ms']:.3f} ms, restore into "
                f"a fresh fleet {out['restore_ms']:.3f} ms (host clock); a fleet of "
                f"{sessions // 2} sessions is refused")
            continue
        chunks = [streams[i, pos:pos + int(n)] for i, n in enumerate(lengths)]
        pos += int(lengths.max())
        before = fleet.frame_indices
        dec = fleet.push(chunks)
        fidx = fleet.frame_indices
        labels = np.asarray([frame_labels[i][fidx[i] - 1] if fidx[i] > before[i]
                             and i % 4 != 3 else -1 for i in range(sessions)])
        if k == len(steps) - 1 and sessions >= 1024:
            # the last adapt runs under the profiler: its device time
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                applied = fleet.adapt(labels)
            out["adapt_device_ms"], _ = device_busy(prof)
        else:
            t0 = time.perf_counter()
            applied = fleet.adapt(labels)
            out["adapt_ms"].append((time.perf_counter() - t0) * 1e3)
        out["applied"].append(int(applied.sum()))
        if resumed is not None:
            expect(all(_same_decisions(a, b) for a, b in zip(resumed.push(chunks), dec))
                   and np.array_equal(resumed.adapt(labels), applied),
                   f"{tag}: the restored fleet differs from the uninterrupted one")
        expect(all(_same_decisions(a, b) for a, b in zip(cpu_fleet.push(chunks[:compare]), dec))
               and np.array_equal(cpu_fleet.adapt(labels[:compare]), applied[:compare]),
               f"{tag}: the adaptive fleet differs from the CPU plain fleet")
        for i, sess in enumerate(loop):
            expect(_same_decisions(sess.push(chunks[i]), dec[i]),
                   f"{tag}: session {i}: SeizureSession decisions differ from the fleet's")
            if labels[i] >= 0:
                expect(sess.adapt(int(labels[i])) == bool(applied[i]),
                       f"{tag}: session {i}: SeizureSession.adapt differs from the fleet's")
    rows = fleet.class_rows
    expect(np.array_equal(cpu_fleet.class_rows, rows[:compare])
           and all(np.array_equal(hv_u32(s.class_hvs), rows[i]) for i, s in enumerate(loop))
           and (resumed is None or np.array_equal(resumed.class_rows, rows)),
           f"{tag}: adapted class rows differ")
    n_dec = int(fleet.frame_indices.sum())
    log(f"[{tag}] adaptive fleet: {sessions} sessions, {len(out['applied'])} pushes + adapt, "
        f"{n_dec} decisions; applied per adapt {out['applied']}; adapt host-clock ms "
        + ", ".join(f"{x:.3f}" for x in out["adapt_ms"])
        + (f"; one adapt's device busy {out['adapt_device_ms']:.3f} ms"
           if "adapt_device_ms" in out else "")
        + f"; equal to a CPU fleet ({compare} sessions)"
        + (f", {loops} SeizureSession loops on the card" if loops else "")
        + (" and the restored fleet" if resumed is not None else ""))
    expect(sum(out["applied"]) > 0, f"{tag}: no adapt update fired")
    return out


def sessions_on_card(tag: str, bank: dict, records) -> dict:
    """``SeizureSession``s on the card (the fleet kernel at S = 1) over
    ragged chunks, a sub-window one, one across a window and one longer than
    the largest bucket, against a fleet of the same sessions; a snapshot
    taken mid-window goes through ``to_bytes``/``from_bytes`` and resumes
    on a CPU copy of the pipeline with equal decisions.  Then one session's
    push of 256 cycles (one frame) is timed."""
    from repro_torch.kernels.hdc_am.ops import am_search
    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.serve.engine import SeizureSession, SessionSnapshot
    from repro_torch.serve.fleet import StreamingFleet

    names = [list(bank)[i % len(bank)] for i in range(LOOP_SESSIONS)]
    rng = np.random.default_rng(SEED + 9)
    # per push, each session's chunk: session 0 takes a sub-window chunk,
    # one across a window, one longer than the largest bucket (three launches)
    pushes = [(100, 0, 300, 5), (200, 17, 60, 256), (700, 256, 1, 40), (31, 600, 513, 0)]
    after = (40, 300)  # session 0, after its snapshot
    need = max(sum(p[i] for p in pushes) for i in range(len(names))) + sum(after)
    streams, _ = _adapt_streams(bank, records, len(names), -(-need // 256), rng)
    fleet = StreamingFleet(bank, names)
    sess = [SeizureSession(bank[n]) for n in names]
    pos = np.zeros(len(names), np.int64)

    def take(lens):
        chunks = [streams[i, pos[i]:pos[i] + n] for i, n in enumerate(lens)]
        pos[:] += lens
        return chunks

    n_dec = 0
    for lens in pushes:
        chunks = take(lens)
        for i, (a, b) in enumerate(zip(fleet.push(chunks), [s.push(c) for s, c in zip(sess, chunks)])):
            n_dec += len(b)
            expect(_same_decisions(a, b), f"{tag}: session {i} differs from the fleet")
    snap = sess[0].snapshot(names[0])
    expect(0 < snap.filled < 256, f"{tag}: the snapshot is not mid-window")
    blob = snap.to_bytes()
    cpu = SeizureSession.from_snapshot(bank[names[0]].to("cpu"), SessionSnapshot.from_bytes(blob))
    for n in after:
        chunk = take([n] + [0] * (len(names) - 1))[0]
        expect(_same_decisions(sess[0].push(chunk), cpu.push(chunk)),
               f"{tag}: the session resumed on the CPU differs from the card's")
    timed, chunk = SeizureSession(bank[names[0]]), streams[0, :256]
    push_ms = []
    before = (fleet_counts_kernel.launches, am_search.launches)
    for _ in range(SESSION_PUSHES):
        t0 = time.perf_counter()
        timed.push(chunk)
        push_ms.append((time.perf_counter() - t0) * 1e3)
    per_push = [(b - a) / SESSION_PUSHES for a, b in
                zip(before, (fleet_counts_kernel.launches, am_search.launches))]
    expect(per_push == [1, 1], f"{tag}: a one-frame push launched {per_push} fleet and AM "
           "kernels, not one each")
    med = float(np.median(push_ms[2:]))
    log(f"[{tag}] sessions on the card: {len(names)} sessions, pushes of "
        f"{pushes} cycles, {n_dec} decisions equal to a fleet; a "
        f"snapshot at {snap.filled} cycles into a window ({len(blob)} bytes) resumed on the "
        f"CPU with equal decisions; one push of 256 cycles (one frame, one fleet-kernel "
        f"and one AM launch): median {med:.3f} ms host clock over {SESSION_PUSHES - 2} pushes")
    return {"push_frame_ms": med, "push_ms": push_ms}


def engine_serve(tag: str, bank: dict, records) -> dict:
    """One ``ServingEngine.serve`` of one held-out record a patient in one
    dispatch: scores and predictions equal each patient's ``infer`` on the
    card, frames its ``encode_frames``; the fleet kernel's launches a serve
    and its host-clock time."""
    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.serve.engine import ServingEngine

    rec_of = {f"patient{r[0]}": r for r in records}
    engine = ServingEngine(bank)
    reqs = [(n, rec_of[n][1][1].cpu().numpy()) for n in engine.patient_ids]
    before = fleet_counts_kernel.launches
    out = engine.serve(reqs)
    per_serve = fleet_counts_kernel.launches - before
    for (n, _), d in zip(reqs, out):
        codes = rec_of[n][1][1:2]
        s, p = bank[n].infer(codes)
        f = bank[n].encode_frames(codes)
        expect(np.array_equal(d.scores, s[0].cpu().numpy())
               and np.array_equal(d.predictions, p[0].cpu().numpy())
               and np.array_equal(d.frames, hv_u32(f[0])),
               f"{tag}: serve differs from {n}'s infer / encode_frames")
    serve_ms = []
    for _ in range(SERVE_REPS):
        t0 = time.perf_counter()
        engine.serve(reqs)
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(serve_ms))
    expect(per_serve == 1, f"{tag}: one serve launched the fleet kernel {per_serve} times")
    log(f"[{tag}] engine: serve of {len(reqs)} requests x {reqs[0][1].shape[0]} cycles "
        f"({out[0].frames.shape[0]} frames each) in one dispatch, equal to each patient's "
        f"infer and encode_frames; {per_serve} fleet-kernel launch a serve "
        f"({len(reqs) * out[0].frames.shape[0]} frame-sessions); median {med:.3f} ms host "
        f"clock (ms: {', '.join(f'{x:.3f}' for x in serve_ms)})")
    return {"serve_ms": med, "serve_ms_all": serve_ms, "fleet_launches": per_serve}


# ---------------------------------------------------------------------------
# phase 9: the elastic fleet
# ---------------------------------------------------------------------------

def _same_snapshots(a, b) -> bool:
    return (all(getattr(a, f) == getattr(b, f)
                for f in ("patient_id", "filled", "frame_index", "has_frame"))
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("counts", "class_rows", "am_counts", "am_n", "last_frame",
                              "last_scores", "channel_mask")))


def _inodes(path: str) -> dict:
    import os

    with open(os.path.join(path, "manifest.json")) as f:
        return {leaf["key"]: os.stat(os.path.join(path, leaf["file"])).st_ino
                for leaf in json.load(f)["leaves"]}


class _Churn:
    """Phase 9's bookkeeping: each stream (one implant's record) with its
    patient, record, first frame and cycles pushed, its session on the card
    and, for the followed streams, on the CPU; arrivals queued on the card
    (FIFO, as the fleet drains them) and streams parked with their
    eviction snapshots."""

    def __init__(self, fleet, cpu, bank: dict, records, rng, rounds: int):
        self.fleet, self.cpu, self.rng = fleet, cpu, rng
        self.names = list(bank)
        rec_of = {f"patient{r[0]}": r for r in records}
        self.host = {n: rec_of[n][1].cpu().numpy() for n in self.names}
        self.labels = {n: rec_of[n][2] for n in self.names}
        self.rounds = rounds
        self.streams: dict[int, list] = {}
        self.sid_of: dict[int, int] = {}      # stream -> card session id
        self.stream_of: dict[int, int] = {}   # card session id -> stream
        self.cpu_sid: dict[int, int] = {}     # followed stream -> CPU session id
        self.followed: set[int] = set()
        self.pending: list[int] = []          # queued on the card, oldest first
        self.parked: dict[int, tuple] = {}    # stream -> (card snapshot, CPU snapshot)
        self.compared = 0
        self.readmitted_followed: set[int] = set()

    def new_stream(self, s: int) -> str:
        name = self.names[s % len(self.names)]
        n_rec, cycles = self.host[name].shape[:2]
        f0 = int(self.rng.integers(0, cycles // 256 - self.rounds - 2))
        self.streams[s] = [name, 1 + int(self.rng.integers(0, n_rec - 1)), f0, 0]
        return name

    def chunk(self, s: int) -> np.ndarray:
        name, rec, f0, pos = self.streams[s]
        return self.host[name][rec, f0 * 256 + pos:f0 * 256 + pos + 256]

    def label(self, s: int) -> int:
        """True label of the stream's last frame; -1 (no feedback) for
        every fourth stream and before the first frame."""
        name, rec, f0, pos = self.streams[s]
        if s % 4 == 3 or pos < 256:
            return -1
        return int(self.labels[name][rec, f0 + pos // 256 - 1])

    def placed(self, s: int, sid: int, snaps=None) -> None:
        self.sid_of[s], self.stream_of[sid] = sid, s
        if s in self.followed:
            pid = self.streams[s][0]
            self.cpu_sid[s] = self.cpu.admit(pid, snapshot=None if snaps is None else snaps[1])

    def drained(self) -> None:
        """Map the sessions the card admitted from its queue (after an
        eviction) to the pending streams, oldest first."""
        for sid in sorted(set(self.fleet.sessions) - set(self.stream_of)):
            s = self.pending.pop(0)
            self.placed(s, sid, self.parked.pop(s, None))

    def offer(self, s: int, snaps=None) -> str:
        verdict, sid = self.fleet.offer(self.streams[s][0],
                                        snapshot=None if snaps is None else snaps[0])
        if verdict == "admitted":
            self.placed(s, sid, snaps)
        elif verdict == "queued":
            self.pending.append(s)
            if snaps is not None:
                self.parked[s] = snaps
        return verdict

    def evict(self, sids, with_state: bool) -> float:
        t0 = time.perf_counter()
        snaps = self.fleet.evict(sids, with_state=with_state)
        ms = (time.perf_counter() - t0) * 1e3
        for sid in sids:
            s = self.stream_of.pop(sid)
            del self.sid_of[s]
            if s in self.followed:
                cpu_snap = self.cpu.evict([self.cpu_sid.pop(s)], with_state=with_state)
                if with_state:
                    expect(_same_snapshots(snaps[sid], list(cpu_snap.values())[0]),
                           f"stream {s}: the card's eviction snapshot differs from the CPU's")
                    self.parked[s] = (snaps[sid], list(cpu_snap.values())[0])
            elif with_state:
                self.parked[s] = (snaps[sid], None)
        self.drained()
        return ms

    def push(self, sids) -> tuple[dict, float]:
        """One round of 256 cycles for ``sids`` on the card, the followed
        ones also on the CPU; decisions held equal."""
        chunks = {sid: self.chunk(self.stream_of[sid]) for sid in sids}
        t0 = time.perf_counter()
        dec = self.fleet.push_sessions(chunks)
        ms = (time.perf_counter() - t0) * 1e3
        follow = [self.stream_of[sid] for sid in sids if self.stream_of[sid] in self.cpu_sid]
        cpu_dec = self.cpu.push_sessions({self.cpu_sid[s]: chunks[self.sid_of[s]]
                                          for s in follow})
        for s in follow:
            expect(_same_decisions(dec[self.sid_of[s]], cpu_dec[self.cpu_sid[s]]),
                   f"stream {s}: the elastic fleet differs from the CPU plain fleet")
            self.compared += len(dec[self.sid_of[s]])
        for sid in sids:
            self.streams[self.stream_of[sid]][3] += 256
        return dec, ms

    def adapt(self) -> tuple[dict, bool]:
        labels = {sid: self.label(s) for sid, s in self.stream_of.items()}
        labels = {sid: v for sid, v in labels.items() if v >= 0}
        shed = self.fleet.overloaded
        verdict = self.fleet.adapt(labels)
        follow = {self.cpu_sid[s]: labels[self.sid_of[s]] for s in self.cpu_sid
                  if self.sid_of[s] in labels}
        if shed:
            expect(not any(verdict.values()), "an adapt while overloaded applied updates")
        else:
            cpu_v = self.cpu.adapt(follow)
            expect(all(verdict[self.sid_of[s]] == cpu_v[self.cpu_sid[s]]
                       for s in self.cpu_sid if self.sid_of[s] in labels),
                   "the elastic fleet's adapt differs from the CPU plain fleet's")
        return verdict, shed


def elastic_phase(tag: str, bank: dict, records) -> dict:
    """The elastic fleet over ``bank``: a churn schedule drawn from a seeded
    generator (the wave rises to 1024 live sessions over four tiles, then
    past capacity into the queue and shed; eviction of about a tenth a
    round with snapshots readmitted the round after; two electrodes
    quarantined on 64 sessions; ``adapt`` every other round, once while
    overloaded; ``save`` every two rounds; the wave recedes and ``compact``
    drops tiles), crash recovery from the second-to-last checkpoint
    (``from_checkpoint`` + ``replay``, every replayed decision equal), and
    32 streams followed through their whole life, two masked, against a CPU
    elastic fleet replaying their events."""
    import tempfile

    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.serve.lifecycle import ElasticFleet

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    kw = dict(tile=ELASTIC_TILE, max_tiles=ELASTIC_MAX_TILES, queue_limit=ELASTIC_QUEUE,
              log_rounds=4096, channel_masking=True)
    fleet = ElasticFleet(bank, **kw)
    cpu = ElasticFleet({n: p.to("cpu") for n, p in bank.items()}, tile=ELASTIC_FOLLOW,
                       max_tiles=2, channel_masking=True)
    rise = 4 * ELASTIC_RISE_ROUNDS
    n_rounds = rise + 1 + ELASTIC_CHURN_ROUNDS + 4
    ch = _Churn(fleet, cpu, bank, records, rng, n_rounds)
    ch.followed = set(range(ELASTIC_FOLLOW))
    spill_ms: list[float] = []
    spill = fleet._spill_tile

    def timed_spill():
        t0 = time.perf_counter()
        k = spill()
        spill_ms.append((time.perf_counter() - t0) * 1e3)
        return k

    fleet._spill_tile = timed_spill
    out = {"round_ms": {}, "admit_ms": [], "evict_ms": [], "save_ms": [], "linked": [],
           "saves": [], "round_launches": []}
    push_results: dict[int, dict] = {}
    cursors: dict[int, int] = {}
    r = 0
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name

    def one_round(sids=None, adapt=True, profile=False):
        nonlocal r
        sids = sorted(fleet.sessions) if sids is None else sids
        op = fleet.op_id
        before = fleet_counts_kernel.launches
        if profile:  # the push alone, under the profiler: device time by kernel
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                dec, ms = ch.push(sids)
                torch.cuda.synchronize()
            busy, dev_us = device_busy(prof)
            out["profiled"] = {"live": len(sids), "tiles": fleet.n_tiles, "wall_ms": ms,
                               "busy_ms": busy, "top": sorted(
                                   dev_us.items(), key=lambda kv: -kv[1])[:6]}
        else:
            dec, ms = ch.push(sids)
        torch.cuda.synchronize()
        launched = fleet_counts_kernel.launches - before
        expect(launched == fleet.n_tiles,
               f"{tag}: a round of 256 cycles over {fleet.n_tiles} tiles launched the "
               f"fleet kernel {launched} times")
        out["round_launches"].append(launched)
        push_results[op] = dec
        if adapt and r % 2 == 0:
            ch.adapt()
        if r % 2 == 1:
            save()
        r += 1
        return ms

    def save():
        t0 = time.perf_counter()
        path = fleet.save(root)
        out["save_ms"].append((time.perf_counter() - t0) * 1e3)
        step = int(path[-8:])
        cursors[step] = fleet.op_id
        linked = 0
        if step > 0:
            prev, cur = _inodes(path[:-8] + f"{step - 1:08d}"), _inodes(path)
            linked = sum(prev.get(k) == v for k, v in cur.items())
        out["linked"].append(linked)
        out["saves"].append({"step": step, "tiles": fleet.n_tiles, "linked": linked,
                             "ms": out["save_ms"][-1]})
        return step

    # the wave rises: 256 admissions, then rounds, four times (three spills)
    s_next = 0
    for level in range(1, 5):
        while len(fleet.sessions) < level * ELASTIC_TILE:
            ch.new_stream(s_next)
            t0 = time.perf_counter()
            sid = fleet.admit(ch.streams[s_next][0])
            out["admit_ms"].append((time.perf_counter() - t0) * 1e3)
            ch.placed(s_next, sid)
            s_next += 1
        out["round_ms"][level * ELASTIC_TILE] = [one_round() for _ in range(
            ELASTIC_RISE_ROUNDS - (level == 4))]
    one_round(profile=True)
    pr = out["profiled"]
    log(f"[{tag}] profiled round at {pr['live']} live sessions over {pr['tiles']} tiles "
        f"on {CARD}: push {pr['wall_ms']:.3f} ms host clock, device busy "
        f"{pr['busy_ms']:.3f} ms ({100 * (1 - pr['busy_ms'] / pr['wall_ms']):.1f}% idle; "
        f"{100 * (1 - pr['busy_ms'] / np.median(out['round_ms'][4 * ELASTIC_TILE])):.1f}% "
        f"of the unprofiled median round); "
        + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in pr["top"]))
    expect(fleet.n_tiles == 4 and fleet.capacity == 4 * ELASTIC_TILE,
           f"{tag}: 1024 sessions did not spill to four tiles")
    # past capacity: arrivals queue, then are shed
    verdicts = []
    for _ in range(ELASTIC_OFFERS):
        ch.new_stream(s_next)
        verdicts.append(ch.offer(s_next))
        s_next += 1
    expect(verdicts.count("queued") == ELASTIC_QUEUE and "shed" in verdicts,
           f"{tag}: offers past capacity gave {set(verdicts)}")
    # two electrodes quarantined on 64 sessions, two of them followed
    live = sorted(fleet.sessions)
    masked = [ch.sid_of[0], ch.sid_of[5]] + [
        int(x) for x in rng.choice([s for s in live if ch.stream_of[s] >= ELASTIC_FOLLOW],
                                   ELASTIC_MASKED - 2, replace=False)]
    channels = next(iter(bank.values())).cfg.channels
    mask = np.ones((ELASTIC_MASKED, channels), np.uint8)
    for row in mask:
        row[rng.choice(channels, 2, replace=False)] = 0
    fleet.set_channel_mask(mask, sessions=[fleet.slot_of(sid) for sid in masked])
    cpu.set_channel_mask(mask[:2], sessions=[cpu.slot_of(ch.cpu_sid[s]) for s in (0, 5)])
    shed_before = fleet.stats["adapt_shed"]
    expect(fleet.overloaded and r % 2 == 0, f"{tag}: the overloaded round does not adapt")
    out["round_ms"]["overloaded"] = one_round()
    expect(fleet.stats["adapt_shed"] == shed_before + 1, f"{tag}: adapt was not shed")
    # churn: each round evicts about a tenth with state (the first drains
    # the queue) and readmits the snapshots of the round before, then pushes
    parked_prev: list[int] = []
    follow_evict = {0: [0, 1], 1: [5, 2, 3], 2: [4, 6]}
    for c in range(ELASTIC_CHURN_ROUNDS):
        live = sorted(fleet.sessions)
        forced = [ch.sid_of[s] for s in follow_evict.get(c, []) if s in ch.sid_of]
        others = [s for s in live if ch.stream_of[s] >= ELASTIC_FOLLOW]
        pick = forced + [int(x) for x in rng.choice(
            others, int(ELASTIC_EVICT * len(live)) - len(forced), replace=False)]
        parked_now = [ch.stream_of[sid] for sid in pick]
        out["evict_ms"].append((ch.evict(pick, with_state=True), len(pick)))
        for s in sorted(parked_prev, key=lambda s: s not in ch.followed):
            if s in ch.parked and s not in ch.pending:
                snaps = ch.parked.pop(s)
                if ch.offer(s, snaps) == "admitted" and s in ch.followed:
                    ch.readmitted_followed.add(s)
        parked_prev = parked_now
        out["round_ms"].setdefault("churn", []).append(one_round())
    expect({0, 5} <= ch.readmitted_followed and len(ch.readmitted_followed) >= 4,
           f"{tag}: followed streams readmitted: {sorted(ch.readmitted_followed)}")
    # the wave recedes right after a save: most sessions leave, and those on
    # the trailing tiles idle for two rounds, so the next save links them
    if r % 2 == 1:
        out["round_ms"]["churn"].append(one_round())
    live = sorted(fleet.sessions)
    leaving = [s for s in live if ch.stream_of[s] not in ch.cpu_sid]
    leaving = [int(x) for x in rng.choice(leaving, int(0.65 * len(live)), replace=False)]
    out["evict_ms"].append((ch.evict(leaving, with_state=False), len(leaving)))
    quiet = [sid for sid in sorted(fleet.sessions) if fleet.slot_of(sid) < 2 * ELASTIC_TILE]
    out["round_ms"]["quiet"] = [one_round(quiet, adapt=False) for _ in range(2)]
    expect(out["linked"][-1] > 0, f"{tag}: the save after quiet rounds linked no file")
    moved = sum(fleet.slot_of(sid) >= ELASTIC_TILE * (fleet.n_tiles - 2)
                for sid in fleet.sessions)   # the live sessions of the last two tiles
    t0 = time.perf_counter()
    dropped = fleet.compact()
    out["compact_ms"] = (time.perf_counter() - t0) * 1e3
    expect(dropped >= 1 and fleet.n_tiles < 4, f"{tag}: compact dropped {dropped} tiles")
    out["round_ms"]["compacted"] = [one_round() for _ in range(2)]

    # crash recovery from the second-to-last checkpoint
    steps = sorted(cursors)
    step, cursor = steps[-2], cursors[steps[-2]]
    events = fleet.events_since(cursor)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rebuilt = ElasticFleet.from_checkpoint(bank, root, step=step, **kw)
    torch.cuda.synchronize()
    out["from_checkpoint_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    replayed = rebuilt.replay(events)
    torch.cuda.synchronize()
    out["replay_ms"] = (time.perf_counter() - t0) * 1e3
    n_replayed = 0
    for op, res in replayed.items():
        if op in push_results:
            want = push_results[op]
            expect(res.keys() == want.keys()
                   and all(_same_decisions(res[sid], want[sid]) for sid in want),
                   f"{tag}: a replayed decision differs from the uninterrupted fleet's")
            n_replayed += sum(len(d) for d in want.values())
    expect(rebuilt.sessions == fleet.sessions and rebuilt.op_id == fleet.op_id
           and rebuilt.stats == fleet.stats
           and np.array_equal(rebuilt.fill_levels, fleet.fill_levels)
           and np.array_equal(rebuilt.channel_masks, fleet.channel_masks),
           f"{tag}: the recovered fleet's sessions, cursor, stats or masks differ")
    expect(n_replayed > 0, f"{tag}: the replay carried no decision")
    tmp.cleanup()
    out.update(spill_ms=spill_ms, stats=fleet.stats, compared=ch.compared,
               replayed_events=len(events), replayed_decisions=n_replayed,
               followed_readmitted=sorted(ch.readmitted_followed), checkpoint_step=step,
               tiles_after_compact=fleet.n_tiles)
    med = {k: float(np.median(v)) for k, v in out["round_ms"].items()}
    evict_per = [ms / n for ms, n in out["evict_ms"]]
    log(f"[{tag}] churn: stats {fleet.stats}; {len(events)} events after the cursor of "
        f"step {step}; the fleet kernel launched once a tile each round "
        f"({sorted(set(out['round_launches']))} a round); followed {ELASTIC_FOLLOW} streams "
        f"(2 masked), {ch.compared} decisions equal to a CPU elastic fleet, readmitted "
        f"{sorted(ch.readmitted_followed)}; {n_replayed} replayed decisions equal")
    log(f"[{tag}] host-clock ms on {CARD}: admit median "
        f"{np.median(out['admit_ms']):.3f} (max {max(out['admit_ms']):.3f}); "
        f"_spill_tile {', '.join(f'{x:.3f}' for x in spill_ms)}; evict(with_state) "
        f"{', '.join(f'{ms:.3f} ({n})' for ms, n in out['evict_ms'][:-1])}, "
        f"{np.median(evict_per[:-1]):.3f} a session; compact {out['compact_ms']:.3f} "
        f"({dropped} tiles dropped, {moved} sessions on the last two tiles); from_checkpoint {out['from_checkpoint_ms']:.3f}; "
        f"replay {out['replay_ms']:.3f} ({len(events)} events)")
    log(f"[{tag}] round of 256 cycles, median host-clock ms on {CARD}: "
        + "; ".join(f"{k} live {med[k]:.3f}" for k in range(ELASTIC_TILE, 5 * ELASTIC_TILE, ELASTIC_TILE))
        + f"; overloaded {med['overloaded']:.3f}; churn {med['churn']:.3f}; quiet (half "
        f"the tiles idle) {med['quiet']:.3f}; after compaction {med['compacted']:.3f} "
        f"(all: {json.dumps({str(k): [round(x, 3) for x in np.atleast_1d(v)] for k, v in out['round_ms'].items()})})")
    full4 = [v["ms"] for v in out["saves"] if v["tiles"] == 4 and v["linked"] == 0]
    linked4 = [v for v in out["saves"] if v["tiles"] == 4 and v["linked"] > 0]
    out["save_full4_ms"] = float(np.median(full4))
    out["save_linked4"] = linked4
    log(f"[{tag}] save ms on {CARD}: four tiles written, median {out['save_full4_ms']:.3f} "
        f"over {len(full4)} saves; four tiles with files linked: "
        + ", ".join(f"{v['ms']:.3f} ({v['linked']} of 36 leaves linked)" for v in linked4)
        + f"; every save (step, tiles, leaves linked, ms): "
        + ", ".join(f"({v['step']}, {v['tiles']}, {v['linked']}, {v['ms']:.3f})"
                    for v in out["saves"]))
    out["round_median_ms"] = med
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 9 took {out['phase_s']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# phase 10: reliability
# ---------------------------------------------------------------------------

def _round_preds(decisions) -> np.ndarray:
    return np.asarray([[d.prediction for d in ds] for ds in decisions], np.int32)


def _timed_push(fleet, batch) -> tuple[list, float]:
    t0 = time.perf_counter()
    dec = fleet.push_codes(batch)
    return dec, (time.perf_counter() - t0) * 1e3


def _state_rows(state, n: int, device):
    from repro_torch.serve.fleet import FleetState

    return FleetState(**{k: v[:n].to(device) for k, v in vars(state).items()})


def faulted_step_check(tag: str, bank: dict, owners, rounds, mode: str) -> dict:
    """One faulted step at BER 1e-2 on every target (``mode`` faults,
    SECDED) of a fleet over ``bank``, after a 200-cycle push (mid-window
    counters): the draw the fleet makes for that round on the card, copied
    to the CPU, drives the CPU plain step on the first ``COMPARE_SESSIONS``
    sessions; its state, frames, scores and ECC counts must equal the card
    fleet's."""
    from repro_torch.reliability.faults import FaultConfig, StepDraw, WordDraw
    from repro_torch.serve.fleet import StreamingFleet, _fleet_step

    n = COMPARE_SESSIONS
    fc = FaultConfig(tables=1e-2, am=1e-2, counts=1e-2, mode=mode, ecc="secded",
                     seed=SEED + 3)
    fleet = StreamingFleet(bank, owners, faults=fc)
    fleet.push_codes(rounds[0][:, :200])
    before = fleet._state_t[0]
    draw = fleet._step_draw(0, fleet._stage_phase)
    expect(all(d.sel.is_cuda for d in (draw.tables, draw.am, draw.am_check, draw.counts)),
           f"{tag}: the fault draw does not lie on the card")
    ecc0 = fleet.ecc_stats
    (rnd,) = fleet.push_codes_raw(rounds[1])
    after, out = fleet._state_t[0], rnd.tiles[0]
    ecc_c = fleet.ecc_stats - ecc0

    def rows(d):
        return WordDraw(d.sel[:n].cpu(), None if d.val is None else d.val[:n].cpu())

    cpu_draw = StepDraw(tables=draw.tables.to("cpu"), am=rows(draw.am),
                        am_check=rows(draw.am_check), counts=rows(draw.counts))
    t0 = time.perf_counter()
    got, got_out, got_ecc = _fleet_step(
        _state_rows(before, n, "cpu"), fleet._tables.cpu(),
        fleet._param_owner_t[0][:n].cpu(), fleet._thresholds_t[0][:n].cpu(),
        torch.from_numpy(np.ascontiguousarray(rounds[1][:n])),
        torch.full((n,), rounds[1].shape[1], dtype=torch.int32), None,
        cfg=fleet._cfg, faults=fleet._plan, draw=cpu_draw)
    cpu_s = time.perf_counter() - t0
    want = _state_rows(after, n, "cpu")
    expect(all(torch.equal(getattr(got, k), getattr(want, k)) for k in vars(want))
           and torch.equal(got_out.frames, out.frames[:n].cpu())
           and torch.equal(got_out.scores, out.scores[:n].cpu())
           and np.array_equal(got_ecc.numpy(), ecc_c[:n]),
           f"{tag}: the faulted step ({mode}) differs from the CPU plain step given "
           "the card's draw")
    tot = ecc_c.sum(axis=0)
    expect(tot[0] > 0, f"{tag}: no AM word was corrected at BER 1e-2 ({mode})")
    log(f"[{tag}] faulted step ({mode}, BER 1e-2 on tables, AM and counters, secded): "
        f"first {n} sessions equal to the CPU plain step given the card's draw "
        f"(state, frames, scores, ECC counts; {cpu_s:.2f} s on the CPU); the round's ECC "
        f"words corrected / detected / uncorrectable {tot.tolist()}")
    return {"mode": mode, "ecc": tot.tolist()}


def faulted_fleet(tag: str, bank: dict, records) -> dict:
    """A 1024-session fleet over ``bank`` with every target faulted
    (transient, SECDED): at BER 0 its decisions equal an unfaulted fleet's on
    the same rounds and ``ecc_stats`` stays zero; one step in each fault
    mode against the CPU plain step; ``set_ber`` walks REL_BERS (ECC sums
    and frame disagreement with the clean run at each); the clean and the
    faulted round timed in turns (host clock), one of each profiled, and
    the draw alone."""
    from repro_torch.reliability.faults import FaultConfig
    from repro_torch.serve.fleet import StreamingFleet

    names = list(bank)
    owners = [names[i % len(names)] for i in range(REL_SESSIONS)]
    rng = np.random.default_rng(SEED + 20)
    streams, _ = _adapt_streams(bank, records, REL_SESSIONS, REL_ROUNDS, rng)
    rounds = [streams[:, r * 256:(r + 1) * 256] for r in range(REL_ROUNDS)]
    clean = StreamingFleet(bank, owners)
    fleet = StreamingFleet(bank, owners, faults=FaultConfig(
        tables=0.0, am=0.0, counts=0.0, ecc="secded", seed=SEED))
    expect(clean.n_tiles == fleet.n_tiles == 1, f"{tag}: more than one tile")
    clean_dec = [clean.push_codes(b) for b in rounds]
    at0 = [fleet.push_codes(b) for b in rounds]
    expect(all(_same_decisions(a, b) for da, db in zip(at0, clean_dec)
               for a, b in zip(da, db)),
           f"{tag}: the faulted fleet at BER 0 decides otherwise than the clean fleet")
    expect(not fleet.ecc_stats.any(), f"{tag}: ECC events at BER 0")
    clean_preds = np.concatenate([_round_preds(d) for d in clean_dec], axis=1)
    out = {"steps": [faulted_step_check(tag, bank, owners, rounds, m)
                     for m in ("transient", "stuck")]}

    walk = []
    for ber in REL_BERS:
        fleet.set_ber(ber)
        fleet.reset()
        preds = np.concatenate([_round_preds(fleet.push_codes(b)) for b in rounds], axis=1)
        st = fleet.ecc_stats.sum(axis=0)
        walk.append({"ber": ber, "ecc": st.tolist(),
                     "frame_disagreement": float(np.mean(preds != clean_preds))})
    expect(walk[0]["frame_disagreement"] == 0 and walk[0]["ecc"] == [0, 0, 0],
           f"{tag}: the walk's BER-0 point differs from the clean run")
    out["walk"] = walk
    log(f"[{tag}] set_ber walk, {REL_ROUNDS} rounds of 256 cycles x {REL_SESSIONS} sessions "
        "each (ECC words corrected/detected/uncorrectable; frame disagreement with the "
        "clean run): " + "; ".join(
            f"{w['ber']:g}: {w['ecc']}, {w['frame_disagreement']:.4f}" for w in walk))

    # rounds timed in turns (clean, faulted, faulted, clean) at BER 1e-2
    times = {"clean": [], "faulted": []}
    for name in ("clean", "faulted", "faulted", "clean"):
        f = clean if name == "clean" else fleet
        f.reset()
        torch.cuda.synchronize()
        times[name] += [_timed_push(f, b)[1] for b in rounds]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof_out = {}
    for name, f in (("clean", clean), ("faulted", fleet)):
        # a warm-up round under the profiler, then the one that is read
        f.reset()
        torch.cuda.synchronize()
        walls, seen = [], {}

        def read(p, seen=seen):
            # the step's own device-side annotation is not a kernel
            dev_us = {k: v for k, v in device_busy(p)[1].items()
                      if not k.startswith("ProfilerStep")}
            seen["busy"], seen["dev_us"] = sum(dev_us.values()) / 1e3, dev_us

        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=read) as prof:
            for b in rounds[:2]:
                walls.append(_timed_push(f, b)[1])
                prof.step()
        top = sorted(seen["dev_us"].items(), key=lambda kv: -kv[1])[:6]
        prof_out[name] = {"wall_ms": walls[1], "busy_ms": seen["busy"],
                          "top_ms": {k[:60]: v / 1e3 for k, v in top}}
    phase = fleet._stage_phase
    draw_ms = cuda_ms(lambda: fleet._step_draw(0, phase), 10)
    with torch.profiler.profile(activities=acts) as prof:
        fleet._step_draw(0, phase)
        torch.cuda.synchronize()
    draw_busy, _ = device_busy(prof)
    out.update(clean_round_ms=float(np.median(times["clean"])),
               faulted_round_ms=float(np.median(times["faulted"])),
               round_ms=times, profiled=prof_out, draw_ms=draw_ms, draw_busy_ms=draw_busy)
    log(f"[{tag}] round of 256 cycles x {REL_SESSIONS} sessions, host clock in turns "
        f"(clean, faulted, faulted, clean): clean median {out['clean_round_ms']:.3f} ms, "
        f"faulted (BER 1e-2, every target, secded) {out['faulted_round_ms']:.3f} ms (all ms: "
        f"clean {', '.join(f'{x:.3f}' for x in times['clean'])}; faulted "
        f"{', '.join(f'{x:.3f}' for x in times['faulted'])}); profiled round: clean wall "
        f"{prof_out['clean']['wall_ms']:.3f} ms, device busy "
        f"{prof_out['clean']['busy_ms']:.3f} ms; faulted wall "
        f"{prof_out['faulted']['wall_ms']:.3f} ms, device busy "
        f"{prof_out['faulted']['busy_ms']:.3f} ms; the draw alone {draw_ms:.4f} ms host-paced, "
        f"{draw_busy:.4f} ms device busy ("
        + (f"{100 * draw_busy / prof_out['faulted']['busy_ms']:.1f}%"
           if prof_out["faulted"]["busy_ms"] else "share not measured")
        + " of the faulted round's device time); the faulted round's kernels: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in prof_out["faulted"]["top_ms"].items()))
    return out


def sweep_on_card(tag: str) -> dict:
    """``run_sweep`` on the card: sparse_opt and dense, density 0.25, no ECC
    and SECDED, BERs 0, 1e-3 and 1e-2 on all three targets, 4 patients x 2
    test records at the paper's geometry; every BER-0 point bit-exact.
    Before it, the sweep's sparse_opt training (``train_pipelines``, whose
    calibration takes its counts from the encoder's counts epilogue) holds
    each patient's calibrated threshold against the CPU's plain datapath on
    the same codebooks and training record."""
    from repro_torch.core.pipeline import HDCConfig, HDCPipeline
    from repro_torch.reliability import sweep

    base = HDCConfig()
    sessions = sweep.make_sessions(n_patients=SWEEP_PATIENTS, n_test=SWEEP_TESTS,
                                   channels=base.channels, seed=SEED)
    pipes, cfg = sweep.train_pipelines("sparse_opt", 0.25, sessions, base, seed=SEED)
    thresholds = {}
    for name, pipe in pipes.items():
        codes = torch.as_tensor(sessions["train"][name].codes[None])
        cpu = HDCPipeline(params=pipe.params.to("cpu"), cfg=cfg).calibrate_density(
            codes, target=0.25)
        thresholds[name] = (pipe.cfg.temporal_threshold, cpu.cfg.temporal_threshold)
    expect(all(a == b for a, b in thresholds.values()),
           f"{tag}: the sweep's calibration on the card differs from the CPU's: {thresholds}")
    log(f"[{tag}] the sweep's sparse_opt calibration: thresholds on the card equal the "
        f"CPU's plain datapath's, {[a for a, _ in thresholds.values()]}")
    del pipes

    t0 = time.perf_counter()
    points = sweep.run_sweep(variants=("sparse_opt", "dense"), densities=(0.25,),
                             bers=(0.0, 1e-3, 1e-2), schemes=("none", "secded"),
                             base_cfg=base, n_patients=SWEEP_PATIENTS,
                             n_test=SWEEP_TESTS, seed=SEED)
    took = time.perf_counter() - t0
    log(f"[{tag}] sweep points: " + json.dumps(points))
    zero = [p for p in points if p["ber"] == 0.0]
    expect(len(points) == 12 and len(zero) == 4
           and all(p["zero_ber_bitexact"] for p in zero),
           f"{tag}: a BER-0 sweep point is not bit-exact with the clean fleet")
    log(f"[{tag}] run_sweep: {len(points)} points, {points[0]['sessions']} sessions x "
        f"{points[0]['frames'] // points[0]['sessions']} frames each, every BER-0 point "
        f"bit-exact; {took:.2f} s")
    return {"points": len(points), "sweep_s": took}


def monitor_on_card(tag: str, bank: dict, records) -> dict:
    """64 sessions whose streams lose two electrodes (``degrade_batch``,
    dead): each round ``FleetChannelMonitor.observe`` reads the round's
    codes and changed masks go to a masked card fleet's and a masked CPU
    fleet's ``set_channel_mask``; the quarantine must come to equal
    ``degrade_batch``'s mask, and every decision of the card fleet equal the
    CPU fleet's."""
    from repro_torch.reliability import channels
    from repro_torch.serve.fleet import StreamingFleet

    names = list(bank)
    owners = [names[i % len(names)] for i in range(MONITOR_SESSIONS)]
    rng = np.random.default_rng(SEED + 21)
    streams, _ = _adapt_streams(bank, records, MONITOR_SESSIONS, MONITOR_ROUNDS, rng)
    bad, live = channels.degrade_batch(streams, 2, "dead", seed=SEED)
    fleet = StreamingFleet(bank, owners, channel_masking=True)
    cpu = StreamingFleet({n: p.to("cpu") for n, p in bank.items()}, owners,
                         channel_masking=True)
    mon = channels.FleetChannelMonitor(MONITOR_SESSIONS, bad.shape[2])
    observe_ms, changed, quarantined_at = [], [], None
    for r in range(MONITOR_ROUNDS):
        batch = bad[:, r * 256:(r + 1) * 256]
        t0 = time.perf_counter()
        m = mon.observe(batch)
        observe_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(m, fleet.channel_masks):
            fleet.set_channel_mask(m)
            cpu.set_channel_mask(m)
            changed.append(r)
        if quarantined_at is None and np.array_equal(m, live):
            quarantined_at = r
        expect(all(_same_decisions(a, b) for a, b in
                   zip(fleet.push_codes(batch), cpu.push_codes(batch))),
               f"{tag}: round {r}: the monitored card fleet differs from the CPU fleet")
    expect(quarantined_at is not None and np.array_equal(mon.masks, live),
           f"{tag}: the monitor's masks never equal degrade_batch's")
    per = float(np.median(observe_ms)) / MONITOR_SESSIONS
    log(f"[{tag}] monitor: {MONITOR_SESSIONS} sessions, 2 dead electrodes each, quarantined "
        f"from round {quarantined_at} ({len(mon.events)} events; masks set in rounds "
        f"{changed}); {MONITOR_ROUNDS} rounds of decisions equal to a masked CPU fleet; "
        f"observe ms a round {', '.join(f'{x:.3f}' for x in observe_ms)}, "
        f"{per * 1e3:.1f} us a session-round (host)")
    return {"observe_ms": observe_ms, "observe_us_per_session_round": per * 1e3,
            "quarantined_at": quarantined_at}


def reliability_phase(tag: str, sparse_bank: dict, dense_bank: dict, records) -> dict:
    t_phase = time.perf_counter()
    out = {"sparse_compim": faulted_fleet(f"{tag} sparse_compim", sparse_bank, records),
           "dense": faulted_fleet(f"{tag} dense", dense_bank, records)}
    out["sweep"] = sweep_on_card(tag)
    out["monitor"] = monitor_on_card(tag, sparse_bank, records)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 10 took {out['phase_s']:.1f} s")
    return out


def kernel_wrappers() -> dict:
    """The wrappers whose ``launches`` counts the kernels line reads."""
    from repro_torch.kernels.dense_hdc import ops as dense_ops
    from repro_torch.kernels.hdc_am.ops import am_search
    from repro_torch.kernels.hdc_encoder import ops as enc_ops
    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.kernels.lbp.ops import lbp_codes

    return {"lbp": lbp_codes, "hdc_encoder": enc_ops.encoder,
            "hdc_am": am_search, "hdc_fleet": fleet_counts_kernel,
            "dense_hdc": dense_ops.dense_encoder,
            "am_epilogue_sparse": enc_ops.encode_score_fused,
            "am_epilogue_dense": dense_ops.encode_score_fused,
            "counts_epilogue": enc_ops.frame_counts_fused}


class Launches:
    """Reads each path's kernel launches, counted from zero."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers
        self.paths: dict[str, dict] = {}

    def start(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0

    def stop(self, path: str) -> None:
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in self.wrappers.items()}
        self.paths[path] = counts
        log(f"[{path}] launches on this path: {counts}")
        missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
        expect(not missing, f"{path}: kernels {missing} were never launched")

    def add(self, path: str, name: str, n: int) -> None:
        """Launches counted in other processes (the ranks of phase 14)."""
        self.paths[path][name] += n
        log(f"[{path}] launches with the ranks': {self.paths[path]}")

    def total(self, name: str) -> int:
        return sum(c[name] for c in self.paths.values())


# ---------------------------------------------------------------------------
# phase 11: deploy artifacts, CUDA-graph warm-up, the guards, the CLI, the
# hardware model
# ---------------------------------------------------------------------------

DEPLOY_STEADY = 6        # steady rounds of the warmed fleet against an eager one
DEPLOY_TURNS = 3         # timed steady rounds each way, in turns
CLI_SESSIONS = 1024
CLI_PATIENTS = 16
CLI_ROUNDS = 4
CLI_TIMEOUT = 300        # seconds a CLI subprocess may take
MONITOR_CLI_SESSIONS = 64
HW_WINDOWS = 4
# the paper's ratios of the optimised design against naive sparse and dense
PAPER_RATIOS = {"energy_vs_naive": 1.73, "area_vs_naive": 2.20,
                "energy_vs_dense": 7.50, "area_vs_dense": 3.24}


def _streams(res: dict, sessions: int, need: int, seed: int) -> np.ndarray:
    """(sessions, need, channels) codes: session i streams a held-out record
    of patient i % P from a seeded offset, as ``serve_fleet`` cuts them."""
    rng = np.random.default_rng(seed)
    n_pat = len(res["bank"])
    host = [r[1].cpu().numpy() for r in res["records"]]
    out = np.empty((sessions, need, res["cfg"].channels), np.uint8)
    for i in range(sessions):
        held = host[i % n_pat][1:]
        rec = held[(i // n_pat) % held.shape[0]]
        off = int(rng.integers(0, rec.shape[0] - need))
        out[i] = rec[off:off + need]
    return out


def _same_state(a, b) -> bool:
    from dataclasses import fields

    return all(torch.equal(getattr(a, f.name), getattr(b, f.name)) for f in fields(a))


def _script(streams: np.ndarray, steady: int, n_classes: int, seed: int) -> list:
    """A push script: ``steady`` rounds of 256 cycles, a ragged round, one
    push of 3 x 256 cycles read only after all three rounds ran, an adapt
    (each session's true label drawn, -1 for every fourth)."""
    rng = np.random.default_rng(seed)
    n = streams.shape[0]
    out, pos = [], 0
    for _ in range(steady):
        out.append(("push", [streams[i, pos:pos + 256] for i in range(n)]))
        pos += 256
    ragged = rng.integers(0, 257, n)
    ragged[:8] = 0
    out.append(("push", [streams[i, pos:pos + int(ragged[i])] for i in range(n)]))
    pos += 256
    out.append(("raw", [streams[i, pos:pos + 3 * 256] for i in range(n)]))
    labels = rng.integers(0, n_classes, n)
    labels[3::4] = -1
    out.append(("adapt", labels))
    return out


def _run_script(fleet, script) -> list:
    """Each item's result (decisions; ``adapt``'s applied mask) and a copy
    of the fleet's state after it."""
    out = []
    for kind, arg in script:
        if kind == "push":
            r = fleet.push(arg)
        elif kind == "raw":
            rounds = fleet.push_raw(arg)
            expect(len(rounds) == 3, f"a 768-cycle push made {len(rounds)} rounds, not 3")
            r = fleet.collect_decisions(rounds)
        else:
            r = fleet.adapt(arg)
        out.append((r, fleet.state))
    return out


def _expect_same_runs(what: str, got: list, want: list) -> int:
    """Equal results and states item by item; returns the decisions compared."""
    n = 0
    for i, ((rg, sg), (rw, sw)) in enumerate(zip(got, want)):
        if isinstance(rg, np.ndarray):
            expect(np.array_equal(rg, rw), f"{what}: item {i}: adapt verdicts differ")
        else:
            expect(len(rg) == len(rw) and all(_same_decisions(a, b) for a, b in zip(rg, rw)),
                   f"{what}: item {i}: decisions differ")
            n += sum(len(d) for d in rg)
        expect(_same_state(sg, sw), f"{what}: item {i}: states differ")
    return n


def _graph_round_profile(push) -> dict:
    """One profiled round: host wall, device busy and idle share, device
    kernels, graph launches, and whether the fleet kernel ran inside a
    graph launch (its correlation id is a ``cudaGraphLaunch``'s)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        push()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, _ = device_busy(prof)
    evs = prof.profiler.kineto_results.events()
    cuda_t = torch.autograd.DeviceType.CUDA
    dev = [e for e in evs if e.device_type() == cuda_t]
    kernels = [e for e in dev if not e.name().startswith(("Memcpy", "Memset"))]
    graph_ids = {e.correlation_id() for e in evs if e.name() == "cudaGraphLaunch"}
    fleet_k = [e for e in kernels if "hdc_fleet" in e.name()]
    in_graph = [e for e in fleet_k if e.correlation_id() in graph_ids
                or e.linked_correlation_id() in graph_ids]
    return {"wall_ms": wall, "busy_ms": busy,
            "idle": 1.0 - busy / wall if wall > 0 else None,
            "kernels": len(kernels), "graph_launches": len(graph_ids),
            "fleet_kernels": len(fleet_k), "fleet_kernels_in_graph": len(in_graph)}


def _turns(push_graph, push_eager) -> tuple[list, list]:
    """Steady rounds timed in turns graph, eager, eager, graph, ...
    (``DEPLOY_TURNS`` each); ``push_*(i)`` pushes a fleet's i-th round and
    collects its decisions; host clock around it."""
    graph_ms, eager_ms = [], []
    for use_graph in ([True, False, False, True] * DEPLOY_TURNS)[:2 * DEPLOY_TURNS]:
        times, push = (graph_ms, push_graph) if use_graph else (eager_ms, push_eager)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        push(len(times))
        times.append((time.perf_counter() - t0) * 1e3)
    return graph_ms, eager_ms


def deploy_fixed(tag: str, res: dict, tmp: str) -> dict:
    """The artifact of phase 4's fleet shape, a fresh fleet warmed from it
    with no nvcc build, its replays against an eager fleet under
    ``no_recompiles``, the guards, and steady rounds timed both ways."""
    import os

    from repro_torch.analysis import guards
    from repro_torch.kernels import build
    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.runtime import aot
    from repro_torch.serve.fleet import StreamingFleet

    bank, owners, cfg = res["bank"], res["owners"], res["cfg"]
    n = len(owners)
    art_dir = os.path.join(tmp, "fleet_aot")
    t0 = time.perf_counter()
    manifest = StreamingFleet(bank, owners).save_aot(art_dir)
    save_ms = (time.perf_counter() - t0) * 1e3
    art = aot.load_artifact(art_dir)
    expect(art is not None, f"{tag}: the artifact just written is refused")
    builds = len(build.BUILD_LOG)
    warm = StreamingFleet(bank, owners)
    t0 = time.perf_counter()
    stats = warm.warmup(aot=art)
    warm_ms = (time.perf_counter() - t0) * 1e3
    expect(len(build.BUILD_LOG) == builds, f"{tag}: warm-up from the artifact ran nvcc")
    expect(stats["compiled"] == 0 and stats["loaded"] == len(manifest["entries"]),
           f"{tag}: warm-up from the artifact: {stats}, {len(manifest['entries'])} entries")
    caps = warm.capture_ms
    log(f"[{tag}] artifact: {len(manifest['entries'])} entries + the kernel library "
        f"({manifest['library']}) in {save_ms:.1f} ms; a fresh fleet warmed from it "
        f"in {warm_ms:.1f} ms ({stats}, 0 nvcc builds); captures ms: "
        + ", ".join(f"{k} {v:.2f}" for k, v in caps.items()))

    streams = _streams(res, n, 256 * DEPLOY_STEADY + 256 + 3 * 256, SEED + 11)
    script = _script(streams, DEPLOY_STEADY, cfg.n_classes, SEED + 11)
    before = fleet_counts_kernel.launches
    with guards.no_recompiles() as rec:
        got = _run_script(warm, script)
    replay_launches = fleet_counts_kernel.launches - before
    rounds = DEPLOY_STEADY + 1 + 3
    expect(replay_launches == rounds,
           f"{tag}: {rounds} replayed rounds counted {replay_launches} fleet launches")
    eager = StreamingFleet(bank, owners)
    want = _run_script(eager, script)
    compared = _expect_same_runs(f"{tag}: warmed fleet vs eager", got, want)
    log(f"[{tag}] warmed fleet: {DEPLOY_STEADY} steady rounds, a ragged round, a 768-cycle "
        f"push (3 replays before collect_decisions) and an adapt under no_recompiles "
        f"({len(rec.compiled)} builds/captures/eager shapes): {compared} decisions, the "
        f"adapt verdicts and the state after each item equal to an eager fleet; "
        f"{replay_launches} fleet-kernel launches counted from replays")

    # the guards: a steady push_raw never waits; reading decisions does
    chunks = script[0][1]
    for f in (warm, eager):
        with guards.no_transfers():
            raw = f.push_raw(chunks)
        try:
            with guards.no_transfers():
                f.collect_decisions(raw)
            raised = False
        except guards.GuardViolation:
            raised = True
        expect(raised, f"{tag}: collect_decisions under no_transfers did not raise")
        f.collect_decisions(raw)
    log(f"[{tag}] no_transfers: push_raw clean under set_sync_debug_mode('error') on the "
        "warmed and the eager fleet; collect_decisions raised GuardViolation")

    steady = _streams(res, n, 256 * (DEPLOY_TURNS + 1), SEED + 12)

    def chunks_at(i):
        return [steady[s, i * 256:(i + 1) * 256] for s in range(n)]

    # both fleets take the same rounds in the same order, so they stay equal
    graph_ms, eager_ms = _turns(lambda i: warm.push(chunks_at(i)),
                                lambda i: eager.push(chunks_at(i)))
    prof_graph = _graph_round_profile(lambda: warm.push(chunks_at(DEPLOY_TURNS)))
    prof_eager = _graph_round_profile(lambda: eager.push(chunks_at(DEPLOY_TURNS)))
    expect(_same_state(warm.state, eager.state), f"{tag}: timed rounds left the fleets apart")
    expect(prof_graph["fleet_kernels_in_graph"] >= 1,
           f"{tag}: the profiler shows no fleet kernel under a graph launch: {prof_graph}")
    out = {"warmed": warm,   # phase 17 audits its captured programs
           "save_ms": save_ms, "warmup_ms": warm_ms, "warmup": stats, "capture_ms": caps,
           "compared": compared, "graph_round_ms": graph_ms, "eager_round_ms": eager_ms,
           "graph_median_ms": float(np.median(graph_ms)),
           "eager_median_ms": float(np.median(eager_ms)),
           "profiled_graph": prof_graph, "profiled_eager": prof_eager}
    log(f"[{tag}] steady round of 256 cycles x {n} sessions, in turns: graph median "
        f"{out['graph_median_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in graph_ms)}), eager "
        f"median {out['eager_median_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in eager_ms)}); "
        f"profiled graph round {json.dumps(prof_graph)}; profiled eager round "
        f"{json.dumps(prof_eager)}")
    return out


def deploy_elastic(tag: str, bank: dict, records) -> dict:
    """A warmed masked ``ElasticFleet`` against an eager one on phase 9's
    kind of schedule, shortened: the wave rises to 1024 live sessions
    (three spills, each capturing its tile before the tile's first step),
    two electrodes quarantined on 64 sessions, two churn rounds (a tenth
    evicted with snapshots, readmitted the round after), an adapt, the last
    tile emptied and compacted away, and a re-spill that captures nothing.
    Every decision and the final state equal; then steady rounds at 1024
    live timed both ways."""
    from repro_torch.runtime import graphs
    from repro_torch.serve.lifecycle import ElasticFleet

    kw = dict(tile=ELASTIC_TILE, max_tiles=ELASTIC_MAX_TILES, queue_limit=ELASTIC_QUEUE,
              channel_masking=True)
    warm, eager = ElasticFleet(bank, **kw), ElasticFleet(bank, **kw)
    t0 = time.perf_counter()
    stats = warm.warmup()
    warm_ms = (time.perf_counter() - t0) * 1e3
    names = list(bank)
    rec_of = {f"patient{r[0]}": r[1].cpu().numpy() for r in records}
    rng = np.random.default_rng(SEED + 13)
    streams: dict[int, list] = {}   # sid -> [codes of one held-out record, position]
    fleets = (warm, eager)
    compared = [0]

    def admit(count: int) -> None:
        for _ in range(count):
            name = names[len(streams) % len(names)]
            sids = {f.admit(name) for f in fleets}
            expect(len(sids) == 1, f"{tag}: the two fleets gave different session ids")
            rec = rec_of[name][1 + int(rng.integers(0, rec_of[name].shape[0] - 1))]
            streams[sids.pop()] = [rec, int(rng.integers(0, rec.shape[0] // 2))]
        expect(all((k, b) in warm._graphs for k in range(warm.n_tiles)
                   for b in warm._buckets),
               f"{tag}: a spilled tile was not captured before its first step")

    def push(sids=None) -> None:
        sids = sorted(warm.sessions) if sids is None else sids
        chunks = {}
        for sid in sids:
            rec, p = streams[sid]
            chunks[sid] = rec[p:p + 256]
            streams[sid][1] = p + 256
        dw, de = warm.push_sessions(chunks), eager.push_sessions(chunks)
        for sid in sids:
            expect(_same_decisions(dw[sid], de[sid]),
                   f"{tag}: session {sid}: the warmed elastic fleet differs from the eager one")
            compared[0] += len(dw[sid])

    caps0 = len(graphs.CAPTURE_LOG)
    for _ in range(4):                       # rise: 256 more sessions a round
        admit(ELASTIC_TILE)
        push()
    spill_caps = len(graphs.CAPTURE_LOG) - caps0
    masked = sorted(warm.sessions)[:ELASTIC_MASKED]
    mask = np.ones((len(masked), bank[names[0]].cfg.channels), np.uint8)
    mask[:, [5, 17]] = 0
    for f in fleets:
        f.set_channel_mask(mask, sessions=[f.slot_of(s) for s in masked])
    push()
    for _ in range(2):                       # churn
        out = sorted(rng.choice(sorted(warm.sessions), len(warm.sessions) // 10,
                                replace=False).tolist())
        snaps = [f.evict(out) for f in fleets]
        push()
        for sid in out:
            pid = snaps[0][sid].patient_id
            new = {f.admit(pid, snapshot=s[sid]) for f, s in zip(fleets, snaps)}
            expect(len(new) == 1, f"{tag}: readmission ids differ")
            streams[new.pop()] = streams.pop(sid)
        push()
    labels = {sid: int(rng.integers(0, 2)) for sid in warm.sessions}
    verdicts = [f.adapt(labels) for f in fleets]
    expect(verdicts[0] == verdicts[1], f"{tag}: adapt verdicts differ")
    last = warm._tile_slices[-1]
    gone = [sid for sid in warm.sessions if last.start <= warm.slot_of(sid) < last.stop]
    for f in fleets:
        f.evict(gone, with_state=False)
    for sid in gone:
        del streams[sid]
    dropped = {f.compact() for f in fleets}
    expect(dropped == {1}, f"{tag}: compaction dropped {dropped} tiles, not 1 each")
    push()
    caps1 = len(graphs.CAPTURE_LOG)
    admit(len(gone))                          # re-spill: the dropped tile's graphs return
    expect(len(graphs.CAPTURE_LOG) == caps1, f"{tag}: a re-spill captured again")
    push()
    expect(all(_same_state(a, b) for a, b in zip(warm._state_t, eager._state_t)),
           f"{tag}: the warmed elastic fleet's state differs from the eager one's")
    live = len(warm.sessions)
    log(f"[{tag}] warmed masked elastic fleet (warm-up {warm_ms:.1f} ms, {stats}): rise to "
        f"{live} live over {warm.n_tiles} tiles ({spill_caps} captures by 3 spills, each "
        f"before its tile's first step), {ELASTIC_MASKED} masked sessions, 2 churn rounds, "
        f"an adapt, a compaction and a re-spill with no capture: {compared[0]} decisions and "
        f"the final state equal to an eager elastic fleet")

    def push_all(f):
        def run(i):
            chunks = {sid: streams[sid][0][:256] for sid in sorted(f.sessions)}
            f.push_sessions(chunks)
        return run

    graph_ms, eager_ms = _turns(push_all(warm), push_all(eager))
    prof_graph = _graph_round_profile(lambda: push_all(warm)(0))
    prof_eager = _graph_round_profile(lambda: push_all(eager)(0))
    out = {"warmed": warm, "warmup": stats, "warmup_ms": warm_ms, "spill_captures": spill_caps,
           "compared": compared[0], "live": live, "graph_round_ms": graph_ms,
           "eager_round_ms": eager_ms, "graph_median_ms": float(np.median(graph_ms)),
           "eager_median_ms": float(np.median(eager_ms)),
           "profiled_graph": prof_graph, "profiled_eager": prof_eager}
    log(f"[{tag}] elastic steady round at {live} live, in turns: graph median "
        f"{out['graph_median_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in graph_ms)}), eager "
        f"median {out['eager_median_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in eager_ms)}); "
        f"profiled graph round {json.dumps(prof_graph)}; profiled eager round "
        f"{json.dumps(prof_eager)}")
    return out


def deploy_variants(tag: str, sparse: dict, dense: dict) -> dict:
    """Warmed against eager, bit for bit: one faulted round at BER 1e-2
    (every target, SECDED, the same seed) after a 200-cycle first round,
    the dense fleet on ``_script``, and ``ServingEngine.prewarm`` + ``serve``
    against an eager ``serve``."""
    from repro_torch.reliability.faults import FaultConfig
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.fleet import StreamingFleet

    out = {}
    bank, owners = sparse["bank"], sparse["owners"]
    fc = FaultConfig(tables=1e-2, am=1e-2, counts=1e-2, ecc="secded")
    warm, eager = (StreamingFleet(bank, owners, faults=fc) for _ in range(2))
    stats = warm.warmup()
    streams = _streams(sparse, len(owners), 512, SEED + 14)
    runs = []
    for f in (warm, eager):
        f.push([s[:200] for s in streams])      # mid-window counters
        runs.append(_run_script(f, [("push", [s[200:456] for s in streams])]))
    n = _expect_same_runs(f"{tag}: faulted round", runs[0], runs[1])
    expect(np.array_equal(warm.ecc_stats, eager.ecc_stats) and warm.ecc_stats.any(),
           f"{tag}: faulted ECC counts differ or are all zero")
    out["faulted"] = {"warmed": warm, "warmup": stats, "decisions": n,
                      "ecc_words": warm.ecc_stats.sum(0).tolist()}
    log(f"[{tag}] faulted fleet (BER 1e-2, every target, SECDED) warmed {stats}: the "
        f"replayed faulted round equals the eager one with the same seed ({n} decisions, "
        f"state, ECC counts {out['faulted']['ecc_words']})")

    dbank, downers = dense["bank"], dense["owners"]
    warm, eager = StreamingFleet(dbank, downers), StreamingFleet(dbank, downers)
    stats = warm.warmup()
    dstreams = _streams(dense, len(downers), 4 * 256 + 3 * 256, SEED + 15)
    script = _script(dstreams, 2, dense["cfg"].n_classes, SEED + 15)
    n = _expect_same_runs(f"{tag}: dense fleet", _run_script(warm, script),
                          _run_script(eager, script))
    out["dense"] = {"warmed": warm, "warmup": stats, "decisions": n}
    log(f"[{tag}] dense fleet warmed {stats}: 2 steady rounds, a ragged round, a 768-cycle "
        f"push and an adapt equal to an eager dense fleet ({n} decisions)")

    rec_of = {f"patient{r[0]}": r[1].cpu().numpy() for r in sparse["records"]}
    t = 4 * 256
    reqs = [(name, rec_of[name][1 + i % 3, 256 * i:256 * i + t])
            for i, name in enumerate(bank)]
    warm_e, eager_e = ServingEngine(bank), ServingEngine(bank)
    stats = warm_e.prewarm(len(reqs), t)
    for batch in (reqs, reqs[:5]):
        dw, de = warm_e.serve(batch), eager_e.serve(batch)
        expect(all(np.array_equal(a.scores, b.scores)
                   and np.array_equal(a.predictions, b.predictions)
                   and np.array_equal(a.frames, b.frames) for a, b in zip(dw, de)),
               f"{tag}: prewarmed serve of {len(batch)} differs from eager serve")
    out["engine"] = {"prewarm": stats, "aot_count": warm_e.aot_count}
    log(f"[{tag}] engine prewarm({len(reqs)}, {t}) {stats}: serve of {len(reqs)} and of 5 "
        "requests (graph replays) equal to eager serve")
    return out


def _cli(args: list, env: dict, what: str, timeout: int = CLI_TIMEOUT,
         module: str = "repro_torch.launch.serve") -> tuple[str, float]:
    """Run ``python -m <module>`` with ``args``; fails the phase on a
    non-zero exit.  Returns (stdout and stderr, seconds)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", module, *args],
                       env=env, cwd=str(ROOT), capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t0
    out = p.stdout + p.stderr
    expect(p.returncode == 0, f"CLI {what} exited {p.returncode}:\n{out[-3000:]}")
    return out, secs


def _line(out: str, prefix: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.lstrip().startswith(prefix)]
    expect(bool(lines), f"CLI output has no {prefix!r} line:\n{out[-2000:]}")
    return lines[-1].strip()


def _first_decision_s(out: str) -> float:
    return float(_line(out, "first decision:").split()[2])


def _ckpt_leaves(root: str) -> dict:
    """The latest checkpoint's leaves as bytes, by key."""
    import os

    steps = sorted(d for d in os.listdir(root) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    d = os.path.join(root, steps[-1])
    with open(os.path.join(d, "manifest.json")) as f:
        return {leaf["key"]: np.load(os.path.join(d, leaf["file"])).tobytes()
                for leaf in json.load(f)["leaves"]}


def deploy_cli(tag: str, tmp: str) -> dict:
    """``launch/serve.py`` in subprocesses: ``compile``; a warm start from
    the artifact (0 compiled) with checkpoints; the same with a copy of
    ``src/`` whose build directory is empty, with and without the artifact
    (the cold start); a stale artifact (warns, builds from the sources,
    decides the same); a SIGTERM drain and ``--resume``; the channel monitor
    on an injected dead electrode."""
    import os
    import shutil
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = ["--sessions", str(CLI_SESSIONS), "--patients", str(CLI_PATIENTS)]
    serve = ["--hdc-fleet", *base, "--rounds", str(CLI_ROUNDS), "--ckpt-every", "2"]
    art = os.path.join(tmp, "cli_aot")
    out, secs = _cli(["compile", "--aot-dir", art, *base], env, "compile")
    res = {"compile_s": secs, "compile": _line(out, "AOT artifact ->")}
    log(f"[{tag}] CLI compile: {secs:.1f} s; {res['compile'][:160]}")

    out, secs = _cli([*serve, "--aot-dir", art, "--ckpt-dir", os.path.join(tmp, "c_warm")],
                     env, "warm start")
    warm_line = _line(out, "warmup from")
    expect(" 0 compiled" in warm_line and "stale" not in warm_line,
           f"CLI warm start: {warm_line}")
    res.update(warm_s=secs, warm_first_decision_s=_first_decision_s(out), warmup=warm_line,
               stream=_line(out, "stream:"))
    log(f"[{tag}] CLI warm start: {warm_line}; {_line(out, 'first decision:')}; "
        f"{res['stream']}; {secs:.1f} s in all")

    # a fresh copy of the sources: its build directory (build/kernels beside
    # src/) is empty, so only the artifact spares nvcc
    fresh = os.path.join(tmp, "fresh")
    for with_art in (True, False):
        shutil.rmtree(fresh, ignore_errors=True)
        shutil.copytree(ROOT / "src", os.path.join(fresh, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        fenv = dict(env, PYTHONPATH=os.path.join(fresh, "src"))
        args = [*serve, "--ckpt-dir", os.path.join(tmp, f"c_fresh{int(with_art)}")]
        if with_art:
            args += ["--aot-dir", art]
        out, secs = _cli(args, fenv, "fresh start")
        first = _line(out, "first decision:")
        builds = int(first.split("kernel library: ")[1].split()[0])
        expect(builds == (0 if with_art else 1),
               f"CLI fresh start ({'with' if with_art else 'without'} the artifact): {first}")
        key = "fresh_artifact" if with_art else "fresh_build"
        res[key] = {"first_decision_s": _first_decision_s(out), "total_s": secs,
                    "nvcc_builds": builds}
        log(f"[{tag}] CLI cold start {'from the artifact' if with_art else 'building with nvcc'}"
            f" (empty build directory): {first}; {secs:.1f} s in all")
    shutil.rmtree(fresh, ignore_errors=True)

    stale = os.path.join(tmp, "cli_aot_stale")
    shutil.copytree(art, stale)
    with open(os.path.join(stale, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["key"]["kernels"] = "0" * 16
    with open(os.path.join(stale, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    out, secs = _cli([*serve, "--aot-dir", stale, "--ckpt-dir", os.path.join(tmp, "c_stale")],
                     env, "stale artifact")
    expect("is stale" in out and "[stale artifact" in _line(out, "warmup from"),
           f"CLI stale artifact: no warning:\n{out[-2000:]}")
    same = _ckpt_leaves(os.path.join(tmp, "c_stale")) == _ckpt_leaves(os.path.join(tmp, "c_warm"))
    expect(same, "CLI: the stale-artifact run decided otherwise than the warm start")
    for k in ("c_fresh0", "c_fresh1"):
        expect(_ckpt_leaves(os.path.join(tmp, k)) == _ckpt_leaves(os.path.join(tmp, "c_warm")),
               f"CLI: the fresh run {k} decided otherwise than the warm start")
    res["stale"] = _line(out, "warmup from")
    log(f"[{tag}] CLI stale artifact: warned ({res['stale']}); final fleet state equal to "
        "the warm start's, and the fresh runs' too")

    ck = os.path.join(tmp, "c_term")
    p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--hdc-fleet",
                          *base, "--rounds", "1000000", "--aot-dir", art, "--ckpt-dir", ck,
                          "--ckpt-every", "2"], env=env, cwd=str(ROOT),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + CLI_TIMEOUT
        while time.time() < deadline and p.poll() is None:
            if os.path.isdir(ck) and any(d.startswith("step_") and not d.endswith(".tmp")
                                         for d in os.listdir(ck)):
                break
            time.sleep(0.2)
        expect(p.poll() is None, "CLI: the SIGTERM run ended before its first checkpoint")
        t0 = time.perf_counter()
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=CLI_TIMEOUT)
        drain_s = time.perf_counter() - t0
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    expect(p.returncode == 0 and "caught SIGTERM" in out,
           f"CLI SIGTERM: exit {p.returncode}:\n{out[-2000:]}")
    caught = _line(out, "caught SIGTERM")
    out, _ = _cli(["--hdc-fleet", *base, "--rounds", "2", "--aot-dir", art, "--ckpt-dir", ck,
                   "--resume"], env, "resume")
    resumed = _line(out, "resumed fleet from")
    res.update(sigterm=caught, drain_s=drain_s, resumed=resumed)
    log(f"[{tag}] CLI SIGTERM: exit 0, '{caught}' ({drain_s:.2f} s to drain); then "
        f"'{resumed}'")

    out, _ = _cli(["--hdc-fleet", "--sessions", str(MONITOR_CLI_SESSIONS), "--patients", "4",
                   "--rounds", "4", "--channel-health", "--inject-fault", "3:dead"],
                  env, "channel health")
    health = _line(out, "channel health:")
    expect(health.startswith(f"channel health: {MONITOR_CLI_SESSIONS} channel(s)"),
           f"CLI channel health: {health}")
    res["channel_health"] = health
    log(f"[{tag}] CLI --channel-health --inject-fault 3:dead: {health}")
    return res


def deploy_hwmodel(tag: str, records) -> dict:
    """The energy/area model for the four variants on one patient's stream
    of ``HW_WINDOWS`` windows, on the card and on the CPU (equal), and the
    calibrated ratios beside the paper's."""
    from repro_torch.core import hwmodel, im
    from repro_torch.core.pipeline import HDCConfig

    cfg = HDCConfig(spatial_threshold=1)
    codes = records[0][1][1, :HW_WINDOWS * cfg.window].cpu().numpy()

    def reports(device) -> dict:
        sparse = im.make_im(torch.Generator().manual_seed(42), channels=cfg.channels,
                            codes=cfg.codes, dim=cfg.dim, segments=cfg.segments,
                            device=device)
        dense = im.make_dense_im(torch.Generator().manual_seed(7), channels=cfg.channels,
                                 codes=cfg.codes, dim=cfg.dim, device=device)
        es, asc = hwmodel.calibration_factors(sparse, codes, cfg)
        return {v: hwmodel.report(v, dense if v == "dense" else sparse, codes, cfg,
                                  e_scale=es, a_scale=asc) for v in hwmodel.VARIANTS}

    t0 = time.perf_counter()
    card = reports("cuda")
    card_ms = (time.perf_counter() - t0) * 1e3
    cpu = reports("cpu")
    expect(card == cpu, f"{tag}: the hardware model differs between the card and the CPU")
    e = {v: card[v]["energy_total_nj"] for v in card}
    a = {v: card[v]["area_total_mm2"] for v in card}
    ratios = {"energy_vs_naive": e["sparse_naive"] / e["sparse_opt"],
              "area_vs_naive": a["sparse_naive"] / a["sparse_opt"],
              "energy_vs_dense": e["dense"] / e["sparse_opt"],
              "area_vs_dense": a["dense"] / a["sparse_opt"]}
    log(f"[{tag}] hwmodel, 4 variants on {HW_WINDOWS} windows of patient "
        f"{records[0][0]}: card == CPU ({card_ms:.1f} ms on the card); model ratios "
        + ", ".join(f"{k} {v:.2f}x (paper {PAPER_RATIOS[k]:.2f}x)" for k, v in ratios.items())
        + "; energy nJ " + ", ".join(f"{v} {x:.3f}" for v, x in e.items())
        + "; area mm2 " + ", ".join(f"{v} {x:.4f}" for v, x in a.items()))
    return {"ratios": ratios, "energy_nj": e, "area_mm2": a}


def deploy_phase(tag: str, sparse: dict, dense: dict, fit_bank: dict, records) -> dict:
    """Phase 11: deploy and tooling on the card."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"fixed": deploy_fixed(tag, sparse, tmp)}
        out["elastic"] = deploy_elastic(tag, fit_bank, records)
        out.update(deploy_variants(tag, sparse, dense))
        out["hwmodel"] = deploy_hwmodel(tag, records)
        out["cli"] = deploy_cli(tag, tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 11 took {out['phase_s']:.1f} s")
    # the warmed fleets whose captured programs phase 17 audits
    out["fleets"] = {name: out[key].pop("warmed") for name, key in (
        ("sparse_compim", "fixed"), ("dense", "dense"), ("elastic", "elastic"),
        ("faulted", "faulted"))}
    return out


# ---------------------------------------------------------------------------
# phase 17: the program audit on the card
# ---------------------------------------------------------------------------

# the reference's audited program set (``hlo_audit._tiny_programs``):
# (kind, sessions or batch, bucket)
AUDIT_REFERENCE = {("step", 2, 32), ("adapt", 2, None), ("engine", 1, 32),
                   ("engine", 2, 32)}


def _audit_key(name: str) -> tuple:
    """(kind, sessions or batch, bucket) of an audited entry's name."""
    m = re.match(r"engine\.[^.]+\.b(\d+)\.t(\d+)\.", name)
    if m:
        return ("engine", int(m.group(1)), int(m.group(2)))
    m = re.search(r"\.s(\d+)(?:\.t(\d+))?\.(step|adapt)\.", name)
    expect(m is not None, f"audit: an entry name of no known form: {name}")
    return (m.group(3), int(m.group(1)), None if m.group(2) is None else int(m.group(2)))


def _audit_lines(tag: str, report) -> list:
    """Log one line an entry (verdict, state in place, kernels, dtypes)."""
    rows = []
    for e in report.entries:
        hist = " ".join(f"{t}x{n}" for t, n in sorted(e.dtype_histogram.items()))
        exp = "-" if e.expected_in_place is None else e.expected_in_place
        log(f"[{tag}] audit: [{'ok' if e.ok else 'FAIL'}] {e.name} in_place={e.in_place}/"
            f"{exp} replayed={e.replayed} kernels={len(e.kernels)} explicit_i64="
            f"{e.explicit_i64} {e.seconds * 1e3:.1f} ms dtypes: {hist}")
        for p in e.problems:
            log(f"[{tag}]   - {p}")
        rows.append({"name": e.name, "ok": e.ok, "in_place": e.in_place,
                     "expected_in_place": e.expected_in_place, "replayed": e.replayed,
                     "seconds": e.seconds, "dtypes": dict(sorted(e.dtype_histogram.items()))})
    return rows


def _planted_programs(dev) -> dict:
    """Four bodies the audit must refuse, on the card: a leaf rebound
    instead of copied, a ``.item()``, an unpinned ``sum`` over int32, an
    int32 buffer plus an ``arange``."""
    from repro_torch.runtime import graphs

    s = torch.arange(4096, dtype=torch.int32, device=dev)
    x = torch.full((4096,), 3, dtype=torch.int32, device=dev)
    m = torch.arange(4096, dtype=torch.int32, device=dev).reshape(64, 64)
    held = {"s": s}

    def rebinding():
        held["s"] = held["s"] + x
        return (held["s"],)

    def prog(name, body, state=None, eager=None):
        return graphs.Program(name=name, kind="step", body=body, state=state or {},
                              inputs={"x": x, "m": m}, eager=eager)

    return {
        "rebound leaf": (prog("planted.rebound", rebinding, {"s": s},
                              lambda leaves: {"s": leaves["s"] + x}), "in place"),
        "item": (prog("planted.item", lambda: (m + int(m[0, 1].item()),)), "host escapes"),
        "unpinned sum": (prog("planted.sum", lambda: (m.sum(1),)), "64-bit widening"),
        "int32 + arange": (prog("planted.arange", lambda: (m + torch.arange(64, device=dev),)),
                           "64-bit widening"),
    }


def audit_phase(tag: str, fleets: dict) -> dict:
    """Phase 17: (a) ``run_audit()`` on the card with capture, against the
    reference's four entries; (b) the programs phase 11's warmed fleets
    captured, each body audited and its own graph replayed; (c) planted
    faults, each caught."""
    from repro_torch.analysis.audit import audit_entry, audit_fleet, run_audit
    from repro_torch.serve.fleet import FleetState

    t_phase = time.perf_counter()
    n_leaves = len(dataclasses.fields(FleetState))
    t0 = time.perf_counter()
    tiny = run_audit()
    tiny_s = time.perf_counter() - t0
    rows = {"tiny": _audit_lines(tag, tiny)}
    keys = {_audit_key(e.name): e for e in tiny.entries}
    expect(set(keys) == AUDIT_REFERENCE and len(tiny.entries) == 4,
           f"{tag}: run_audit's entries {sorted(keys, key=str)} are not the reference's "
           f"{sorted(AUDIT_REFERENCE, key=str)}")
    expect(tiny.ok and all(e.replayed for e in tiny.entries),
           f"{tag}: run_audit on the card failed or did not replay: "
           f"{[(e.name, e.problems) for e in tiny.entries if not e.ok or not e.replayed]}")
    step = keys[("step", 2, 32)]
    expect(step.in_place == step.expected_in_place == n_leaves,
           f"{tag}: the step wrote {step.in_place}/{step.expected_in_place} leaves in place")
    expect(all(e.kernels == ["hdc_fleet"] for k, e in keys.items() if k[0] != "adapt"),
           f"{tag}: a step or dispatch did not launch the fleet kernel once")
    log(f"[{tag}] (a) run_audit on the card with capture: {len(tiny.entries)} entries ok, "
        f"each replayed, the step in place {step.in_place}/{n_leaves} ({tiny_s:.2f} s)")

    fleet_s = {}
    for name, fleet in fleets.items():
        t0 = time.perf_counter()
        rep = audit_fleet(fleet)
        fleet_s[name] = time.perf_counter() - t0
        rows[name] = _audit_lines(f"{tag}:{name}", rep)
        expect(rep.ok and rep.entries and all(e.replayed for e in rep.entries),
               f"{tag}: {name}: the warmed fleet's programs failed the audit or were not "
               f"all captured: {[(e.name, e.problems) for e in rep.entries if not e.ok]}")
        expect(all(e.in_place == n_leaves for e in rep.entries if e.kind == "step"),
               f"{tag}: {name}: a step did not write its state in place")
        log(f"[{tag}] (b) {name}: {len(rep.entries)} captured programs ok, each body "
            f"audited and its graph replayed ({fleet_s[name]:.2f} s)")

    caught = {}
    for case, (prog, problem) in _planted_programs(torch.device("cuda", 0)).items():
        got = audit_entry(prog, expected_in_place=len(prog.state) or None)
        hits = [p for p in got.problems if problem in p]
        expect(not got.ok and hits,
               f"{tag}: the planted {case} was not caught as '{problem}': {got.problems}")
        caught[case] = hits[0]
    log(f"[{tag}] (c) planted faults caught on the card: "
        + "; ".join(f"{k}: {v[:120]}" for k, v in caught.items()))
    out = {"tiny_s": tiny_s, "fleet_s": fleet_s, "entries": rows, "planted": caught,
           "phase_s": time.perf_counter() - t_phase, "card": CARD}
    log(f"[{tag}] phase 17 took {out['phase_s']:.1f} s on {CARD}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the fleet on several cards (a mesh over torch.distributed ranks,
# tiles over the local cards)
# ---------------------------------------------------------------------------

MESH_STEADY = 4          # steady rounds of 256 cycles, timed in turns at world size 1
MESH_RANKS = 2           # ranks sharing the one card in (b)
MESH_TILE = 256          # (c): four tiles of 256 over the card list
MESH_TIMEOUT = 300       # seconds a rank or CLI subprocess may take
MESH_FAULTS = dict(tables=1e-2, am=1e-2, counts=1e-2, ecc="secded", seed=5)


def _mesh_script(streams: np.ndarray, seed: int) -> list:
    """Chunk lists: two steady rounds of 256 cycles, a ragged round, a
    round of 300 cycles (longer than the largest bucket: two steps)."""
    rng = np.random.default_rng(seed)
    n = streams.shape[0]
    lens = [[256] * n, [256] * n, rng.integers(0, 257, n), [300] * n]
    out, pos = [], 0
    for ln in lens:
        out.append([streams[i, pos:pos + int(ln[i])] for i in range(n)])
        pos += int(max(ln))
    return out


def _flat(decisions) -> dict:
    """A push's decisions as arrays (session, frame index, prediction,
    scores, frame HV), for files a rank reads."""
    rows = [(i, d) for i, ds in enumerate(decisions) for d in ds]
    return {"session": np.asarray([i for i, _ in rows], np.int64),
            "frame_index": np.asarray([d.frame_index for _, d in rows], np.int64),
            "prediction": np.asarray([d.prediction for _, d in rows], np.int64),
            "scores": np.asarray([d.scores for _, d in rows], np.int64).reshape(len(rows), -1),
            "frame_hv": np.asarray([d.frame_hv for _, d in rows], np.uint32).reshape(
                len(rows), -1)}


def _same_flat(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def _save_bank(path: str, bank: dict) -> None:
    from dataclasses import asdict

    arrays, cfgs = {}, {}
    for pid, p in bank.items():
        cfgs[pid] = asdict(p.cfg)
        arrays[f"{pid}.item"] = p.params.item_pos.cpu().numpy()
        arrays[f"{pid}.elec"] = p.params.elec_pos.cpu().numpy()
        arrays[f"{pid}.class_hvs"] = hv_u32(p.class_hvs)
        arrays[f"{pid}.am_counts"] = p.am_state.counts.cpu().numpy()
        arrays[f"{pid}.am_n"] = p.am_state.n.cpu().numpy()
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(cfgs, f)


def _load_bank(path: str, device) -> dict:
    from repro_torch import convert

    with open(path + ".json") as f:
        cfgs = json.load(f)
    a = np.load(path + ".npz")
    return {pid: convert.pipeline_from_arrays(
        cfg, a[f"{pid}.item"], a[f"{pid}.elec"], class_hvs=a[f"{pid}.class_hvs"],
        am_counts=a[f"{pid}.am_counts"], am_n=a[f"{pid}.am_n"], device=device)
        for pid, cfg in cfgs.items()}


def _fleet_kwargs(kind: str, channels: int) -> dict:
    from repro_torch.reliability.faults import FaultConfig

    if kind == "masked":
        return {"channel_masking": True}
    if kind == "faulted":
        return {"faults": FaultConfig(**MESH_FAULTS)}
    return {}


def _mesh_masks(sessions: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(SEED + 41)
    return (rng.random((sessions, channels)) > 0.1).astype(np.uint8)


def mesh_one_rank(tag: str, res: dict, streams: np.ndarray, tmp: str) -> dict:
    """(a) ``make_mesh((1,), ("data",))`` over NCCL at world size 1 (the
    group ``cpu:gloo,cuda:nccl`` over a FileStore): the mesh fleet against
    the unsharded fleet on the card over steady, ragged and 300-cycle
    rounds, steady rounds timed in turns; then the unsharded fleet's
    mid-stream save restored onto the mesh continues equal."""
    import os

    import torch.distributed as dist

    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.fleet import StreamingFleet

    bank = res["bank"]
    owners = res["owners"]
    mesh = make_mesh((1,), ("data",))
    try:
        expect(dist.get_backend() == "cpu:gloo,cuda:nccl",
               f"{tag}: the one-rank group's backend is {dist.get_backend()}")
        plain = StreamingFleet(bank, owners)
        sharded = StreamingFleet(bank, owners, mesh=mesh)
        expect(sharded.n_tiles == 1 and sharded.mesh is mesh, f"{tag}: the mesh fleet's tiles")
        before = fleet_counts_kernel.launches
        n_dec = 0
        for chunks in _mesh_script(streams, SEED + 43):
            a, b = sharded.push(chunks), plain.push(chunks)
            expect(all(_same_decisions(x, y) for x, y in zip(a, b)),
                   f"{tag}: the one-rank mesh fleet differs from the unsharded fleet")
            n_dec += sum(len(d) for d in a)
        mesh_launches = fleet_counts_kernel.launches - before
        expect(_same_state(sharded.state, plain.state), f"{tag}: states differ")
        base = 256 * 2 + 256 + 300
        steady = [[streams[i, base + 256 * j:base + 256 * (j + 1)] for i in range(len(owners))]
                  for j in range(2)]
        mesh_ms, plain_ms = [], []
        for use_mesh in ([True, False, False, True] * MESH_STEADY)[:2 * MESH_STEADY]:
            times, fleet = (mesh_ms, sharded) if use_mesh else (plain_ms, plain)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.push(steady[len(times) % 2])
            times.append((time.perf_counter() - t0) * 1e3)
        root = os.path.join(tmp, "mesh_a")
        plain.save(root, step=0)
        back = StreamingFleet(bank, owners, mesh=mesh)
        expect(back.restore(root) == 0, f"{tag}: restore onto the mesh")
        a, b = back.push(steady[0]), plain.push(steady[0])
        expect(all(_same_decisions(x, y) for x, y in zip(a, b)),
               f"{tag}: the unsharded save restored onto the mesh continues differently")
    finally:
        dist.destroy_process_group()
    out = {"decisions": n_dec, "fleet_launches": mesh_launches, "mesh_round_ms": mesh_ms,
           "plain_round_ms": plain_ms, "mesh_median_ms": float(np.median(mesh_ms)),
           "plain_median_ms": float(np.median(plain_ms))}
    log(f"[{tag}] (a) one-rank NCCL mesh, {len(owners)} sessions: {n_dec} decisions equal "
        f"to the unsharded fleet, {mesh_launches} fleet-kernel launches; steady round in "
        f"turns: mesh median {out['mesh_median_ms']:.3f} ms "
        f"({', '.join(f'{x:.3f}' for x in mesh_ms)}), unsharded median "
        f"{out['plain_median_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in plain_ms)}); "
        f"the unsharded save restored onto the mesh continues equal ({CARD})")
    return out


def mesh_rank_main(rank: int, world: int, work: str) -> int:
    """One rank of (b): a gloo group over a FileStore (NCCL refuses two
    ranks on one card; the mesh fleet's only traffic is host-side), a
    ``(world,)`` data mesh on ``cuda:0``, and the plain, masked and faulted
    mesh fleets on the parent's script against the parent's unsharded
    decisions; the plain fleet saves; timings and launches to a file."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.fleet import StreamingFleet

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        mesh = make_mesh((world,), ("data",), device="cuda:0")
        bank = _load_bank(os.path.join(work, "bank"), "cuda:0")
        with open(os.path.join(work, "spec.json")) as f:
            spec = json.load(f)
        streams = np.load(os.path.join(work, "streams.npy"))
        want = np.load(os.path.join(work, "expect.npz"))
        script = _mesh_script(streams, SEED + 43)
        channels = streams.shape[2]
        fleet_counts_kernel.launches = 0
        out = {"rank": rank, "decisions": 0}
        for kind in ("plain", "masked", "faulted"):
            fleet = StreamingFleet(bank, spec["owners"], mesh=mesh,
                                   **_fleet_kwargs(kind, channels))
            rows = fleet._state_t[0].counts.shape[0]
            expect(rows == len(spec["owners"]) // world, f"rank {rank}: holds {rows} rows")
            if kind == "masked":
                fleet.set_channel_mask(_mesh_masks(len(spec["owners"]), channels))
            for j, chunks in enumerate(script):
                got = _flat(fleet.push(chunks))
                expect(_same_flat(got, {k: want[f"{kind}.{j}.{k}"] for k in got}),
                       f"rank {rank}: {kind} push {j} differs from the unsharded fleet")
                out["decisions"] += len(got["session"])
            if kind == "faulted":
                expect(np.array_equal(fleet.ecc_stats, want["faulted.ecc"]),
                       f"rank {rank}: ECC counts differ")
            if kind == "plain":
                fleet.save(os.path.join(work, "ck"), step=0)
                steady = [streams[i, :256] for i in range(len(spec["owners"]))]
                push_ms, gather_ms = [], []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rounds = fleet.push_raw(steady)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fleet._round_outputs(rounds)
                    t2 = time.perf_counter()
                    push_ms.append((t1 - t0) * 1e3)
                    gather_ms.append((t2 - t1) * 1e3)
                out.update(push_raw_ms=push_ms, collect_gather_ms=gather_ms)
        torch.cuda.synchronize()
        out["fleet_launches"] = fleet_counts_kernel.launches
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_two_ranks(tag: str, res: dict, streams: np.ndarray, tmp: str) -> dict:
    """(b) two processes on the one card, each with half the sessions: the
    plain, masked and faulted (BER 1e-2, SECDED) mesh fleets decide as the
    unsharded fleet on the card on both ranks; the 2-rank save restores at
    world size 1 and continues equal; and ``--hdc-fleet --mesh 2`` under
    ``torch.distributed.run`` against the unsharded CLI."""
    import os

    from repro_torch.serve.fleet import StreamingFleet

    bank, owners = res["bank"], res["owners"]
    work = os.path.join(tmp, "mesh_b")
    os.makedirs(work)
    _save_bank(os.path.join(work, "bank"), bank)
    np.save(os.path.join(work, "streams.npy"), streams)
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"owners": owners}, f)
    script = _mesh_script(streams, SEED + 43)
    channels = streams.shape[2]
    want, plain = {}, None
    for kind in ("plain", "masked", "faulted"):
        fleet = StreamingFleet(bank, owners, **_fleet_kwargs(kind, channels))
        if kind == "masked":
            fleet.set_channel_mask(_mesh_masks(len(owners), channels))
        for j, chunks in enumerate(script):
            want.update({f"{kind}.{j}.{k}": v for k, v in _flat(fleet.push(chunks)).items()})
        if kind == "faulted":
            want["faulted.ecc"] = fleet.ecc_stats
            expect(fleet.ecc_stats.sum() > 0, f"{tag}: the faulted fleet saw no ECC event")
        if kind == "plain":
            plain = fleet
    np.savez(os.path.join(work, "expect.npz"), **want)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                               str(r), str(MESH_RANKS), work], env=env, cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        expect(p.returncode == 0, f"{tag}: rank {r} exited {p.returncode}:\n{o[-3000:]}")
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    expect(all(r["fleet_launches"] > 0 for r in ranks), f"{tag}: a rank launched no fleet kernel")
    # the 2-rank save at world size 1: an unsharded fleet continues equal
    back = StreamingFleet(bank, owners)
    expect(back.restore(os.path.join(work, "ck")) == 0, f"{tag}: restore of the 2-rank save")
    steady = [streams[i, :256] for i in range(len(owners))]
    a, b = back.push(steady), plain.push(steady)
    expect(all(_same_decisions(x, y) for x, y in zip(a, b)),
           f"{tag}: the 2-rank save restored at world size 1 continues differently")

    # the CLI over two ranks on the one card, beside the unsharded CLI
    base = ["--hdc-fleet", "--sessions", str(CLI_SESSIONS), "--patients", str(CLI_PATIENTS),
            "--rounds", str(CLI_ROUNDS), "--device", "cuda:0"]
    cmds = {"mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", str(MESH_RANKS), "-m", "repro_torch.launch.serve",
                     *base, "--mesh", str(MESH_RANKS)],
            "plain": [sys.executable, "-m", "repro_torch.launch.serve", *base]}
    t0 = time.perf_counter()
    cli = {k: subprocess.Popen(c, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    cli_out = {}
    try:
        for k, p in cli.items():
            so, se = p.communicate(timeout=MESH_TIMEOUT)
            expect(p.returncode == 0, f"{tag}: CLI {k} exited {p.returncode}:\n{(so + se)[-3000:]}")
            cli_out[k] = so
    finally:
        for p in cli.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    fleet_lines = [ln for ln in cli_out["mesh"].splitlines() if ln.startswith("fleet:")]
    expect(len(fleet_lines) == 1 and f"mesh {MESH_RANKS} (data)" in fleet_lines[0],
           f"{tag}: the mesh CLI's fleet lines: {fleet_lines}")

    def n_decisions(out: str) -> str:
        return _line(out, "stream:").split("(", 1)[1].split(",")[1].strip()

    expect(n_decisions(cli_out["mesh"]) == n_decisions(cli_out["plain"]),
           f"{tag}: the mesh CLI made {n_decisions(cli_out['mesh'])}, the unsharded "
           f"{n_decisions(cli_out['plain'])}")
    gather = [x for r in ranks for x in r["collect_gather_ms"]]
    out = {"ranks": ranks, "ranks_s": ranks_s, "cli_s": cli_s,
           "cli_stream": _line(cli_out["mesh"], "stream:"),
           "gather_median_ms": float(np.median(gather)),
           "push_raw_median_ms": float(np.median([x for r in ranks for x in r["push_raw_ms"]]))}
    log(f"[{tag}] (b) {MESH_RANKS} ranks on the one card ({len(owners) // MESH_RANKS} "
        f"sessions each): plain, masked and faulted (BER 1e-2, SECDED) decisions equal to the "
        f"unsharded fleet on every rank ({[r['decisions'] for r in ranks]} compared), "
        f"fleet-kernel launches by rank {[r['fleet_launches'] for r in ranks]}; the 2-rank "
        f"save continues equal at world size 1; steady push_raw median "
        f"{out['push_raw_median_ms']:.3f} ms a rank, collect's copy and gather median "
        f"{out['gather_median_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in gather)}); "
        f"ranks {ranks_s:.1f} s; CLI --mesh {MESH_RANKS} under torch.distributed.run: "
        f"{out['cli_stream']} (same decisions as the unsharded CLI; {cli_s:.1f} s) ({CARD})")
    return out


def tiles_over_cards(tag: str, res: dict, streams: np.ndarray, tmp: str) -> dict:
    """(c) four tiles of 256 over the card list ``torch.cuda.device_count()``
    gives and over the patched ``[cuda:0, cuda:0]``: a ``StreamingFleet``
    eager and warmed, and an ``ElasticFleet`` (admit to 1024, spills, an
    eviction, compaction, save, ``from_checkpoint``), each against the same
    fleet on one device."""
    import os

    from repro_torch import device as device_mod
    from repro_torch.serve.fleet import StreamingFleet
    from repro_torch.serve.lifecycle import ElasticFleet

    bank, owners = res["bank"], res["owners"]
    natural = device_mod.local_devices
    lists = {"one": [torch.device("cuda", 0)], "cards": natural("cuda"),
             "cuda0x2": [torch.device("cuda", 0)] * 2}
    script = _mesh_script(streams, SEED + 47)
    runs, n_cmp = {}, 0
    try:
        for name, devs in lists.items():
            device_mod.local_devices = lambda kind, devs=devs: list(devs)
            for warm in ((False, True) if name != "one" else (False,)):
                fleet = StreamingFleet(bank, owners, tile=MESH_TILE)
                expect(fleet.n_tiles == 4 and len(fleet._tile_devs) == 4,
                       f"{tag}: {name}: {fleet.n_tiles} tiles")
                if warm:
                    fleet.warmup()
                runs[(name, warm)] = [fleet.push(c) for c in script] + [fleet.adapt(
                    np.arange(len(owners)) % 2)]
            for (name_, warm), got in runs.items():
                if name_ == name and name != "one":
                    want = runs[("one", False)]
                    for g, w in zip(got[:-1], want[:-1]):
                        expect(all(_same_decisions(x, y) for x, y in zip(g, w)),
                               f"{tag}: {name} (warm={warm}) differs from one device")
                        n_cmp += sum(len(d) for d in g)
                    expect(np.array_equal(got[-1], want[-1]), f"{tag}: {name}: adapt verdicts")
        elastic = {}
        for name, devs in lists.items():
            device_mod.local_devices = lambda kind, devs=devs: list(devs)
            f = ElasticFleet(bank, tile=MESH_TILE, max_tiles=4)
            sids = [f.admit(owners[i]) for i in range(len(owners))]
            expect(f.n_tiles == 4, f"{tag}: elastic {name}: {f.n_tiles} tiles")
            decs = [f.push_sessions({s: streams[i, :256] for i, s in enumerate(sids)})]
            last = f._tile_slices[-1]
            gone = [s for s in sids if last.start <= f.slot_of(s) < last.stop]
            q = MESH_TILE // 4                 # evicted from the first and the last tile
            snaps = f.evict(sids[:q] + gone[-q:])
            expect(f.compact() == 0, f"{tag}: elastic {name}: the last tile still holds sessions")
            f.evict([s for s in gone if s in f.sessions], with_state=False)
            expect(f.compact() == 1, f"{tag}: elastic {name}: compaction")
            for s in sids[:q]:
                f.admit(snaps[s].patient_id, snapshot=snaps[s])
            live = sorted(f.sessions)
            decs.append(f.push_sessions({s: streams[s % len(owners), 256:512] for s in live}))
            root = os.path.join(tmp, f"tiles_{name}")
            f.save(root)
            back = ElasticFleet.from_checkpoint(bank, root, tile=MESH_TILE, max_tiles=4,
                                                warm=False)
            expect(len(back._tile_devs) == back.n_tiles == f.n_tiles,
                   f"{tag}: elastic {name}: restored tiles")
            decs.append(back.push_sessions({s: streams[s % len(owners), 512:768]
                                            for s in live}))
            elastic[name] = decs
        for name in ("cards", "cuda0x2"):
            for g, w in zip(elastic[name], elastic["one"]):
                expect(g.keys() == w.keys() and all(_same_decisions(g[s], w[s]) for s in g),
                       f"{tag}: elastic {name} differs from one device")
                n_cmp += sum(len(d) for d in g.values())
    finally:
        device_mod.local_devices = natural
    log(f"[{tag}] (c) tiles over the local cards ({len(lists['cards'])} card(s) listed) and "
        f"over [cuda:0, cuda:0]: 4 tiles of {MESH_TILE}, eager and warmed fixed fleets and an "
        f"elastic fleet (spills, eviction, compaction, save, from_checkpoint): {n_cmp} "
        f"decisions equal to one device")
    return {"cards": len(lists["cards"]), "compared": n_cmp}


def mesh_phase(tag: str, res: dict) -> dict:
    """Phase 14 on phase 4's ``sparse_compim`` bank and sessions."""
    import tempfile

    t0 = time.perf_counter()
    need = 256 * 2 + 256 + 300 + 512
    streams = _streams(res, len(res["owners"]), need, SEED + 40)
    with tempfile.TemporaryDirectory() as tmp:
        out = {"one_rank": mesh_one_rank(tag, res, streams, tmp),
               "two_ranks": mesh_two_ranks(tag, res, streams, tmp),
               "tiles": tiles_over_cards(tag, res, streams, tmp)}
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 12: the LM zoo's serving path
# ---------------------------------------------------------------------------

# (a) the card against the CPU, float32, TF32 off; (b) full configs in
# bfloat16, full depth unless cut.  Each architecture's settings are one
# LMArch record (LM_ARCH); the defaults are the dense and MoE models'.
LM_CHECK_ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "falcon-mamba-7b",
                  "seamless-m4t-medium", "jamba-1.5-large-398b")
LM_CHECK_LAYERS = 2
LM_CHECK_BATCH, LM_CHECK_STEPS = 2, 8
LM_CHECK_FRAMES = 8        # encoder frames per decoder token (the data module's ratio)
LM_CHECK_TOL = 1e-3        # atol and rtol on the logits; on each cache, the max
                           # abs difference over its largest |value|
LM_CHECK_CONSISTENCY = 1e-3  # float32 prefill/decode consistency on the card, every arch
LM_ARCHS = ("qwen3-0.6b", "internvl2-2b", "deepseek-moe-16b", "falcon-mamba-7b",
            "seamless-m4t-medium", "jamba-1.5-large-398b")
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 512, 32


@dataclasses.dataclass(frozen=True)
class LMArch:
    """Phase 12's settings for one architecture.

    check_cut     (a): "layers" (full width x LM_CHECK_LAYERS layers),
                  "whole" or "reduced" (``cfg.reduced()``)
    check_prompt  (a): prompt length
    logits_rel    (a): None holds the logits at atol = rtol = LM_CHECK_TOL;
                  a number holds them, and the caches, within it of their
                  largest |value|
    tie           (a): (margin, share): a routed id may differ only where the
                  token's top-k margin is below ``margin``, on at most
                  ``share`` of the routed slots
    cut           (b): config overrides of the bf16 run
    consistency   (b): the bf16 prefill/decode consistency limit; None: the
                  logits are all zero, and the run checks why (below)"""

    check_cut: str = "layers"
    check_prompt: int = 64
    logits_rel: float | None = None
    tie: tuple[float, float] = (1e-5, 1e-3)
    cut: dict = dataclasses.field(default_factory=dict)
    consistency: float | None = 5e-2


# The SSM, hybrid and audio models hold their logits relative to their
# largest |value|: the reference's init (ROADMAP queue 3) draws a stacked
# leaf without fan-in dims at 1/sqrt(layers), so their activations run large.
# - falcon: a 300-token prompt is two scan chunks, the second padded.  Its
#   bf16 consistency read 0.2304 on an H100 80GB HBM3 at 700 W: exp(-e dt)
#   turns a bf16 rounding of the large dt into a relative error dt times
#   larger, layer after layer, so the figure measures how far a rounding
#   spreads, not a cast: on the CPU at full width cut to 4-8 layers both
#   packages' bf16 logits lie 0.2-1.1 of their largest value from float32,
#   and the port's consistency exceeds the reference's only through
#   products that round a row by their row count (PERF.md;
#   tests/test_torch_lm_bf16.py).  The limit keeps half the reading again
#   as room.
# - seamless whole (0.98 B parameters): its 24 attention stacks are drawn at
#   1/sqrt(12), not 1/sqrt(1024), so each softmax is near an argmax over 512
#   frames; the card read 1.33e-3 of the largest logit and 2.34e-3 of the
#   largest cache value against the CPU.
# - jamba: (a) at reduced(), one period block of 8 sublayers at d_model 64
#   (a full-width block does not fit a float32 CPU copy), drawn at std 1:
#   float32 is ill-conditioned there (tests/test_torch_lm_serve.py holds both
#   packages' float32 logits within 1e-2 of a float64 run), and the card read
#   2.59e-3 / 3.88e-3 of the largest logit / cache value and one of 1152
#   routed slots flipped at a margin of 4.97e-05, so a tie is a margin
#   below 1e-3 on at most 0.5% of slots.  (b) whole is 398.6 B
#   parameters; one period block at 16 experts is 45.24 B (90.5 GB in bf16),
#   more than the card holds: one block with 4 of its 16 experts, top-2 and
#   every width kept, is 16.25 B (32.5 GB).  Drawn at std 1 at full width,
#   every projection multiplies the residual stream by about sqrt(width), so
#   its square overflows the float32 variance of the final rmsnorm, which
#   then returns zeros, as the reference's does (tests/test_torch_lm.py): its
#   logits are all zero and its consistency 0 / 0.  The run checks that cause
#   (finite values into the final norm, an infinite mean square) and measures
#   time and memory, which do not depend on the values.
LM_ARCH = {
    "falcon-mamba-7b": LMArch(check_prompt=300, logits_rel=LM_CHECK_TOL, consistency=0.35),
    "seamless-m4t-medium": LMArch(check_cut="whole", logits_rel=5e-3),
    "jamba-1.5-large-398b": LMArch(check_cut="reduced", logits_rel=1e-2, tie=(1e-3, 5e-3),
                                   cut={"n_layers": 8, "n_experts": 4}, consistency=None),
}


def _lm_arch(arch: str) -> LMArch:
    return LM_ARCH.get(arch) or LMArch()


# (c) the --arch CLI
LM_CLIS = (["--arch", "qwen3-0.6b", "--batch", "2", "--prompt-len", "128", "--gen", "16"],
           ["--arch", "seamless-m4t-medium", "--batch", "2", "--prompt-len", "128",
            "--gen", "16"])
# the card's dense bf16 tensor-core peak (``runtime/roofline.py``)
PEAK_BF16_FLOPS_S = roofline.PEAK_FLOPS


class _RouteLog:
    """Records every ``moe._route`` call of a block: the routed expert ids
    and each token's top-k margin (the k-th largest router probability less
    the next one), both on the host."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._moe, orig = moe, moe._route

        def route(p, xf, cfg):
            out = orig(p, xf, cfg)
            probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
            top = probs.topk(cfg.experts_per_token + 1, dim=-1).values
            self.calls.append((out[1].cpu(), (top[:, -2] - top[:, -1]).cpu()))
            return out

        self._orig, moe._route = orig, route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._orig
        return False


class _NormInputLog:
    """Records every ``serve._logits`` call: whether the final rmsnorm's
    input is finite, and the least float32 mean square of its rows."""

    def __enter__(self):
        from repro_torch.models import serve

        self.finite, self.min_mean_square = True, float("inf")
        self._serve, orig = serve, serve._logits

        def logits(params, x, cfg):
            xf = x.float()
            self.finite &= bool(torch.isfinite(xf).all())
            self.min_mean_square = min(self.min_mean_square,
                                       float(xf.square().mean(dim=-1).min()))
            return orig(params, x, cfg)

        self._orig, serve._logits = orig, logits
        return self

    def __exit__(self, *exc):
        self._serve._logits = self._orig
        return False


def _route_flips(what: str, card: list, cpu: list, tie: tuple[float, float]):
    """Hold the card's routed expert ids (``_RouteLog`` calls) against the
    CPU's: an id may differ only where the CPU token's top-k margin is
    below ``tie[0]``, on at most ``tie[1]`` of the routed slots.  Returns
    (routed slots, slots that differ, the largest margin where one does)."""
    expect(len(card) == len(cpu), f"{what}: route calls differ")
    tie_margin, tie_share = tie
    slots = flips = 0
    flip_margin = 0.0
    for (ids_a, _), (ids_b, margin) in zip(card, cpu):
        differ = (ids_a != ids_b).any(dim=1)
        if differ.any():
            flip_margin = max(flip_margin, float(margin[differ].max()))
        slots += ids_b.numel()
        flips += int((ids_a != ids_b).sum())
    expect(flip_margin < tie_margin and flips <= tie_share * max(slots, 1),
           f"{what}: {flips} of {slots} routed slots differ (allowed {tie_share:.0e} of "
           f"them), at top-k margins up to {flip_margin:.3g} (allowed below {tie_margin})")
    return slots, flips, flip_margin


def _greedy(model, batch: dict, pos0: int, steps: int, feed=None) -> dict:
    """Prefill, then ``steps`` decode steps from position ``pos0``: each
    step decodes the greedy token, or ``feed``'s (B, steps + 1) tokens when
    given; every step's logits, the greedy tokens and the final caches, on
    the host."""
    from repro_torch.models.params import flatten

    logits, caches = model.prefill(batch, pos0 + steps)
    out = [logits]
    toks = [logits.argmax(-1)[:, None].to(torch.int32)]
    for i in range(steps):
        tok = toks[-1] if feed is None else feed[:, i:i + 1].to(logits.device)
        logits, caches = model.decode_step(tok, caches, pos0 + i)
        out.append(logits)
        toks.append(logits.argmax(-1)[:, None].to(torch.int32))
    return {"logits": [x.cpu() for x in out], "tokens": torch.cat(toks, 1).cpu(),
            "caches": {k: v.cpu() for k, v in flatten(caches).items()}}


def _check_cfg(arch: str):
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg, cut = get_config(arch), _lm_arch(arch).check_cut
    if cut == "reduced":
        return cfg.reduced()
    if cut == "whole":
        return dataclasses.replace(cfg, dtype="float32")
    return dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS, dtype="float32")


def _consistency(params: dict, batch: dict, cfg, pos0: int) -> tuple[float, float]:
    """Decode of the prompt's last token from the cache of its prefix
    against the whole prompt's prefill: (max |difference| over the largest
    |prefill logit|, that largest |logit|; NaN over 0 where every prefill
    logit is 0), MoE at capacity factor 8, where decode drops nothing."""
    import dataclasses

    from repro_torch.models import serve

    ccfg = dataclasses.replace(cfg, capacity_factor=8.0) if cfg.is_moe else cfg
    full, _ = serve.prefill(params, batch, ccfg, pos0)
    prefix = dict(batch, tokens=batch["tokens"][:, :-1])
    _, pcaches = serve.prefill(params, prefix, ccfg, pos0)
    dec, _ = serve.decode_step(params, batch["tokens"][:, -1:], pcaches, pos0 - 1, ccfg)
    scale = float(full.float().abs().max())
    return float((dec.float() - full.float()).abs().max()) / scale if scale else float("nan"), \
        scale


def lm_card_vs_cpu(tag: str, arch: str) -> dict:
    """One CPU draw of the config's float32 cut, copied to the card;
    prefill and greedy decode on the CPU, then on the card fed the CPU's
    tokens, every step's greedy token, logits and the caches held equal."""
    from repro_torch.models.model import LanguageModel
    from repro_torch.models.params import tree_map

    t0 = time.perf_counter()
    cfg = _check_cfg(arch)
    settings = _lm_arch(arch)
    prompt = settings.check_prompt
    gen = torch.Generator().manual_seed(SEED)
    cpu = LanguageModel.init(gen, cfg, device="cpu")
    card = LanguageModel(cfg, tree_map(lambda t: t.cuda(), cpu.params()))
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_CHECK_BATCH, prompt), generator=gen,
                                     dtype=torch.int32)}
    if cfg.family in ("encdec", "audio"):
        batch["frames"] = torch.randn((LM_CHECK_BATCH, LM_CHECK_FRAMES * prompt, cfg.d_model),
                                      generator=gen)
    runs, routes = {}, {}
    for name, m in (("cpu", cpu), ("card", card)):
        with _RouteLog() as rl:
            runs[name] = _greedy(m, {k: v.to(m.device) for k, v in batch.items()}, prompt,
                                 LM_CHECK_STEPS, feed=runs["cpu"]["tokens"] if runs else None)
        routes[name] = rl.calls
    a, b = runs["card"], runs["cpu"]
    expect(torch.equal(a["tokens"], b["tokens"]),
           f"{arch}: greedy tokens differ, card {a['tokens'].tolist()} cpu {b['tokens'].tolist()}")
    rel_tol = settings.logits_rel
    err = cache_err = 0.0
    for i, (x, y) in enumerate(zip(a["logits"], b["logits"])):
        if rel_tol is None:
            expect(torch.allclose(x, y, rtol=LM_CHECK_TOL, atol=LM_CHECK_TOL),
                   f"{arch}: logits of step {i} differ by {float((x - y).abs().max())}")
            err = max(err, float((x - y).abs().max()))
        else:
            rel = float((x - y).abs().max() / y.abs().max())
            expect(bool(torch.isfinite(x).all()) and rel <= rel_tol,
                   f"{arch}: logits of step {i} differ by {rel:.3g} of their largest value")
            err = max(err, rel)
    # The reference's init draws a stacked leaf without fan-in dims at scale
    # 1 / sqrt(layers) (1 for a one-layer stack), so activations, scores and
    # SSM states grow large: the softmax is near an argmax and a float32
    # rounding where two keys nearly tie moves that row's output.  The caches
    # (the SSM state among them) are held relative to their own scale.
    for k, y in b["caches"].items():
        x = a["caches"][k]
        rel = float((x - y).abs().max() / y.abs().max())
        expect(bool(torch.isfinite(x).all()) and rel <= (rel_tol or LM_CHECK_TOL),
               f"{arch}: cache {k} differs by {rel:.3g} of its largest value")
        cache_err = max(cache_err, rel)
    tie_margin = settings.tie[0]
    slots, flips, flip_margin = _route_flips(arch, routes["card"], routes["cpu"], settings.tie)
    cons, _ = _consistency(card.params(), {k: v.cuda() for k, v in batch.items()}, cfg, prompt)
    expect(cons <= LM_CHECK_CONSISTENCY, f"{arch}: float32 prefill/decode consistency "
           f"{cons:.3g} on the card, above {LM_CHECK_CONSISTENCY}")
    cut = (f"full width x {LM_CHECK_LAYERS} layers" if settings.check_cut == "layers"
           else settings.check_cut)
    out = {"arch": arch, "cut": cut, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "prompt": prompt, "frames": batch["frames"].shape[1] if "frames" in batch else 0,
           "max_abs_err" if rel_tol is None else "logits_rel_err": err,
           "cache_rel_err": cache_err, "tokens_equal": True,
           "route_calls": len(routes["cpu"]), "routed_slots": slots, "tie_flips": flips,
           "tie_flip_margin": flip_margin, "consistency": cons,
           "s": time.perf_counter() - t0}
    logit_rule = (f"logits within {LM_CHECK_TOL} (max abs err {err:.3g})" if rel_tol is None
                  else f"logits within {rel_tol} of their largest value ({err:.3g})")
    log(f"[{tag}] card vs CPU, {arch} {cut} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}), float32, batch {LM_CHECK_BATCH} x {prompt}"
        + (f" (+ {out['frames']} encoder frames)" if out["frames"] else "")
        + f" + {LM_CHECK_STEPS} greedy steps: tokens equal, {logit_rule}, caches within "
        f"{rel_tol or LM_CHECK_TOL} of their largest value ({cache_err:.3g}); routed slots "
        f"{slots}, {flips} differ at a near-tie (top-k margin up to {flip_margin:.3g}, "
        f"below {tie_margin}); float32 consistency on the card {cons:.3g} (at most "
        f"{LM_CHECK_CONSISTENCY}); {out['s']:.1f} s")
    del cpu, card, runs
    torch.cuda.empty_cache()
    return out


def _lm_work(cfg, weight_bytes: int, embed_bytes: int, batch: int, prompt: int,
             steps: int, frames: int = 0) -> dict:
    """Least bytes and operations of one prefill of ``batch`` x ``prompt``
    decoder positions (and ``frames`` encoder positions) and of the mean
    decode step after it (bf16 weights and caches, a float32 SSM state).
    Untied, the embedding table is only gathered, so it is not read whole;
    a decode step reads no encoder weight and no cross K/V projection.  The
    index dispatch meets every expert, so every expert's weights count as
    read (prefill and decode alike); the operations count the routed
    tokens only.  Matrix products and attention run at the bf16
    tensor-core peak; the selective scan's six float32 operations a state
    element a position (two multiplies of the combine, the carry's multiply
    and add, the read-out's multiply and add) at the 32-bit peak outside the
    tensor cores."""
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    di, st, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    read = weight_bytes - (0 if cfg.tie_embeddings else embed_bytes)
    attn_w = d * hd * (h + 2 * kv) + h * hd * d
    mamba_w = 2 * d * di + di * (cfg.dt_rank + 2 * st) + cfg.dt_rank * di + di * d + k * di
    mlp_w = 3 * d * cfg.d_ff
    eff = cfg.moe_d_ff or cfg.d_ff
    moe_w = d * cfg.n_experts + (cfg.experts_per_token + cfg.n_shared_experts) * 3 * d * eff
    fam, n = cfg.family, cfg.n_layers
    n_attn, n_mamba, enc_tok, cross = n, 0, 0, False
    if fam == "ssm":
        n_attn, n_mamba, per_tok = 0, n, n * mamba_w
    elif fam == "hybrid":
        nb, p = n // cfg.attn_period, cfg.attn_period
        n_attn, n_mamba = nb, nb * (p - 1)
        per_tok = nb * (attn_w + (p - 1) * mamba_w + p // 2 * (mlp_w + moe_w))
    elif fam in ("encdec", "audio"):
        cross = True
        per_tok = n * (attn_w + 2 * d * h * hd + mlp_w)        # self, cross q and o, MLP
        enc_tok = cfg.enc_layers * (attn_w + mlp_w) + n * 2 * d * kv * hd  # + cross k, v
        read_dec = read - 2 * enc_tok                           # bf16 bytes
    else:
        n_moe = n - cfg.first_k_dense if cfg.is_moe else 0
        per_tok = n * attn_w + (n - n_moe) * mlp_w + n_moe * moe_w
    kv_row = n_attn * kv * hd * 2 * 2                   # k and v of one position, bf16
    state = n_mamba * batch * (di * st * 4 + (k - 1) * di * 2)   # ssm + conv state
    cross_kv = n * batch * frames * kv * hd * 2 * 2 if cross else 0
    t = batch * prompt
    prefill_flops = (2 * t * per_tok + 2 * batch * d * cfg.vocab
                     + n_attn * 4 * batch * h * hd * prompt * (prompt + 1) / 2)
    if cross:
        prefill_flops += (2 * batch * frames * enc_tok
                          + cfg.enc_layers * 4 * batch * h * hd * frames * frames
                          + n * 4 * batch * h * hd * prompt * frames)
    prefill_scan = n_mamba * 6 * t * di * st
    prefill_bytes = (read + t * kv_row + state + cross_kv + t * d * 2
                     + (batch * frames * d * 4 if cross else 0))
    seen = prompt + (steps + 1) / 2                     # mean positions a step attends
    decode_flops = (2 * batch * per_tok + 2 * batch * d * cfg.vocab
                    + n_attn * 4 * batch * h * hd * seen
                    + (n * 4 * batch * h * hd * frames if cross else 0))
    decode_scan = n_mamba * 6 * batch * di * st
    decode_bytes = ((read_dec if cross else read) + batch * seen * kv_row + 2 * state
                    + cross_kv)

    def bound(n_bytes, flops, scan_ops):
        tb, to = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS_S + scan_ops / PEAK_OPS_S
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    pb, pby = bound(prefill_bytes, prefill_flops, prefill_scan)
    db, dby = bound(decode_bytes, decode_flops, decode_scan)
    return {"prefill_bytes": prefill_bytes, "prefill_flops": prefill_flops,
            "prefill_scan_ops": prefill_scan,
            "prefill_bound_ms": pb, "prefill_bound_by": pby,
            "decode_bytes": decode_bytes, "decode_flops": decode_flops,
            "decode_scan_ops": decode_scan,
            "decode_bound_ms": db, "decode_bound_by": dby}


def _profiled(fn) -> dict:
    """One profiled call of ``fn``: host wall to a synchronise, device busy
    and idle share, device kernels (copies and fills aside), and the six
    device entries with the most time (us)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_busy(prof)
    cuda_t = torch.autograd.DeviceType.CUDA
    kernels = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda_t
                  and not e.name().startswith(("Memcpy", "Memset")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1.0 - busy / wall,
            "kernels": kernels, "top_us": [[k[:90], v] for k, v in top]}


def lm_full(tag: str, arch: str) -> dict:
    """The config in bfloat16 on the card, whole or cut as its LMArch says:
    weights drawn there, prefill of LM_BATCH x LM_PROMPT positions (an
    audio model: LM_PROMPT encoder frames and the data module's text
    length; a warm call, a timed one, a profiled one), LM_STEPS greedy
    decode steps (each timed to a synchronise, the last profiled), peak
    memory, and prefill/decode consistency (MoE at capacity factor 8, where
    decode drops nothing) held at its LMArch limit, or, where that is
    None, all-zero logits held to their cause: finite values into the final
    rmsnorm whose float32 mean square overflows."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.models.model import LanguageModel, model_spec
    from repro_torch.models.params import count_params, flatten
    from repro_torch.runtime import steps as steps_mod

    settings = _lm_arch(arch)
    cfg = dataclasses.replace(get_config(arch), **settings.cut)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = LanguageModel.init(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    expect(n_params == count_params(model_spec(cfg)), f"{arch}: parameter count")
    expect(model.embed.dtype == torch.bfloat16, f"{arch}: weights not bfloat16")
    batch = lmdata.synth_batch(gen, cfg, lmdata.ShapeSpec("serve", LM_PROMPT, LM_BATCH,
                                                          "prefill"))
    n_media = cfg.num_media_tokens if cfg.family == "vlm" else 0
    frames = batch["frames"].shape[1] if "frames" in batch else 0
    pos0 = batch["tokens"].shape[1] + n_media           # decoder positions of the prompt
    expect(pos0 == lmdata.text_len(cfg, LM_PROMPT, "prefill") + n_media
           and frames == (LM_PROMPT if cfg.family in ("encdec", "audio") else 0),
           f"{arch}: prompt length")
    params = model.params()
    prefill = steps_mod.make_prefill(cfg, pos0 + LM_STEPS)
    decode = steps_mod.make_decode_step(cfg)

    prefill(params, batch)                      # warm: cuBLAS handles, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_prof = _profiled(lambda: prefill(params, batch))
    finite = torch.isfinite(logits).all()
    for v in flatten(caches).values():
        finite &= torch.isfinite(v).all()
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    step_ms = []
    for i in range(LM_STEPS - 1):
        t0 = time.perf_counter()
        logits, caches = decode(params, tok, caches, pos0 + i)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(logits).all()

    def last_step():
        nonlocal logits
        logits, _ = decode(params, tok, caches, pos0 + LM_STEPS - 1)

    decode_prof = _profiled(last_step)          # the last step, profiled
    finite &= torch.isfinite(logits).all()
    for v in flatten(caches).values():
        finite &= torch.isfinite(v).all()
    expect(bool(finite), f"{arch}: non-finite logits or caches")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = float(np.median(step_ms[1:]))
    del caches, logits

    limit = settings.consistency
    with _NormInputLog() as norm_in:
        rel, logit_scale = _consistency(params, batch, cfg, pos0)
    if limit is None:
        expect(logit_scale == 0.0 and norm_in.finite and norm_in.min_mean_square == float("inf"),
               f"{arch}: the largest |prefill logit| {logit_scale:.3g}, the final norm's input "
               f"finite: {norm_in.finite}, its least float32 mean square "
               f"{norm_in.min_mean_square:.3g} (expected 0, True and inf)")
        held = ("the logits all zero: the final rmsnorm's inputs finite, their float32 mean "
                "square overflowing to inf in every row")
    else:
        expect(rel <= limit, f"{arch}: prefill/decode consistency {rel:.3g} above {limit}")
        held = f"at most {limit}"
    embed_bytes = model.embed.numel() * model.embed.element_size()
    cut = ", ".join(f"{k}={v}" for k, v in settings.cut.items()) or "whole"
    out = {"arch": arch, "cut": cut, "params": n_params, "weight_gb": weight_bytes / 1e9,
           "peak_gb": peak_gb, "init_s": init_s, "prompt": pos0, "frames": frames,
           "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "decode_step_ms": step_ms,
           "prefill_profiled": prefill_prof, "decode_profiled": decode_prof,
           "tok_s": LM_BATCH / (decode_ms / 1e3), "consistency": rel,
           "consistency_limit": limit, "final_norm_input_finite": norm_in.finite,
           "final_norm_min_mean_square": norm_in.min_mean_square,
           "prefill_logit_max": logit_scale,
           "capacity_factor": cfg.capacity_factor if cfg.is_moe else None,
           **_lm_work(cfg, weight_bytes, embed_bytes, LM_BATCH, pos0, LM_STEPS, frames)}
    log(f"[{tag}] {arch} ({cut}) bf16, {n_params / 1e6:.1f} M parameters, "
        f"{out['weight_gb']:.2f} GB weights (drawn in {init_s:.2f} s), peak {peak_gb:.2f} GB: "
        f"prefill {LM_BATCH} x {pos0}" + (f" (+ {frames} encoder frames)" if frames else "")
        + f" in {prefill_ms:.3f} ms (bound {out['prefill_bound_ms']:.3f} ms, "
        f"{out['prefill_bound_by']}; profiled: busy {prefill_prof['busy_ms']:.3f} ms, "
        f"{prefill_prof['kernels']} kernels); decode {decode_ms:.3f} ms a step (median of "
        f"{LM_STEPS - 2} after one warm step; bound {out['decode_bound_ms']:.3f} ms, "
        f"{out['decode_bound_by']}; profiled: busy {decode_prof['busy_ms']:.3f} ms, idle "
        f"{decode_prof['idle']:.1%}, {decode_prof['kernels']} kernels), "
        f"{out['tok_s']:.1f} tok/s; logits and caches finite, the largest |prefill logit| "
        f"{logit_scale:.3g}; consistency {rel:.3g} ({held}"
        + (", capacity factor 8" if cfg.is_moe else "") + ")")
    del model, params, batch
    torch.cuda.empty_cache()
    return out


def lm_cli(tag: str, args: list) -> dict:
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, secs = _cli(args, env, "--arch")
    lines = {p: _line(out, p) for p in ("prefill:", "decode:", "generated token ids")}
    ids = [ln for ln in out.splitlines() if ln.strip().startswith("[")]
    gen = int(args[args.index("--gen") + 1])
    expect(len(ids) == 2 and all(ln.count(",") == gen - 1 for ln in ids),
           f"CLI --arch: token id rows {ids}")
    log(f"[{tag}] CLI {' '.join(args)}: {lines['prefill:']}; {lines['decode:']}; "
        f"{secs:.1f} s in all")
    return {"args": args, "s": secs, **lines}


def lm_phase(tag: str) -> dict:
    """Phase 12: the LM zoo's serving path on the card."""
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        check = [lm_card_vs_cpu(tag, arch) for arch in LM_CHECK_ARCHS]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {"card_vs_cpu": check, "full": [lm_full(tag, arch) for arch in LM_ARCHS],
           "cli": [lm_cli(tag, args) for args in LM_CLIS]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 12 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: LM training
# ---------------------------------------------------------------------------

# (a) the card against the CPU: float32, TF32 off, reduced(attn_kv_chunk=8),
# one CPU draw copied to the card, the same batch, two train steps.  The
# tolerances are the CPU tests' (tests/test_torch_lm_train.py): the losses
# rtol 1e-5, the grad norms 1e-4 (1e-3 at the second step, taken at
# parameters that differ already), each parameter within 1e-2 of its leaf's
# largest update, Adam's eps at 1e-4 (at 1e-8 a rounding of a gradient near
# zero becomes a sizeable share of an update).  jamba (one block at std 1)
# and seamless (attention near an argmax) are ill-conditioned in float32 at
# the reference's init scale (ROADMAP queue 3): as the CPU tests do, their
# normal-init leaves are rescaled to std 1/sqrt(d_model) before both copies
# take them.  Routed expert ids are held with phase 12's tie rule.
TRAIN_CHECK = (("qwen3-0.6b", None), ("internvl2-2b", None), ("deepseek-moe-16b", None),
               ("falcon-mamba-7b", None), ("jamba-1.5-large-398b", None),
               ("seamless-m4t-medium", None), ("seamless-m4t-medium", "encdec"))
TRAIN_RESCALED = ("jamba-1.5-large-398b", "seamless-m4t-medium")
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, TRAIN_CHECK_FRAMES = 2, 24, 40
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_STEP_TOL = 1e-5, 1e-4, 1e-2
TRAIN_CHECK_OPT = dict(warmup_steps=1, total_steps=10, eps=1e-4)
# (b) full width: qwen3-0.6b whole in bf16 (remat on, float32 AdamW state),
# TRAIN_STEPS steps on one repeated batch, the launcher's schedule
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3-0.6b", 4, 512, 20
# (c) the selective scan's backward at full width: falcon-mamba-7b cut to
# two layers, batch 1 x 512 (two scan chunks)
SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS, SSM_TRAIN_SEQ = "falcon-mamba-7b", 2, 512
# (d) the launcher in subprocesses: reduced qwen3 straight and with an
# injected failure (the final losses within the reference's 1e-5), and the
# full-width qwen3 for a few steps
TRAIN_CLI_STEPS, TRAIN_CLI_FULL_STEPS = 8, 5
TRAIN_CLI_TIMEOUT = 300


def _rescaled(cfg, tree: dict) -> dict:
    """Every normal-init leaf ("normal", "small") scaled to std
    1/sqrt(d_model) (a tenth of it for "small")."""
    from repro_torch.models.model import model_spec
    from repro_torch.models.params import flatten, tree_map

    spec = flatten(model_spec(cfg))
    keys = iter(spec)

    def one(t):
        init = spec[next(keys)].init
        if init not in ("normal", "small"):
            return t
        return t * ((0.1 if init == "small" else 1.0) / cfg.d_model ** 0.5 / t.std())

    return tree_map(one, tree)


def train_card_vs_cpu(tag: str, arch: str, family: str | None) -> dict:
    """Two ``make_train_step`` steps on the CPU and on the card from the
    same float32 weights and batch: losses, grad norms, every parameter
    after each step, and the routed expert ids."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import model_spec
    from repro_torch.models.params import flatten, initialize, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as steps_mod

    t0 = time.perf_counter()
    cfg = get_config(arch).reduced(attn_kv_chunk=8, **({"family": family} if family else {}))
    gen = torch.Generator().manual_seed(SEED)
    tree = initialize(gen, model_spec(cfg), torch.float32, "cpu")
    if arch in TRAIN_RESCALED:
        tree = _rescaled(cfg, tree)
    n_media = cfg.num_media_tokens if cfg.family == "vlm" else 0
    shape = (TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ - n_media)
    batch = {k: torch.randint(0, cfg.vocab, shape, generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    if n_media:
        batch["media"] = torch.randn((TRAIN_CHECK_BATCH, n_media, cfg.d_model), generator=gen)
    if cfg.family in ("encdec", "audio"):
        batch["frames"] = torch.randn((TRAIN_CHECK_BATCH, TRAIN_CHECK_FRAMES, cfg.d_model),
                                      generator=gen)
    opt = adamw.OptConfig(**TRAIN_CHECK_OPT)
    p0 = {k: v.clone() for k, v in flatten(tree).items()}
    runs, routes = {}, {}
    for name, dev in (("cpu", "cpu"), ("card", "cuda")):
        params = tree_map(lambda t: t.clone().to(dev), tree)
        state = adamw.init_state(params, opt, device=dev)
        step = steps_mod.make_train_step(cfg, opt)
        b = {k: v.to(dev) for k, v in batch.items()}
        out = []
        with _RouteLog() as rl:
            for _ in range(2):
                params, state, loss, metrics = step(params, state, b)
                out.append({"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
                            "params": {k: v.detach().float().cpu().clone()
                                       for k, v in flatten(params).items()}})
        runs[name], routes[name] = out, rl.calls
    name = arch + (f" as {family}" if family else "")
    loss_err = gnorm_err = step_err = 0.0
    worst = ""                    # the step and leaf of step_err
    for i, (a, b) in enumerate(zip(runs["card"], runs["cpu"])):
        le = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        ge = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
        expect(np.isfinite(a["loss"]) and le <= TRAIN_LOSS_RTOL,
               f"{name}: step {i} loss card {a['loss']} cpu {b['loss']}")
        expect(ge <= TRAIN_GRAD_TOL * (1 + 9 * i),
               f"{name}: step {i} grad norm card {a['grad_norm']} cpu {b['grad_norm']}")
        for k, want in b["params"].items():
            update = float((want - p0[k]).abs().max())
            err = float((a["params"][k] - want).abs().max()) / max(update, 1e-12)
            expect(err <= TRAIN_STEP_TOL, f"{name}: step {i} parameter {k} differs by "
                   f"{err:.3g} of its largest update")
            if err > step_err:
                step_err, worst = err, f"step {i} {k}"
        loss_err, gnorm_err = max(loss_err, le), max(gnorm_err, ge)
    slots, flips, _ = _route_flips(name, routes["card"], routes["cpu"], LMArch().tie)
    out = {"arch": name, "rescaled": arch in TRAIN_RESCALED,
           "losses": [r["loss"] for r in runs["card"]],
           "grad_norms": [r["grad_norm"] for r in runs["card"]], "loss_rel_err": loss_err,
           "grad_norm_rel_err": gnorm_err, "param_err_of_update": step_err, "worst": worst,
           "routed_slots": slots, "tie_flips": flips, "s": time.perf_counter() - t0}
    log(f"[{tag}] card vs CPU, {name} reduced ({cfg.n_layers} layers, d_model {cfg.d_model})"
        + (", weights rescaled to std 1/sqrt(d_model)" if out["rescaled"] else "")
        + f", float32, batch {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}, 2 steps: losses "
        f"{out['losses'][0]:.6f}, {out['losses'][1]:.6f} (rel err {loss_err:.3g}, at most "
        f"{TRAIN_LOSS_RTOL}), grad norms rel err {gnorm_err:.3g}, parameters within "
        f"{step_err:.3g} of their largest update (at most {TRAIN_STEP_TOL}; {worst}); routed slots "
        f"{slots}, {flips} differ; {out['s']:.1f} s")
    return out


def _train_work(cfg, n_params: int, embed_params: int, param_bytes: int, state_bytes: int,
                batch: int, seq: int) -> dict:
    """Least FLOPs and bytes of one train step, the reckoning of
    ``_lm_work``: the matrix products 6 N tokens (8 with per-layer remat:
    the forward runs again in the backward), N the parameters less the
    embedding table; causal attention 4 B h hd L (L + 1) / 2 a layer for a
    forward (x 3 for forward and backward, x 4 with remat); the unembedding
    2 T d V for a forward (x 4: ``chunked_xent`` recomputes its logits in
    the backward); bytes: the parameters read and written, the gradients
    (the parameters' dtype) written and read, ``m`` and ``v`` read and
    written."""
    t = batch * seq
    fwd_passes = 4 if cfg.remat else 3
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    matmul = 2 * fwd_passes * (n_params - embed_params) * t
    attention = fwd_passes * n_attn * 4 * batch * h * hd * seq * (seq + 1) / 2
    unembed = 4 * 2 * t * cfg.d_model * cfg.vocab
    flops = matmul + attention + unembed
    n_bytes = 2 * param_bytes + 2 * param_bytes + 2 * state_bytes
    tb, to = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS_S
    return {"flops": flops, "matmul_flops": matmul, "attention_flops": attention,
            "unembed_flops": unembed, "bytes": n_bytes, "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations"}


def train_full(tag: str) -> dict:
    """qwen3-0.6b whole in bf16 on the card: TRAIN_STEPS steps of
    ``make_train_step`` on one batch of TRAIN_BATCH x TRAIN_SEQ, each timed
    to a synchronise (the loss read back), the last profiled; every loss
    finite and the last below the first."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.models.model import model_spec
    from repro_torch.models.params import flatten, initialize
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as steps_mod

    cfg = get_config(TRAIN_ARCH)
    expect(cfg.remat and cfg.dtype == "bfloat16", f"{TRAIN_ARCH}: remat and bf16 expected")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = initialize(torch.Generator(device="cuda").manual_seed(SEED), model_spec(cfg),
                        torch.bfloat16, "cuda")
    opt = adamw.OptConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 10, 1))
    state = adamw.init_state(params, opt)
    step = steps_mod.make_train_step(cfg, opt)
    batch = lmdata.batch_for_step(cfg, lmdata.ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                                        "train"), 0)
    losses, gnorms, step_ms = [], [], []

    def one():
        nonlocal params, state
        params, state, loss, metrics = step(params, state, batch)
        losses.append(float(loss))
        gnorms.append(float(metrics["grad_norm"]))

    for _ in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        one()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    prof = _profiled(one)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = flatten(params)
    n_params = sum(v.numel() for v in leaves.values())
    param_bytes = sum(v.numel() * v.element_size() for v in leaves.values())
    state_bytes = sum(v.numel() * v.element_size()
                      for part in ("m", "v") for v in flatten(state[part]).values())
    expect(bool(np.isfinite(losses).all()), f"{TRAIN_ARCH}: non-finite loss {losses}")
    expect(losses[-1] < losses[0], f"{TRAIN_ARCH}: the loss did not fall: {losses}")
    steady = step_ms[1:]
    med = float(np.median(steady))
    work = _train_work(cfg, n_params, leaves["embed"].numel(), param_bytes, state_bytes,
                       TRAIN_BATCH, TRAIN_SEQ)
    out = {"arch": TRAIN_ARCH, "params": n_params, "param_gb": param_bytes / 1e9,
           "state_gb": state_bytes / 1e9, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "step_median_ms": med, "step_min_ms": min(steady), "step_max_ms": max(steady),
           "tokens_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3), "peak_gb": peak_gb,
           "profiled": prof, **work}
    log(f"[{tag}] {TRAIN_ARCH} whole, bf16, remat, float32 AdamW state: {n_params / 1e6:.1f} M "
        f"parameters ({out['param_gb']:.2f} GB, state {out['state_gb']:.2f} GB), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps on one batch: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norm {gnorms[0]:.3g} -> {gnorms[-1]:.3g}; "
        f"step {med:.3f} ms median (range {min(steady):.3f}-{max(steady):.3f}, first "
        f"{step_ms[0]:.1f}), {out['tokens_s']:.0f} tokens/s; bound {work['bound_ms']:.3f} ms "
        f"({work['bound_by']}: {work['flops'] / 1e12:.2f} TFLOP, {work['bytes'] / 1e9:.2f} GB); "
        f"profiled step: {prof['wall_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms, idle "
        f"{prof['idle']:.1%}, {prof['kernels']} kernels; peak {peak_gb:.2f} GB")
    log(f"[{tag}] largest device entries of the step (us): " + "; ".join(
        f"{k} {v:.0f}" for k, v in prof["top_us"]))
    del params, state, batch
    torch.cuda.empty_cache()
    return out


def train_ssm_cut(tag: str) -> dict:
    """falcon-mamba-7b at full width cut to SSM_TRAIN_LAYERS layers, bf16,
    batch 1 x SSM_TRAIN_SEQ (two scan chunks): two steps (the first warm),
    loss and grad norm finite, the second step's time, peak memory."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.models.model import model_spec
    from repro_torch.models.params import initialize
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as steps_mod

    cfg = dataclasses.replace(get_config(SSM_TRAIN_ARCH), n_layers=SSM_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = initialize(torch.Generator(device="cuda").manual_seed(SEED), model_spec(cfg),
                        torch.bfloat16, "cuda")
    opt = adamw.OptConfig(total_steps=10, warmup_steps=1)
    state = adamw.init_state(params, opt)
    step = steps_mod.make_train_step(cfg, opt)
    batch = lmdata.batch_for_step(cfg, lmdata.ShapeSpec("train", SSM_TRAIN_SEQ, 1, "train"), 0)
    ms, losses, gnorms = [], [], []
    for _ in range(2):
        t0 = time.perf_counter()
        params, state, loss, metrics = step(params, state, batch)
        losses.append(float(loss))
        gnorms.append(float(metrics["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect(bool(np.isfinite(losses + gnorms).all()),
           f"{SSM_TRAIN_ARCH} cut: non-finite loss {losses} or grad norm {gnorms}")
    out = {"arch": SSM_TRAIN_ARCH, "layers": SSM_TRAIN_LAYERS, "d_inner": cfg.d_inner,
           "seq": SSM_TRAIN_SEQ, "chunks": -(-SSM_TRAIN_SEQ // cfg.ssm_chunk),
           "losses": losses, "grad_norms": gnorms, "step_ms": ms, "peak_gb": peak_gb}
    log(f"[{tag}] {SSM_TRAIN_ARCH} full width x {SSM_TRAIN_LAYERS} layers (d_inner "
        f"{cfg.d_inner}), bf16, remat, batch 1 x {SSM_TRAIN_SEQ} ({out['chunks']} scan chunks): "
        f"loss {losses[0]:.4f}, {losses[1]:.4f}, grad norm {gnorms[0]:.3g}, {gnorms[1]:.3g}, "
        f"finite; step {ms[1]:.1f} ms (first {ms[0]:.1f}); peak {peak_gb:.2f} GB")
    del params, state, batch
    torch.cuda.empty_cache()
    return out


def _done_loss(out: str) -> float:
    return float(_line(out, "done: final_loss=").split("=")[1].split()[0])


def train_cli(tag: str) -> dict:
    """``python -m repro_torch.launch.train`` on the card: reduced qwen3
    straight and with ``--fail-at 5`` (one restart from the step-4
    checkpoint, the final losses within 1e-5), and qwen3-0.6b whole for a
    few steps."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = ["--arch", "qwen3-0.6b", "--reduced", "--steps", str(TRAIN_CLI_STEPS),
            "--ckpt-every", "2", "--fresh", "--batch", "2", "--seq", "32"]
    with tempfile.TemporaryDirectory() as tmp:
        straight, s1 = _cli(base + ["--ckpt-dir", f"{tmp}/a"], env, "train",
                            TRAIN_CLI_TIMEOUT, module="repro_torch.launch.train")
        failed, s2 = _cli(base + ["--ckpt-dir", f"{tmp}/b", "--fail-at", "5"], env,
                          "train --fail-at", TRAIN_CLI_TIMEOUT, module="repro_torch.launch.train")
    expect("restarting from latest checkpoint" in failed and "[resume] restored step 4" in failed,
           f"train --fail-at 5 did not resume from step 4:\n{failed[-2000:]}")
    a, b = _done_loss(straight), _done_loss(failed)
    expect(abs(a - b) < 1e-5, f"train resume: final_loss {b} against the straight run's {a}")
    full, s3 = _cli(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_CLI_FULL_STEPS), "--batch",
                     str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)], env, "train (full width)",
                    TRAIN_CLI_TIMEOUT, module="repro_torch.launch.train")
    full_loss = _done_loss(full)
    expect(np.isfinite(full_loss), f"train (full width): final_loss {full_loss}")
    step_lines = [ln for ln in full.splitlines() if ln.startswith("step ")]
    expect(len(step_lines) == TRAIN_CLI_FULL_STEPS, f"train (full width):\n{full[-2000:]}")
    out = {"straight_final_loss": a, "resumed_final_loss": b, "straight_s": s1,
           "resumed_s": s2, "full_final_loss": full_loss, "full_s": s3,
           "full_steps": step_lines}
    log(f"[{tag}] CLI train, reduced qwen3, {TRAIN_CLI_STEPS} steps: final_loss {a:.4f} "
        f"straight ({s1:.1f} s), {b:.4f} after --fail-at 5 and a restart from step 4 "
        f"({s2:.1f} s); {TRAIN_ARCH} whole, {TRAIN_CLI_FULL_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: {step_lines[-1].strip()}, final_loss {full_loss:.4f} ({s3:.1f} s)")
    return out


def train_phase(tag: str) -> dict:
    """Phase 13: LM training on the card."""
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        check = [train_card_vs_cpu(tag, arch, family) for arch, family in TRAIN_CHECK]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {"card_vs_cpu": check, "full": train_full(tag), "ssm": train_ssm_cut(tag),
           "cli": train_cli(tag)}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 13 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the LM on a mesh
# ---------------------------------------------------------------------------

# (a) float32 (TF32 off), qwen3-0.6b at full width cut to 2 layers: two
# sharded train steps against two unsharded steps (phase 13's bounds), then
# prefill of 2 x 64 and 8 greedy steps with and without seq_sharded_kv
MESH_LM_ARCH, MESH_LM_LAYERS = "qwen3-0.6b", 2
MESH_LM_TRAIN = (2, 128)                 # batch, seq of (a)'s train steps
MESH_LM_PROMPT, MESH_LM_GEN = 64, 8      # (a) and (b): 2 x 64 prompts, 8 greedy steps
# (b) deepseek-moe-16b at full width cut to 2 layers, local_index, float32
MESH_MOE_ARCH = "deepseek-moe-16b"
# (c) qwen3-0.6b whole in bf16 (remat, float32 AdamW state), batch 4 x 512:
# MESH_FULL_STEPS steps each way in turns, then prefill of 4 x 512 and
# MESH_FULL_GEN decode steps each way
MESH_FULL_STEPS, MESH_FULL_GEN = 5, 32
MESH_FULL_LOSS_RTOL = 1e-2
MESH_CLI_TIMEOUT = 300
LM_MESH_DEVICE = "cuda"     # the phase's device (a CPU rehearsal sets "cpu")


def _host(x) -> torch.Tensor:
    """A tensor (a DTensor gathered whole) as a float32 CPU tensor."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().float().cpu()


def _sync() -> None:
    if LM_MESH_DEVICE == "cuda":
        torch.cuda.synchronize()


class _MeshRouteLog(_RouteLog):
    """``_RouteLog`` whose routed ids and router probabilities may be
    DTensors: each call gathers its ids and top-k margins on the host."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls = []
        self._moe, orig = moe, moe._route

        def route(p, xf, cfg):
            out = orig(p, xf, cfg)
            probs = _host(torch.softmax((xf @ p["router"]).float(), dim=-1))
            top = probs.topk(cfg.experts_per_token + 1, dim=-1).values
            self.calls.append((_host(out[1]).long(), top[:, -2] - top[:, -1]))
            return out

        self._orig, moe._route = orig, route
        return self


def _mesh_greedy(prefill, decode, params, batch: dict, pos0: int, steps: int,
                 feed=None) -> dict:
    """``_greedy`` over step functions (``decode(params, tok, caches, pos)``)
    that may place their inputs: every step's logits and the greedy tokens
    on the host; ``feed``: (B, steps + 1) tokens to decode instead."""
    logits, caches = prefill(params, batch)
    out = [_host(logits)]
    toks = [out[-1].argmax(-1)[:, None].to(torch.int32)]
    dev = batch["tokens"].device
    for i in range(steps):
        tok = toks[-1] if feed is None else feed[:, i:i + 1]
        logits, caches = decode(params, tok.to(dev), caches, pos0 + i)
        out.append(_host(logits))
        toks.append(out[-1].argmax(-1)[:, None].to(torch.int32))
    return {"logits": out, "tokens": torch.cat(toks, 1)}


def _mesh_serve_check(tag: str, what: str, cfg, params, mesh, *, seq_sharded_kv: bool,
                      tie=None) -> dict:
    """Prefill of 2 x MESH_LM_PROMPT and MESH_LM_GEN greedy steps, unsharded
    and then on the mesh fed the unsharded tokens: tokens equal, logits
    within LM_CHECK_TOL (atol and rtol), routed ids (``tie``) equal but for
    counted near-ties."""
    from repro_torch.runtime import steps as steps_mod

    g = torch.Generator(device=LM_MESH_DEVICE).manual_seed(SEED + 150)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, MESH_LM_PROMPT), generator=g,
                                     device=LM_MESH_DEVICE, dtype=torch.int32)}
    seq = MESH_LM_PROMPT + MESH_LM_GEN
    with _MeshRouteLog() as r_plain:
        plain = _mesh_greedy(steps_mod.make_prefill(cfg, seq), steps_mod.make_decode_step(cfg),
                             params, batch, MESH_LM_PROMPT, MESH_LM_GEN)
    prefill, _, _ = steps_mod.jit_prefill(cfg, mesh, batch, seq, seq_sharded_kv=seq_sharded_kv)
    built: dict = {}

    def decode(p, tok, caches, pos):
        if not built:                    # jit_decode_step reads the caches' shapes
            built["fn"] = steps_mod.jit_decode_step(
                cfg, mesh, {"tokens": tok, "caches": caches},
                seq_sharded_kv=seq_sharded_kv)[0]
        return built["fn"](p, tok, caches, pos)

    with _MeshRouteLog() as r_mesh:
        sharded = _mesh_greedy(prefill, decode, params, batch, MESH_LM_PROMPT, MESH_LM_GEN,
                               feed=plain["tokens"])
    expect(torch.equal(sharded["tokens"], plain["tokens"]),
           f"{tag} {what}: greedy tokens differ on the mesh")
    diff = max(float((a - b).abs().max()) for a, b in zip(sharded["logits"], plain["logits"]))
    excess = max(float(((a - b).abs() - LM_CHECK_TOL * b.abs()).max())
                 for a, b in zip(sharded["logits"], plain["logits"]))
    expect(excess <= LM_CHECK_TOL, f"{tag} {what}: logits differ by {diff:.3g} (past rtol "
                                   f"{LM_CHECK_TOL} by {excess:.3g})")
    out = {"what": what, "tokens_equal": True, "max_abs_logit_diff": diff}
    if tie is not None:
        slots, flips, margin = _route_flips(f"{tag} {what}", r_mesh.calls, r_plain.calls, tie)
        out.update(routed_slots=slots, routed_flips=flips, flip_margin=margin)
    log(f"[{tag}] {what}: prefill 2 x {MESH_LM_PROMPT} and {MESH_LM_GEN} greedy steps on the "
        f"mesh equal to unsharded (max |logit diff| {diff:.3g})"
        + (f"; routed ids: {out['routed_flips']} of {out['routed_slots']} slots differ"
           if tie is not None else ""))
    return out


def lm_mesh_float32(tag: str, mesh) -> dict:
    """(a) and (b): float32, TF32 off, weights drawn on the phase's device."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.models.model import model_spec
    from repro_torch.models.params import flatten, initialize, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps as steps_mod

    dev = LM_MESH_DEVICE
    cfg = dataclasses.replace(get_config(MESH_LM_ARCH), n_layers=MESH_LM_LAYERS,
                              dtype="float32", remat=False)
    params = initialize(torch.Generator(device=dev).manual_seed(SEED), model_spec(cfg),
                        torch.float32, dev)
    opt = adamw.OptConfig(**TRAIN_CHECK_OPT)
    b, l = MESH_LM_TRAIN
    batch = lmdata.batch_for_step(cfg, lmdata.ShapeSpec("train", l, b, "train"), 0, device=dev)
    plain_step = steps_mod.make_train_step(cfg, opt)
    mesh_step, ctx, _ = steps_mod.jit_train_step(cfg, opt, mesh, batch)
    p0 = {k: v.detach().float().cpu() for k, v in flatten(params).items()}
    pp = tree_map(torch.clone, params)
    pm = tree_map(shd.place, tree_map(torch.clone, params),
                  shd.tree_shardings(model_spec(cfg), ctx))
    sp, sm = adamw.init_state(pp, opt, device=dev), adamw.init_state(pm, opt, device=dev)
    losses = []
    for i in range(2):
        pp, sp, lp, _ = plain_step(pp, sp, batch)
        pm, sm, lm, _ = mesh_step(pm, sm, batch)
        a, c = float(_host(lm)), float(lp)
        losses.append((a, c))
        expect(abs(a - c) <= TRAIN_LOSS_RTOL * abs(c),
               f"{tag} train step {i}: mesh loss {a} against unsharded {c}")
    worst = 0.0
    flat_m = flatten(pm)
    for k, v in flatten(pp).items():
        update = float((v.float().cpu() - p0[k]).abs().max())
        err = float((_host(flat_m[k]) - v.float().cpu()).abs().max())
        worst = max(worst, err / max(update, 1e-12))
    expect(worst <= TRAIN_STEP_TOL, f"{tag} train: a parameter {worst:.3g} of its leaf's "
                                    f"largest update from the unsharded run")
    log(f"[{tag}] (a) {MESH_LM_ARCH} full width x {MESH_LM_LAYERS} layers, float32: two "
        f"train steps of {b} x {l} on the mesh against unsharded, losses "
        + ", ".join(f"{x:.6f}/{y:.6f}" for x, y in losses)
        + f"; every parameter within {worst:.3g} of its leaf's largest update")
    out = {"train_losses": losses, "train_param_excess": worst}
    del pp, pm, sp, sm, flat_m
    out["serve"] = [_mesh_serve_check(tag, "(a) serve", cfg, params, mesh, seq_sharded_kv=False),
                    _mesh_serve_check(tag, "(a) serve, seq_sharded_kv", cfg, params, mesh,
                                      seq_sharded_kv=True)]
    del params
    moe_cfg = dataclasses.replace(get_config(MESH_MOE_ARCH), n_layers=MESH_LM_LAYERS,
                                  dtype="float32", moe_dispatch="local_index")
    mparams = initialize(torch.Generator(device=dev).manual_seed(SEED + 1),
                         model_spec(moe_cfg), torch.float32, dev)
    out["moe"] = _mesh_serve_check(tag, f"(b) {MESH_MOE_ARCH} x {MESH_LM_LAYERS}, local_index",
                                   moe_cfg, mparams, mesh, seq_sharded_kv=False,
                                   tie=_lm_arch(MESH_MOE_ARCH).tie)
    del mparams
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def lm_mesh_full(tag: str, mesh) -> dict:
    """(c) qwen3-0.6b whole in bf16 from one draw: MESH_FULL_STEPS train
    steps each way in turns (losses within MESH_FULL_LOSS_RTOL), one
    profiled step each way, then from each way's trained weights prefill of
    TRAIN_BATCH x TRAIN_SEQ and MESH_FULL_GEN greedy steps; peak memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.models.model import model_spec
    from repro_torch.models.params import initialize, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps as steps_mod

    dev = LM_MESH_DEVICE
    cfg = get_config(TRAIN_ARCH)
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    spec = model_spec(cfg)
    params = initialize(torch.Generator(device=dev).manual_seed(SEED), spec,
                        getattr(torch, cfg.dtype), dev)
    opt = adamw.OptConfig(total_steps=MESH_FULL_STEPS,
                          warmup_steps=max(MESH_FULL_STEPS // 10, 1))
    batch = lmdata.batch_for_step(cfg, lmdata.ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                                        "train"), 0, device=dev)
    mesh_step, ctx, _ = steps_mod.jit_train_step(cfg, opt, mesh, batch)
    run = {"mesh": {"params": tree_map(shd.place, tree_map(torch.clone, params),
                                       shd.tree_shardings(spec, ctx)), "step": mesh_step},
           "plain": {"params": tree_map(torch.clone, params),
                     "step": steps_mod.make_train_step(cfg, opt)}}
    for r in run.values():
        r.update(state=adamw.init_state(r["params"], opt, device=dev), losses=[], ms=[])
    del params

    def one(name):
        r = run[name]
        r["params"], r["state"], loss, _ = r["step"](r["params"], r["state"], batch)
        r["losses"].append(float(_host(loss)))

    for name in (["mesh", "plain", "plain", "mesh"] * MESH_FULL_STEPS)[:2 * MESH_FULL_STEPS]:
        _sync()
        t0 = time.perf_counter()
        one(name)
        run[name]["ms"].append((time.perf_counter() - t0) * 1e3)
    for i, (a, c) in enumerate(zip(run["mesh"]["losses"], run["plain"]["losses"])):
        expect(abs(a - c) <= MESH_FULL_LOSS_RTOL * abs(c),
               f"{tag} (c) step {i}: mesh loss {a} against unsharded {c}")
    prof = {name: _profiled(lambda name=name: one(name)) for name in ("mesh", "plain")}
    train_peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else float("nan")
    out = {"losses": {k: v["losses"] for k, v in run.items()},
           "step_ms": {k: v["ms"] for k, v in run.items()},
           "step_median_ms": {k: float(np.median(v["ms"][1:])) for k, v in run.items()},
           "profiled": {k: {kk: v[kk] for kk in ("wall_ms", "busy_ms", "idle", "kernels")}
                        for k, v in prof.items()},
           "train_peak_gb": train_peak}
    weights = {k: v["params"] for k, v in run.items()}
    del run
    if dev == "cuda":
        torch.cuda.empty_cache()
    prompt = {"tokens": batch["tokens"]}
    seq = TRAIN_SEQ + MESH_FULL_GEN
    prefills = {"mesh": steps_mod.jit_prefill(cfg, mesh, prompt, seq)[0],
                "plain": steps_mod.make_prefill(cfg, seq)}
    serve = {}
    for name in ("plain", "mesh"):
        _sync()
        t0 = time.perf_counter()
        logits, caches = prefills[name](weights[name], prompt)
        _sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = _host(logits).argmax(-1)[:, None].to(torch.int32).to(dev)
        decode = (steps_mod.jit_decode_step(cfg, mesh, {"tokens": tok, "caches": caches})[0]
                  if name == "mesh" else steps_mod.make_decode_step(cfg))
        ms = []
        for i in range(MESH_FULL_GEN):
            t0 = time.perf_counter()
            logits, caches = decode(weights[name], tok, caches, TRAIN_SEQ + i)
            tok = _host(logits).argmax(-1)[:, None].to(torch.int32).to(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        expect(bool(torch.isfinite(_host(logits)).all()), f"{tag} (c) {name}: logits")
        serve[name] = {"prefill_ms": prefill_ms, "decode_ms": ms,
                       "decode_median_ms": float(np.median(ms[1:]))}
        del caches
    out["serve"] = serve
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else float("nan")
    log(f"[{tag}] (c) {TRAIN_ARCH} whole, bf16, remat, float32 AdamW state, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {MESH_FULL_STEPS} steps each way in turns: step median "
        f"mesh {out['step_median_ms']['mesh']:.3f} ms, unsharded "
        f"{out['step_median_ms']['plain']:.3f} ms; losses mesh "
        + ", ".join(f"{x:.4f}" for x in out["losses"]["mesh"]) + ", unsharded "
        + ", ".join(f"{x:.4f}" for x in out["losses"]["plain"])
        + "; profiled step: " + "; ".join(
            f"{k} {v['wall_ms']:.3f} ms, busy {v['busy_ms']:.3f} ms, idle {v['idle']:.1%}, "
            f"{v['kernels']} kernels" for k, v in out["profiled"].items())
        + f"; prefill of {TRAIN_BATCH} x {TRAIN_SEQ}: mesh {serve['mesh']['prefill_ms']:.3f} "
        f"ms, unsharded {serve['plain']['prefill_ms']:.3f} ms; decode step median mesh "
        f"{serve['mesh']['decode_median_ms']:.3f} ms, unsharded "
        f"{serve['plain']['decode_median_ms']:.3f} ms; peak {out['peak_gb']:.2f} GB "
        f"(training {train_peak:.2f}) ({CARD})")
    del weights
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _torchrun(args: list, env: dict, what: str, module: str) -> tuple[str, float]:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    <module> <args>``."""
    return _cli(["--standalone", "--nproc-per-node", "1", "-m", module, *args], env, what,
                MESH_CLI_TIMEOUT, module="torch.distributed.run")


def lm_mesh_cli(tag: str) -> dict:
    """(d) the launchers under ``torch.distributed.run --nproc-per-node 1``:
    train on ``--mesh 1x1`` for 4 steps with checkpoints, resumed on
    ``--mesh 1`` to 8 (restored step 4; the final loss within 1e-5 of the
    same two invocations unsharded), and serve with ``--mesh 1x1
    --seq-sharded-kv`` printing the unsharded launcher's greedy ids.  The
    serving rank runs beside the training ranks, and the unsharded runs
    in this process (``train.main``, ``serve.run_lm``) meanwhile."""
    import argparse
    import contextlib
    import io
    import os
    import re
    import tempfile

    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dev = [] if LM_MESH_DEVICE == "cuda" else ["--device", "cpu"]
    base = ["--arch", "qwen3-0.6b", "--reduced", "--ckpt-every", "2", "--batch", "2",
            "--seq", "32", *dev]
    args = ["--arch", "qwen3-0.6b", "--reduced", "--prompt-len", "32", "--gen", "8", *dev]
    t_serve = time.perf_counter()
    serving = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "repro_torch.launch.serve", *args, "--mesh", "1x1", "--seq-sharded-kv"],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        tr = "repro_torch.launch.train"
        with tempfile.TemporaryDirectory() as tmp:
            m, a = f"{tmp}/mesh", f"{tmp}/plain"
            _, s1 = _torchrun(base + ["--steps", "4", "--fresh", "--mesh", "1x1", "--ckpt-dir",
                                      m], env, "train --mesh 1x1", tr)
            resumed, s2 = _torchrun(base + ["--steps", "8", "--mesh", "1", "--ckpt-dir", m],
                                    env, "train --mesh 1 (resumed)", tr)
            plain = io.StringIO()
            with contextlib.redirect_stdout(plain):
                train_mod.main(base + ["--steps", "4", "--fresh", "--ckpt-dir", a])
                train_mod.main(base + ["--steps", "8", "--ckpt-dir", a])
                serve_mod.run_lm(argparse.Namespace(
                    arch="qwen3-0.6b", reduced=True, batch=2, prompt_len=32, gen=8, mesh=None,
                    seq_sharded_kv=False, device=dev[1] if dev else None))
        sharded, _ = serving.communicate(timeout=MESH_CLI_TIMEOUT)
    finally:
        if serving.poll() is None:
            serving.kill()
            serving.wait()
    s3 = time.perf_counter() - t_serve
    expect(serving.returncode == 0, f"serve --mesh exited {serving.returncode}:\n{sharded[-3000:]}")
    expect("[resume] restored step 4" in resumed,
           f"train --mesh 1 did not resume from step 4:\n{resumed[-2000:]}")
    plain = plain.getvalue()
    lm, lp = _done_loss(resumed), _done_loss(plain)
    expect(abs(lm - lp) < 1e-5, f"train on a mesh: final_loss {lm} against unsharded {lp}")

    def ids(out):
        return re.findall(r"\[(\d)\] \[([\d, ]+)\]", out)

    expect(ids(sharded) == ids(plain) and len(ids(plain)) == 2,
           f"serve --mesh: greedy ids {ids(sharded)} against unsharded {ids(plain)}")
    out = {"train_final_loss": lm, "plain_final_loss": lp, "train_s": s1, "resume_s": s2,
           "serve_s": s3}
    log(f"[{tag}] (d) CLI: train --mesh 1x1, 4 steps ({s1:.1f} s), resumed on --mesh 1 from "
        f"step 4 to 8 ({s2:.1f} s): final_loss {lm:.4f}, unsharded {lp:.4f}; serve --mesh 1x1 "
        f"--seq-sharded-kv beside them ({s3:.1f} s): greedy ids equal to the unsharded "
        f"launcher's")
    return out


def lm_mesh_phase(tag: str) -> dict:
    """Phase 15: the LM on a one-rank NCCL mesh, ``make_mesh((1, 1),
    ("data", "model"))`` (the group ``cpu:gloo,cuda:nccl`` at world size 1),
    held against the unsharded port on the same card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"),
                     device=None if LM_MESH_DEVICE == "cuda" else "cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = {"float32": lm_mesh_float32(tag, mesh)}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        out["full"] = lm_mesh_full(tag, mesh)
    finally:
        dist.destroy_process_group()
    out["cli"] = lm_mesh_cli(tag)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase 15 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the dry-run on fake ranks, and the fleet's stage probes
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "single"), ("deepseek-moe-16b", "decode_32k", "multi"))
DRYRUN_TIMEOUT = 900     # seconds the phase's child process may take
# (a) on a fake (2, 4) world: the reference's small-mesh qwen3 (2 KV heads
# over 4 model ranks), batch 4 x 64, float32, and the per-device counts that
# tests/test_torch_dryrun.py holds on the CPU: prefill and decode flops
# (the reference's analyze_hlo count plus the named K/V excess), the
# arguments' bytes of every step, and the train step within 1.5x the
# reference's 339,738,624 flops.  Counting DTensor's global-shape
# bookkeeping would break every one of them.
DRYRUN_SMALL = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, vocab=1024, d_ff=512)
DRYRUN_SMALL_FLOPS = {"prefill": 105_119_744, "decode": 1_900_544}
DRYRUN_SMALL_ARG_BYTES = {"train": 2_771_972, "prefill": 924_160, "decode": 989_192}
DRYRUN_SMALL_TRAIN_REF = 339_738_624
PROBE_SESSIONS = 64      # (d): the CPU fleet's sessions


def stage_probes_check(tag: str, res: dict) -> dict:
    """Phase 16 (d), run beside phase 5 while phase 4's fleet lives:
    ``stage_probes`` raises on that card fleet, and on a CPU fleet of
    PROBE_SESSIONS sessions over the same bank returns the four stages,
    each run once more here and timed on the host (CPU time, not the
    card's) with its output's shape checked."""
    from repro_torch.serve.fleet import StreamingFleet

    batch = np.stack(res["pushes"][1])                    # a steady round of 256 cycles
    try:
        res["fleet"].stage_probes(batch)
        raised = False
    except ValueError:
        raised = True
    expect(raised, f"{tag}: stage_probes ran on the card fleet")
    cpu_bank = {p: pipe.to("cpu") for p, pipe in res["bank"].items()}
    fleet = StreamingFleet(cpu_bank, res["owners"][:PROBE_SESSIONS])
    probes = fleet.stage_probes(batch[:PROBE_SESSIONS])
    cfg, k1 = res["cfg"], batch.shape[1] // res["cfg"].window + 1
    shapes = {"spatial": (PROBE_SESSIONS, batch.shape[1], cfg.words),
              "temporal": (PROBE_SESSIONS, k1, cfg.dim),
              "am": (PROBE_SESSIONS, k1 - 1, 2)}
    out = {"card_raises": raised, "sessions": PROBE_SESSIONS, "cpu_ms": {}}
    for stage, (fn, scale) in probes.items():
        t0 = time.perf_counter()
        got = fn()
        out["cpu_ms"][stage] = (time.perf_counter() - t0) * 1e3
        if stage in shapes:
            expect(tuple(got.shape) == shapes[stage],
                   f"{tag}: stage {stage} gave {tuple(got.shape)}, not {shapes[stage]}")
        expect(scale == (1 if stage == "ingest" else fleet.n_tiles), f"{tag}: {stage} scale")
    log(f"[{tag}] stage_probes: the card fleet raises; a {PROBE_SESSIONS}-session CPU fleet's "
        "stages, host ms (CPU): " + ", ".join(f"{k} {v:.3f}" for k, v in out["cpu_ms"].items()))
    return out


def _cell_summary(rec: dict) -> dict:
    mem, rf = rec["memory"], rec.get("roofline", {})
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "status": rec["status"], "lower_s": rec["lower_s"],
            "peak_gb": mem["peak_bytes_per_device_est"] / 1e9,
            "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes accessed"],
            "collectives": rec["collectives"], "kernels": rec.get("kernels"),
            "bound_ms": rf["step_time_bound_s"] * 1e3 if rf else None,
            "bound_by": rf.get("bottleneck")}


def dryrun_main(work: str) -> int:
    """Phase 16's child process (the fake process group must not meet the
    parent's NCCL groups): (a) DRYRUN_CELLS and the HDC serving cell on 256
    and 512 fake ranks, each ``ok``; (b) the 1x1 dry-run of phase 13's step
    (TRAIN_ARCH whole, bf16, TRAIN_BATCH x TRAIN_SEQ) against that step run
    on the card: argument bytes equal to the parameters', AdamW state's and
    batch's bytes on the card, flops equal to ``FlopCounterMode``'s count of
    the real step, the peak estimate beside ``max_memory_allocated`` and the
    bound beside ``_train_work``'s; (c) the HDC cell at 1x1: the encoder's
    one fake launch records the bytes and operations of phase 3's bound
    formula (``hdc_encoder/ops.py::work``) at that shape.  Writes
    ``work/dryrun.json``, with DRYRUN_SMALL's cells on a fake (2, 4) world
    held to the CPU test's counts, and the kernel wrappers' launch counts over the
    whole child run, which the parent reports and holds at 0."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm as lmdata
    from repro_torch.kernels.hdc_encoder import ops as enc_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.config import param_count
    from repro_torch.models.model import model_spec
    from repro_torch.models.params import flatten, initialize
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as steps_mod

    t0 = time.perf_counter()
    out: dict = {"fake_device": str(dryrun.fake_device()), "cells": []}
    arts = str(Path(work) / "cells")
    launches = Launches(kernel_wrappers())
    launches.start()
    try:
        for arch, shape, mk in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape, mk, arts, force=True)
            expect(rec["status"] == "ok", f"dryrun {arch} {shape} {mk}: {rec.get('error')}")
            out["cells"].append(_cell_summary(rec))
        rec = dryrun.run_hdc(arts, "single", force=True)
        expect(rec["status"] == "ok", f"dryrun hdc single: {rec.get('error')}")
        out["cells"].append({**_cell_summary(rec), "predictions_per_call":
                             rec["predictions_per_call"]})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    small_cfg = get_config("qwen3-0.6b").reduced(**DRYRUN_SMALL)
    mesh_mod.fake_world(8)
    try:
        mesh = mesh_mod.make_mesh((2, 4), ("data", "model"), device=dryrun.fake_device())
        small = {kind: dryrun.trace_cell(small_cfg, lmdata.ShapeSpec(kind, 64, 4, kind), mesh,
                                         seq_sharded_kv=False)
                 for kind in ("train", "prefill", "decode")}
    finally:
        dist.destroy_process_group()
    out["small_2x4"] = {k: {"flops": v["cost"]["flops"],
                            "arg_bytes": v["memory"]["argument_size_in_bytes"],
                            "peak_bytes": v["memory"]["peak_bytes_per_device_est"],
                            "collectives": v["collectives"]} for k, v in small.items()}
    for kind, v in out["small_2x4"].items():
        log(f"[dryrun] (a) reduced qwen3 {kind} on a fake (2, 4) world: flops {v['flops']}, "
            f"argument bytes {v['arg_bytes']}, peak {v['peak_bytes']}, collectives "
            f"{v['collectives']}")
        expect(v["arg_bytes"] == DRYRUN_SMALL_ARG_BYTES[kind],
               f"dryrun (a) {kind} 2x4: argument bytes {v['arg_bytes']}")
    for kind, want in DRYRUN_SMALL_FLOPS.items():
        expect(out["small_2x4"][kind]["flops"] == want,
               f"dryrun (a) {kind} 2x4: flops {out['small_2x4'][kind]['flops']}, not {want}")
    expect(out["small_2x4"]["train"]["flops"] <= 1.5 * DRYRUN_SMALL_TRAIN_REF,
           f"dryrun (a) train 2x4: flops {out['small_2x4']['train']['flops']}")
    for c in out["cells"]:
        log(f"[dryrun] (a) {c['arch']} {c['shape']} {c['mesh']}: {c['status']} in "
            f"{c['lower_s']} s; peak {c['peak_gb']:.2f} GB a device; "
            + (f"bound {c['bound_ms']:.3f} ms ({c['bound_by']})" if c["bound_ms"] is not None
               else f"kernels {c['kernels']}"))

    # (b) phase 13's step: traced at 1x1, then run on the card
    cfg = get_config(TRAIN_ARCH)
    shape = lmdata.ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt = adamw.OptConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 10, 1))
    tr = dryrun.trace_cell(cfg, shape, None, opt=opt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = initialize(torch.Generator(device="cuda").manual_seed(SEED), model_spec(cfg),
                        torch.bfloat16, "cuda")
    state = adamw.init_state(params, opt)
    batch = lmdata.batch_for_step(cfg, shape, 0)
    leaves = [*flatten(params).values(), *flatten(state["m"]).values(),
              *flatten(state["v"]).values(), state["step"], *batch.values()]
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
    step = steps_mod.make_train_step(cfg, opt)
    with FlopCounterMode(display=False) as fc:
        _, _, loss, _ = step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(v.numel() for v in flatten(params).values())
    param_bytes = sum(v.numel() * v.element_size() for v in flatten(params).values())
    state_bytes = sum(v.numel() * v.element_size()
                      for part in ("m", "v") for v in flatten(state[part]).values())
    bound13 = _train_work(cfg, n_params, flatten(params)["embed"].numel(), param_bytes,
                          state_bytes, TRAIN_BATCH, TRAIN_SEQ)
    n_total, n_active = param_count(cfg)
    terms = roofline.roofline_terms(tr["cost"], tr["collectives"], cfg, shape, None,
                                    n_total=n_total, n_active=n_active)
    b = {"arg_bytes_dryrun": tr["memory"]["argument_size_in_bytes"], "arg_bytes_card": arg_bytes,
         "flops_dryrun": tr["cost"]["flops"], "flops_card": fc.get_total_flops(),
         "peak_est_gb": tr["memory"]["peak_bytes_per_device_est"] / 1e9,
         "max_memory_allocated_gb": peak / 1e9, "lower_s": tr["lower_s"],
         "bytes_dryrun": tr["cost"]["bytes accessed"],
         "bound_ms": terms["step_time_bound_s"] * 1e3, "bound_by": terms["bottleneck"],
         "train_work_bound_ms": bound13["bound_ms"], "loss": float(loss)}
    out["phase13_step"] = b
    log(f"[dryrun] (b) {TRAIN_ARCH} whole, bf16, {TRAIN_BATCH} x {TRAIN_SEQ}, 1x1: argument "
        f"bytes {b['arg_bytes_dryrun']} traced, {b['arg_bytes_card']} on the card; flops "
        f"{b['flops_dryrun']} traced, {b['flops_card']} FlopCounterMode on the card; peak "
        f"estimate {b['peak_est_gb']:.2f} GB, max_memory_allocated {b['max_memory_allocated_gb']:.2f}"
        f" GB; bound {b['bound_ms']:.3f} ms ({b['bound_by']}, {b['bytes_dryrun'] / 1e9:.2f} GB "
        f"moved) beside _train_work's {b['train_work_bound_ms']:.3f} ms; trace "
        f"{b['lower_s']:.1f} s")
    expect(b["arg_bytes_dryrun"] == b["arg_bytes_card"], "dryrun (b): argument bytes differ")
    expect(b["flops_dryrun"] == b["flops_card"], "dryrun (b): flops differ")
    del params, state, batch
    torch.cuda.empty_cache()

    # (c) the HDC cell at 1x1: the encoder's fake launch against the formula
    h = dryrun.trace_hdc(None)
    frames = dryrun.HDC_STREAMS * (dryrun.HDC_CYCLES // 256)
    want = enc_ops.work(frames, 256, 64, 64, 8, 128, n_classes=2)
    got = h["kernels"].get("hdc_encoder", {})
    out["hdc_1x1"] = {"frames": frames, "kernel": got, "work": list(want)}
    log(f"[dryrun] (c) hdc 1x1, {dryrun.HDC_STREAMS} streams x {dryrun.HDC_CYCLES} cycles: "
        f"the encoder's fake launch {got}; the bound formula {want[0]} bytes, {want[1]} "
        "operations")
    expect(got == {"launches": 1, "bytes": want[0], "int_ops": want[1]},
           "dryrun (c): the encoder's recorded work differs from the bound formula")
    launches.stop("dryrun")
    out["launches"] = launches.paths["dryrun"]
    out["child_s"] = time.perf_counter() - t0
    with open(Path(work) / "dryrun.json", "w") as f:
        json.dump(out, f)
    return 0


def dryrun_phase(tag: str, probes: dict) -> dict:
    """Phase 16: ``dryrun_main`` in a child process, and (d), the stage
    probes checked beside phase 5 (``probes``)."""
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dryrun_", dir=str(ROOT / "build"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dryrun", work],
                          capture_output=True, text=True, timeout=DRYRUN_TIMEOUT, cwd=str(ROOT))
    for line in proc.stdout.splitlines():
        if line.startswith("[dryrun]"):
            log(line)
    expect(proc.returncode == 0,
           f"{tag}: the dry-run child exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(Path(work) / "dryrun.json") as f:
        out = json.load(f)
    out["stage_probes"] = probes
    out["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase 16 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.pipeline import HDCConfig
    from repro_torch.data import ieeg

    launches = Launches(kernel_wrappers())
    global CARD
    t_start = time.perf_counter()
    CARD = environment()
    build_kernels()

    t0 = time.perf_counter()
    patients = make_patients()
    rec_t = patients[0][0].records[0].codes.shape[0]
    log(f"[data] {PATIENTS} patients x {SEIZURES} records of {rec_t + 6} samples "
        f"x 64 channels ({time.perf_counter() - t0:.2f} s)")
    frames = rec_t // 256
    shapes = {
        "lbp": (SEIZURES, rec_t + 6, 64),
        "codes": (SEIZURES, rec_t, 64),
        "onboard": (1, 3600 * 512 - 6, 64),     # the onboarding cell's hour of codes
        "encoder": (SEIZURES - 1, frames, 256, 64, 8, 128),
        "am": ((SEIZURES - 1) * frames, 2, 32),
        "fleet": (PATIENTS, SESSIONS, 256, 64, 64, 32, 256),
        "fleet_tile": (PATIENTS, ELASTIC_TILE, 256, 64, 64, 32, 256),
        "dense": ((SEIZURES - 1) * frames, 256, 64, 64, 32),
    }
    kc = check_kernels(shapes)

    # phases 4-5: the main path
    launches.start()
    cfg = HDCConfig()
    codes = lbp_on_card(patients, cfg.lbp_bits)
    records = [(p.pid, c, np.stack([ieeg.frame_labels(r, 256) for r in p.records]),
                [ieeg.onset_frame(r, 256) for r in p.records])
               for (p, _), c in zip(patients, codes)]
    sparse = train_and_detect("sparse_compim", cfg, records, calibrate=True)
    serve_fleet("sparse_compim", sparse, SESSIONS, STEADY_ROUNDS, profile=True)
    launches.stop("sparse_compim")
    probes = {"sparse_compim": infer_probe("sparse_compim", sparse)}
    compare_with_plain("sparse_compim", sparse, COMPARE_SESSIONS)
    stage_probes = stage_probes_check("sparse_compim", sparse)    # phase 16 (d)
    del sparse["fleet"]

    # phase 6: dense, the same codes; fit_iterative and adapt, short
    launches.start()
    res = dense = train_and_detect("dense", HDCConfig(variant="dense"), records,
                                   calibrate=False)
    serve_fleet("dense", res, SESSIONS, STEADY_ROUNDS, profile=True)
    dense_bank = fit_phase("dense", res, patients=1)
    adaptive_fleet("dense", dense_bank, res["records"], DENSE_ADAPT_SESSIONS,
                   DENSE_ADAPT_ROUNDS, compare=DENSE_ADAPT_SESSIONS, loops=0,
                   checkpoint=False)
    launches.stop("dense")
    probes["dense"] = infer_probe("dense", res)
    compare_with_plain("dense", res, COMPARE_SESSIONS)

    # phase 7: sparse_naive, short
    launches.start()
    res = train_and_detect("sparse_naive", HDCConfig(variant="sparse_naive"),
                           naive_records(patients, codes), calibrate=True)
    serve_fleet("sparse_naive", res, NAIVE_SESSIONS, NAIVE_STEADY_ROUNDS,
                profile=False)
    launches.stop("sparse_naive")
    probes["sparse_naive"] = infer_probe("sparse_naive", res)
    compare_with_plain("sparse_naive", res, NAIVE_SESSIONS)

    # phase 8: online adaptation, sessions, the engine and checkpoints on the
    # sparse_compim bank of phase 4
    launches.start()
    fit_bank = fit_phase("online", sparse, patients=PATIENTS)
    online = adaptive_fleet("online", fit_bank, records, SESSIONS, ADAPT_ROUNDS,
                            compare=COMPARE_SESSIONS, loops=LOOP_SESSIONS, checkpoint=True)
    online.update(sessions_on_card("online", fit_bank, records))
    online.update(engine_serve("online", fit_bank, records))
    launches.stop("online")
    online.update(fit_epoch_ms("online", sparse))

    # phase 9: the elastic fleet on the fit_iterative bank of phase 8
    launches.start()
    elastic = elastic_phase("elastic", fit_bank, records)
    launches.stop("elastic")

    # phase 10: reliability on phase 8's bank and phase 6's dense bank
    launches.start()
    rel = reliability_phase("reliability", fit_bank, dense["bank"], records)
    launches.stop("reliability")

    # phase 11: deploy artifacts, CUDA-graph warm-up, the guards, the CLI and
    # the hardware model
    launches.start()
    deploy = deploy_phase("deploy", sparse, dense, fit_bank, records)
    launches.stop("deploy")

    # phase 17: the program audit on the card, while phase 11's warmed fleets live
    launches.start()
    audit = audit_phase("audit", deploy.pop("fleets"))
    launches.stop("audit")

    # phase 14: the fleet on several cards, on phase 4's bank and sessions
    # (run here, before phases 12 and 13 free the HDC tensors)
    launches.start()
    mesh = mesh_phase("mesh", sparse)
    launches.stop("mesh")
    launches.add("mesh", "hdc_fleet",
                 sum(r["fleet_launches"] for r in mesh["two_ranks"]["ranks"]))

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = kc.rows[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches.total(name),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "device_ms": r["device_ms"],
                     **{k: r[k] for k in ("modes", "faulted_bank", "fused", "counts",
                                            "launch_split_us", "fused_launch_split_us")
                        if k in r}})
        if name == "hdc_am":
            rows[-1]["epilogue_launches"] = (launches.total("am_epilogue_sparse")
                                             + launches.total("am_epilogue_dense"))
        if name == "hdc_encoder":
            rows[-1]["counts_launches"] = launches.total("counts_epilogue")
        if name in ("hdc_encoder", "dense_hdc"):  # infer(codes[1:]) on each path
            rows[-1]["infer"] = {p: v for p, v in probes.items()
                                 if (p == "dense") == (name == "dense_hdc")}
        rows[-1]["path_launches"] = {p: c[name] for p, c in launches.paths.items()}
    log("[online] " + json.dumps({k: v for k, v in online.items()
                                  if not isinstance(v, list) or k == "applied"}))
    log("[elastic] " + json.dumps({k: v for k, v in elastic.items()
                                   if k in ("round_median_ms", "stats", "compact_ms",
                                            "from_checkpoint_ms", "replay_ms", "saves",
                                            "save_full4_ms",
                                            "spill_ms", "compared", "replayed_decisions",
                                            "profiled")}))
    log("[reliability] " + json.dumps(
        {k: v if k in ("sweep", "monitor", "phase_s") else
         {kk: vv for kk, vv in v.items() if kk != "round_ms"} for k, v in rel.items()}))
    log("[deploy] " + json.dumps(
        {"fixed": {k: deploy["fixed"][k] for k in (
            "warmup", "warmup_ms", "capture_ms", "graph_median_ms", "eager_median_ms",
            "profiled_graph", "profiled_eager")},
         "elastic": {k: deploy["elastic"][k] for k in (
             "spill_captures", "graph_median_ms", "eager_median_ms", "profiled_graph",
             "profiled_eager")},
         "cli": {k: deploy["cli"][k] for k in (
             "compile_s", "warm_first_decision_s", "fresh_artifact", "fresh_build",
             "drain_s")},
         "hwmodel": deploy["hwmodel"]["ratios"], "phase_s": deploy["phase_s"]}))
    log("[audit] " + json.dumps({k: v for k, v in audit.items() if k != "entries"}))
    log("[mesh] " + json.dumps(
        {"one_rank": mesh["one_rank"], "tiles": mesh["tiles"], "phase_s": mesh["phase_s"],
         "two_ranks": {k: v for k, v in mesh["two_ranks"].items() if k != "ranks"},
         "rank_launches": [r["fleet_launches"] for r in mesh["two_ranks"]["ranks"]],
         "card": CARD}))

    audit_summary = {"tiny_s": audit["tiny_s"], "fleet_s": audit["fleet_s"],
                     "phase_s": audit["phase_s"], "card": CARD,
                     "entries": {k: len(v) for k, v in audit["entries"].items()}}

    # phase 12: the LM zoo's serving path, with the HDC phases' tensors freed
    del (patients, codes, records, sparse, res, dense, dense_bank, fit_bank, online,
         elastic, rel, deploy, mesh, audit)
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_phase("lm")
    log("[lm] " + json.dumps(
        {"card_vs_cpu": lm["card_vs_cpu"],
         "full": [{k: v for k, v in r.items() if k != "decode_step_ms"} for r in lm["full"]],
         "cli_s": [c["s"] for c in lm["cli"]], "phase_s": lm["phase_s"]}))

    # phase 13: LM training
    train = train_phase("train")
    log("[train] " + json.dumps(
        {"card_vs_cpu": train["card_vs_cpu"],
         "full": {k: v for k, v in train["full"].items() if k != "step_ms"},
         "ssm": train["ssm"], "cli": {k: v for k, v in train["cli"].items() if k != "full_steps"},
         "phase_s": train["phase_s"]}))
    # phase 15: the LM on a mesh
    launches.start()
    lm_mesh = lm_mesh_phase("lm_mesh")
    launches.stop("lm_mesh")
    expect(not any(launches.paths["lm_mesh"].values()),
           f"lm_mesh: the LM path launched {launches.paths['lm_mesh']}")
    for row in rows:
        row["path_launches"]["lm_mesh"] = launches.paths["lm_mesh"][row["name"]]
    summary = {"float32": lm_mesh["float32"], "cli": lm_mesh["cli"],
               "full": {k: v for k, v in lm_mesh["full"].items() if k != "step_ms"},
               "phase_s": lm_mesh["phase_s"], "card": CARD}
    log("[lm_mesh] " + json.dumps(summary))
    # phase 16: the dry-run on fake ranks (a child process, which counts its
    # own launches), the stage probes
    dry = dryrun_phase("dryrun", stage_probes)
    launches.paths["dryrun"] = dry.pop("launches")
    expect(not any(launches.paths["dryrun"].values()),
           f"dryrun: the phase launched {launches.paths['dryrun']}")
    for row in rows:
        row["path_launches"]["dryrun"] = launches.paths["dryrun"][row["name"]]
    dry["card"] = CARD
    log("[dryrun] " + json.dumps(dry))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows, "lm_mesh": summary, "dryrun": dry,
                      "audit": audit_summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:   # one rank of phase 14 (b)
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--dryrun"]:      # phase 16's child process
        sys.exit(dryrun_main(sys.argv[2]))
    sys.exit(main())
