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
   codes, a table too large for shared memory) and for ``lbp`` 7 and 65
   channels (exact equality: all integer or bit arithmetic), with
   CUDA-event times (as the host issues the calls; beside it the device
   time, the calls queued behind a device-side sleep so that the host's
   launch cost is left out) and the card's least time for the same work;
   the fleet and encoder kernels are timed in each mode at the main shape
   (the encoder's thinning at spatial thresholds 2 and 5);
4. the main path (``sparse_compim``) at the paper's geometry: raw iEEG ->
   LBP codes on the card for 16 synthetic patients, per-patient
   calibration + one-shot training, detection on the held-out seizures,
   then a 1024-session streaming fleet (warm-up, steady, profiled, ragged
   and longer-than-bucket rounds; fleet kernel in ``or`` mode);
5. the main path against the plain path on the CPU: one patient's
   training and inference, and the first 32 fleet sessions;
6. the dense path at the paper's geometry: the same 16 patients' codes
   through ``dense_hdc`` and the AM in ``hamming`` mode (one-shot training,
   detection), then a 1024-session dense fleet in the same rounds (fleet
   kernel in ``majority`` mode), held against the CPU plain path as in 5;
7. the ``sparse_naive`` path, short: 2 patients on 2048-cycle slices
   (calibration, training, inference through the encoder kernel with
   thinning forced on) and a 64-session fleet (``thin`` mode), all held
   against the CPU's bit-domain plain path.

Each path's offline chain (calibration, training, inference) runs under
the profiler, which reports its device-busy time by kernel.  Each path's
kernel launches are counted from zero just before it and read just after.
The line before the last is a JSON object with every kernel's launches
over the paths, times and bound; the last line is the device summary.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

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

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the
# 32-bit rate outside the tensor cores, used for the integer/bit operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
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
# the kernels each path must launch
PATH_KERNELS = {
    "sparse_compim": ("lbp", "hdc_encoder", "hdc_am", "hdc_fleet"),
    "dense": ("dense_hdc", "hdc_am", "hdc_fleet"),
    "sparse_naive": ("hdc_encoder", "hdc_am", "hdc_fleet"),
}


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
        """Hold ``kernel()`` against ``plain()`` and time both; ``main``
        marks the case at the main path's shape that the kernel's JSON row
        reports.  ``launches`` counts this check's own launches."""
        before = wrapper.launches
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.shape == want.shape and got.numel() else (0.0 if equal else float("inf"))
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
        return r


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
        d = s * seg_len
        r = kc.compare("hdc_encoder",
                       f"{case} codes{(b, f, win, c)} S={s} L={seg_len} K={k} "
                       f"thin={thin} thr={thr}", enc_ops.encoder,
                       lambda: enc_ops.encoder(codes, item, elec, **kw),
                       lambda: enc_ref.encoder_plain(codes, item, elec, **kw),
                       n_bytes=codes.numel() + item.numel() + elec.numel() + b * f * d // 8,
                       n_ops=codes.numel() * s + b * f * win * d // 32,
                       main=main and not thin, reps=10 if main else 5, plain_reps=2)
        if main:
            modes[f"thin_thr{thr}" if thin else "or"] = r
    kc.rows["hdc_encoder"]["modes"] = modes

    # hdc_am: (B, W) x (C, W) -> (B, C)
    for case, (b, c, w) in (("main", shapes["am"]), ("odd", (7, 5, 3))):
        for mode in ("overlap", "hamming"):
            q, cls = _rand_words(g, b, w), _rand_words(g, c, w)
            kc.compare("hdc_am", f"{case} q{(b, w)} c{(c, w)} {mode}",
                       am_ops.am_search, lambda: am_ops.am_search(q, cls, mode=mode, dim=w * 32),
                       lambda: am_ref.am_search_ref(q, cls, mode=mode, dim=w * 32),
                       n_bytes=(b + c) * w * 4 + b * c * 4, n_ops=b * c * w * 3,
                       main=case == "main" and mode == "overlap", reps=20)

    # Bounds of the two bit-sliced kernels count one operation per
    # (cycle, channel, word): a word operation on bit-sliced counter planes
    # advances the counts of 32 bit positions at once, so a per-bit count
    # (64 operations per word, as the first designs were counted) is no
    # lower bound.

    # hdc_fleet: tables (P, C, K, W), codes (S, T32, C) -> (S, K1, D); the
    # other cases are ragged (random fill levels, lengths 0 to t)
    modes = {}
    for case, (p, s, t, c, k, w, window) in (("main", shapes["fleet"]),
                                            ("odd", (3, 5, 96, 33, 8, 5, 32)),
                                            ("wide", (3, 6, 96, 200, 16, 4, 32)),
                                            ("wider", (2, 5, 64, 300, 8, 2, 32)),
                                            ("k256", (2, 5, 64, 20, 256, 32, 32))):
        tables = _rand_words(g, p, c, k, w)
        owner = torch.randint(0, p, (s,), generator=g, dtype=torch.int32).cuda()
        codes = torch.randint(0, min(k + 4, 256), (s, t, c), generator=g,
                              dtype=torch.uint8).cuda()
        if case == "main":  # a steady round: every session streams t cycles
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
    return kc


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
    it launched, so only device-side events count."""
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}
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
    res.update(pushes=pushes, decisions=decisions, owners=owners)


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

    def total(self, name: str) -> int:
        return sum(c[name] for c in self.paths.values())


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.pipeline import HDCConfig
    from repro_torch.data import ieeg
    from repro_torch.kernels.dense_hdc.ops import dense_encoder
    from repro_torch.kernels.hdc_am.ops import am_search
    from repro_torch.kernels.hdc_encoder.ops import encoder
    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.kernels.lbp.ops import lbp_codes

    launches = Launches({"lbp": lbp_codes, "hdc_encoder": encoder,
                         "hdc_am": am_search, "hdc_fleet": fleet_counts_kernel,
                         "dense_hdc": dense_encoder})
    t_start = time.perf_counter()
    environment()
    build_kernels()

    t0 = time.perf_counter()
    patients = make_patients()
    rec_t = patients[0][0].records[0].codes.shape[0]
    log(f"[data] {PATIENTS} patients x {SEIZURES} records of {rec_t + 6} samples "
        f"x 64 channels ({time.perf_counter() - t0:.2f} s)")
    frames = rec_t // 256
    shapes = {
        "lbp": (SEIZURES, rec_t + 6, 64),
        "encoder": (SEIZURES - 1, frames, 256, 64, 8, 128),
        "am": ((SEIZURES - 1) * frames, 2, 32),
        "fleet": (PATIENTS, SESSIONS, 256, 64, 64, 32, 256),
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
    res = train_and_detect("sparse_compim", cfg, records, calibrate=True)
    serve_fleet("sparse_compim", res, SESSIONS, STEADY_ROUNDS, profile=True)
    launches.stop("sparse_compim")
    compare_with_plain("sparse_compim", res, COMPARE_SESSIONS)

    # phase 6: dense, the same codes
    launches.start()
    res = train_and_detect("dense", HDCConfig(variant="dense"), records,
                           calibrate=False)
    serve_fleet("dense", res, SESSIONS, STEADY_ROUNDS, profile=True)
    launches.stop("dense")
    compare_with_plain("dense", res, COMPARE_SESSIONS)

    # phase 7: sparse_naive, short
    launches.start()
    res = train_and_detect("sparse_naive", HDCConfig(variant="sparse_naive"),
                           naive_records(patients, codes), calibrate=True)
    serve_fleet("sparse_naive", res, NAIVE_SESSIONS, NAIVE_STEADY_ROUNDS,
                profile=False)
    launches.stop("sparse_naive")
    compare_with_plain("sparse_naive", res, NAIVE_SESSIONS)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = kc.rows[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches.total(name),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "device_ms": r["device_ms"],
                     **({"modes": r["modes"]} if "modes" in r else {})})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
