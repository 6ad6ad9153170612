"""Onboarding a patient: a bank calibrated and retrained from labelled
signal, job after job.

Set-up makes a few distinct labelled recordings in pinned host memory (made
on the device from the seed, then copied out).  In the window jobs run back
to back; job ``j`` takes recording ``j`` modulo their number and fresh
codebooks drawn from the seed for that job, copies the recording and its
labels to the card, and runs the program's LBP kernel,
``HDCPipeline.calibrate_density`` (where the configuration calibrates) and
``HDCPipeline.fit_iterative``, then copies the bank (threshold, class HVs,
counter file) to the host.

Correctness: a sample of the finished jobs, drawn from the seed, is worked
out again by the plain reference from the same signal, labels and
codebooks, and compared exactly.
"""

from __future__ import annotations

import time

import torch

from bench import codebooks, ieeg_gen, roofline
from bench.reference import hdc as ref
from bench.util import Spans, sync, to_host


class Loop:
    kind = "onboard"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.hdc = ctx.cfg["hdc"]
        self.traffic = ctx.traffic
        self.dev = ctx.device
        self.seed = ctx.seed

    def _inputs(self) -> None:
        tr, c, dev = self.traffic, self.hdc["channels"], self.dev
        self.t = int(tr["record_s"] * ieeg_gen.FS)
        self.records = []
        for h in range(tr["recordings"]):
            pat = ieeg_gen.patient(self.seed, ("onboard", h), c)
            sz = ieeg_gen.place_seizures(self.seed, ("onboard", h), self.t, tr["seizures"],
                                         tuple(tr["seizure_s"]))
            x = ieeg_gen.recording(self.seed, ("onboard", h), pat, self.t, c, sz, dev)
            lab = ieeg_gen.frame_labels(sz, self.t - self.hdc["lbp_bits"], self.hdc["window"])
            self.records.append((to_host(x, dev), to_host(torch.as_tensor(lab), dev)))
            del x
        sync(dev)

    def setup(self, part) -> None:
        with part("data"):
            self._inputs()
        with part("warmup"):
            for j in range(self.traffic["warmup_jobs"]):
                self._job(-1 - j, Spans(False))
            sync(self.dev)

    def _book(self, job: int) -> dict:
        return codebooks.draw(self.seed, ("job", job), self.hdc, self.dev)

    def _job(self, job: int, spans: Spans) -> dict:
        from repro_torch.core.pipeline import HDCPipeline
        from repro_torch.kernels.lbp import ops as lbp_ops

        x, lab = self.records[job % len(self.records)]
        with spans("h2d"):
            x = x.to(self.dev, non_blocking=True)
            lab = lab.to(self.dev, non_blocking=True)
        with spans("lbp"):
            codes = lbp_ops.lbp_codes(x.unsqueeze(0), bits=self.hdc["lbp_bits"])
            pipe = HDCPipeline(params=codebooks.to_program(self._book(job), self.hdc),
                               cfg=self.ctx.hdc_config)
        if self.cfg["calibrate_target"] is not None:
            with spans("calibrate"):
                pipe = pipe.calibrate_density(codes, target=self.cfg["calibrate_target"])
        with spans("fit"):
            pipe = pipe.fit_iterative(codes, lab.unsqueeze(0), epochs=self.traffic["epochs"])
        with spans("readback"):
            return {"threshold": pipe.cfg.temporal_threshold,
                    "class_hvs": pipe.class_hvs.cpu(),
                    "counts": pipe.am_state.counts.cpu(),
                    "n": pipe.am_state.n.cpu()}

    def window(self, seconds: float, spans: Spans) -> dict:
        self.banks = {}
        t_start = time.perf_counter()
        deadline = t_start + seconds
        job = 0
        with spans("window"):
            while True:
                self.banks[job] = self._job(job, spans)
                job += 1
                if time.perf_counter() >= deadline:
                    break
        elapsed = time.perf_counter() - t_start
        per_job = roofline.onboard_work(self.hdc, self.t, self.traffic["epochs"])
        return {
            "attempted": job, "failed": 0,
            "metrics": {"onboard_ms": {"value": elapsed / job * 1e3, "unit": "ms"}},
            "data": {"kind": self.kind, "window_s": elapsed, "spans": spans, "jobs": job,
                     "bound_s_in_window": job * roofline.bound_s(*per_job)},
        }

    def finish(self) -> None:
        """The banks are on the host already; nothing of the program is kept."""
        sync(self.dev)

    # -- correctness ---------------------------------------------------------

    def sample(self) -> list[int]:
        n = len(self.banks)
        k = min(self.traffic["compare_jobs"], n)
        r = ieeg_gen.rng(self.seed, "onboard.sample")
        return sorted(int(j) for j in r.choice(n, k, replace=False))

    def reference(self, signal_dtype=torch.float32, epochs: int | None = None) -> dict:
        epochs = self.traffic["epochs"] if epochs is None else epochs
        out = {}
        for job in self.sample():
            x, lab = (v.to(self.dev) for v in self.records[job % len(self.records)])
            r = ref.onboard(x, lab, self._book(job), self.cfg, epochs, signal_dtype)
            out[job] = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in r.items()}
        return out

    def program_outputs(self) -> dict:
        return self.banks

    def compare(self, got: dict, want: dict) -> dict:
        thr = hvs = counter = missing = 0
        for job, w in want.items():
            g = got.get(job)
            if g is None:
                missing += 1
                continue
            thr += int(g["threshold"] != w["threshold"])
            hvs += int(ref.unpack(g["class_hvs"], self.hdc["dim"])
                       .ne(ref.unpack(w["class_hvs"], self.hdc["dim"])).sum())
            counter += int(g["counts"].ne(w["counts"]).sum()) + int(g["n"].ne(w["n"]).sum())
        return {"threshold_mismatch": (thr, 0), "class_hv_mismatch": (hvs, 0),
                "counter_mismatch": (counter, 0), "jobs_missing": (missing, 0)}
