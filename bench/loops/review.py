"""Retrospective review of archived recordings: a batch job over an archive.

Set-up makes an archive of recordings in pinned host memory (made on the
device from the seed, then copied out; each patient's share of it), and
each patient's bank: codebooks drawn by the benchmark, then calibrated
(where the configuration says so) and trained one-shot by the program on
one labelled training recording, on the device.  In the window the job
streams recordings through the card in an order drawn from the seed, with
a fixed number in flight: as one request ends on the host, the next is
issued.  One request is the recording copied from host memory to the card
(on one copy stream, so that the copies follow one another over the link),
then, on the request's own stream, the program's LBP kernel on it, that
patient's ``HDCPipeline.infer``, and the scores and predictions copied to
the host.

Correctness: every request that the window finished on a sample of the
archive's recordings (drawn from the seed) is compared, score by score,
with the plain reference; so are the first such request's LBP codes and
each sampled patient's bank.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from bench import codebooks, ieeg_gen, roofline
from bench.reference import hdc as ref
from bench.util import Done, Spans, follow, host_buffer, on, stream, sync, to_host


class Loop:
    kind = "review"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.hdc = ctx.cfg["hdc"]
        self.traffic = ctx.traffic
        self.dev = ctx.device
        self.seed = ctx.seed

    # -- inputs --------------------------------------------------------------

    def _plan(self) -> None:
        """Recording lengths (the archive's files all have one length) and
        seizure counts: one fixed set for every seed, dealt to the
        recordings in an order drawn from the seed."""
        tr, fs = self.traffic, ieeg_gen.FS
        n, pats = tr["recordings"], tr["patients"]
        lengths = [int(round(tr["record_s"] * fs))] * n
        s_lo, s_hi = tr["seizures"]
        counts = [s_lo + i * (s_hi - s_lo + 1) // n for i in range(n)]
        r = ieeg_gen.rng(self.seed, "review.plan")
        self.lengths = [lengths[i] for i in r.permutation(n)]
        self.n_seizures = [counts[i] for i in r.permutation(n)]
        self.owner = [i % pats for i in range(n)]
        self.sampled = sorted(int(i) for i in r.choice(n, tr["compare_recordings"], replace=False))

    def _inputs(self) -> None:
        tr, c, dev = self.traffic, self.hdc["channels"], self.dev
        fs = ieeg_gen.FS
        self.patients = [ieeg_gen.patient(self.seed, p, c) for p in range(tr["patients"])]
        self.archive = []
        for i, t in enumerate(self.lengths):
            sz = ieeg_gen.place_seizures(self.seed, ("archive", i), t, self.n_seizures[i],
                                         tuple(tr["seizure_s"]))
            x = ieeg_gen.recording(self.seed, ("archive", i), self.patients[self.owner[i]],
                                   t, c, sz, dev)
            self.archive.append(to_host(x, dev))
            del x
        pre, ictal, post = (int(s * fs) for s in tr["train_record_s"])
        t_train = pre + ictal + post
        self.train = []
        for p, pat in enumerate(self.patients):
            x = ieeg_gen.recording(self.seed, ("train", p), pat, t_train, c, [(pre, ictal)], dev)
            lab = ieeg_gen.frame_labels([(pre, ictal)], t_train - self.hdc["lbp_bits"],
                                        self.hdc["window"])
            self.train.append((x, torch.as_tensor(lab, device=dev)))
        self.books = [codebooks.draw(self.seed, ("patient", p), self.hdc, dev)
                      for p in range(tr["patients"])]
        sync(dev)

    def _banks(self) -> None:
        from repro_torch.core.pipeline import HDCPipeline
        from repro_torch.kernels.lbp import ops as lbp_ops

        hcfg = self.ctx.hdc_config
        self.banks = []
        for p, (x, lab) in enumerate(self.train):
            pipe = HDCPipeline(params=codebooks.to_program(self.books[p], self.hdc), cfg=hcfg)
            codes = lbp_ops.lbp_codes(x.unsqueeze(0), bits=self.hdc["lbp_bits"])
            if self.cfg["calibrate_target"] is not None:
                pipe = pipe.calibrate_density(codes, target=self.cfg["calibrate_target"])
            self.banks.append(pipe.train_one_shot(codes, lab.unsqueeze(0)))
        sync(self.dev)

    def setup(self, part) -> None:
        with part("data"):
            self._plan()
            self._inputs()
        with part("banks"):
            self._banks()
        with part("warmup"):
            # every recording once through the request path: each shape
            # the window uses, and the allocator's blocks on each stream
            self._run(list(range(len(self.archive))), deadline=None, spans=Spans(False),
                      keep=False)

    # -- the window ----------------------------------------------------------

    def _buffers(self) -> None:
        f_max = max(self.lengths) // self.hdc["window"] + 1
        k = self.hdc["n_classes"]
        n = self.traffic["in_flight"]
        self.bufs = [(host_buffer((f_max, k), torch.int32, self.dev),
                      host_buffer((f_max,), torch.int32, self.dev)) for _ in range(n)]
        self.streams = [stream(self.dev) for _ in range(n)]
        self.copies = stream(self.dev)

    def _issue(self, slot: int, rec: int, spans: Spans, keep_codes: bool):
        from repro_torch.kernels.lbp import ops as lbp_ops

        t0 = time.perf_counter()
        s = self.streams[slot]
        with spans("submit"):
            with on(self.copies):
                x = self.archive[rec].to(self.dev, non_blocking=True)
            follow(s, self.copies, x)
            with on(s):
                codes = lbp_ops.lbp_codes(x.unsqueeze(0), bits=self.hdc["lbp_bits"])
                scores, preds = self.banks[self.owner[rec]].infer(codes)
                f = scores.shape[1]
                hs, hp = self.bufs[slot]
                hs[:f].copy_(scores[0], non_blocking=True)
                hp[:f].copy_(preds[0], non_blocking=True)
                done = Done(self.dev)
        return {"slot": slot, "rec": rec, "t0": t0, "f": f, "done": done,
                "codes": codes[0] if keep_codes else None}

    def _run(self, order, deadline, spans: Spans, keep: bool) -> list[dict]:
        """Serve ``order`` (an iterator of recordings), ``in_flight`` at a
        time, until it ends or the deadline passes; the requests in flight
        then finish.  With ``keep``, the outputs of the sampled recordings
        are kept for the comparison (and the first request's codes of
        each).  Returns every request's record."""
        if not hasattr(self, "bufs"):
            self._buffers()
        order = iter(order)
        inflight, finished = deque(), []

        def issue(slot):
            rec = next(order, None)
            if rec is not None:
                want = keep and rec in self.outputs and rec not in self.kept_codes \
                    and not any(r["rec"] == rec for r in inflight)
                inflight.append(self._issue(slot, rec, spans, want))

        for slot in range(self.traffic["in_flight"]):
            issue(slot)
        while inflight:
            r = inflight.popleft()
            with spans("wait"):
                r.pop("done").wait()
            r["t1"] = time.perf_counter()
            codes = r.pop("codes")
            if keep and r["rec"] in self.outputs:
                hs, hp = self.bufs[r["slot"]]
                self.outputs[r["rec"]].append((hs[:r["f"]].numpy().copy(),
                                               hp[:r["f"]].numpy().copy()))
                if codes is not None:
                    self.kept_codes[r["rec"]] = codes
            finished.append(r)
            if deadline is None or r["t1"] < deadline:
                issue(r["slot"])
        return finished

    def _order(self):
        r = ieeg_gen.rng(self.seed, "review.order")
        n = len(self.archive)
        while True:
            yield from (int(i) for i in r.permutation(n))

    def window(self, seconds: float, spans: Spans) -> dict:
        self.outputs = {rec: [] for rec in self.sampled}
        self.kept_codes = {}
        t_start = time.perf_counter()
        deadline = t_start + seconds
        with spans("window"):
            reqs = self._run(self._order(), deadline, spans, keep=True)
        fs = ieeg_gen.FS
        in_window = [r for r in reqs if r["t1"] <= deadline]
        hours = sum(self.lengths[r["rec"]] / fs / 3600 for r in in_window)
        launches: dict[str, list] = {}
        request_s = 0.0
        for r in reqs:
            work = request_work(self.hdc, self.lengths[r["rec"]])
            for name, w in work.items():
                if name != "request":
                    launches.setdefault(name, []).append(w)
            if r["t1"] <= deadline:
                request_s += roofline.bound_s(*work["request"])
        return {
            "attempted": len(reqs), "failed": 0,
            "metrics": {
                "review_h_per_s": {"value": hours / seconds, "unit": "h/s"},
            },
            "data": {"kind": self.kind, "window_s": seconds, "spans": spans,
                     "launches": launches, "bound_s_in_window": request_s},
        }

    def finish(self) -> None:
        """Keep each sampled patient's bank as the program trained it
        (threshold, class HVs on the host), then free the program's state."""
        self._program_banks = {}
        for rec in self.sampled:
            pipe = self.banks[self.owner[rec]]
            self._program_banks[self.owner[rec]] = (
                pipe.cfg.temporal_threshold, pipe.class_hvs.cpu().numpy())
        for name in ("banks", "bufs", "streams", "copies"):
            self.__dict__.pop(name, None)

    # -- correctness ---------------------------------------------------------

    def reference(self, signal_dtype=torch.float32) -> dict:
        """The reference's codes, scores and predictions for each sampled
        recording, and its bank for each of their patients."""
        banks, out = {}, {}
        for rec in self.sampled:
            p = self.owner[rec]
            if p not in banks:
                x, lab = self.train[p]
                banks[p] = ref.bank(x, lab, self.books[p], self.cfg, signal_dtype)
            r = ref.review(self.archive[rec].to(self.dev), self.books[p], banks[p], self.cfg,
                           signal_dtype)
            out[rec] = {"codes": r["codes"], "scores": r["scores"].cpu().numpy(),
                        "preds": r["preds"].cpu().numpy()}
        return {"banks": banks, "requests": out}

    def program_outputs(self) -> dict:
        return {"banks": self._program_banks, "codes": self.kept_codes,
                "outputs": self.outputs}

    def as_outputs(self, want: dict) -> dict:
        """A reference run in the program's place (the control): outputs
        shaped as ``program_outputs`` gives them."""
        return {"banks": {p: (b["threshold"], ref.pack(b["class_bits"]).cpu().numpy())
                          for p, b in want["banks"].items()},
                "codes": {rec: r["codes"] for rec, r in want["requests"].items()},
                "outputs": {rec: [(r["scores"], r["preds"])]
                            for rec, r in want["requests"].items()}}

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers compared, each with its limit (all exact: 0)."""
        k = self.hdc["n_classes"]
        bank = 0
        for p, b in want["banks"].items():
            thr, words = got["banks"][p]
            bank += int(thr != b["threshold"])
            bank += int(ref.unpack(torch.as_tensor(words), self.hdc["dim"])
                        .ne(b["class_bits"].cpu()).sum())
        codes = scores = preds = missing = 0
        for rec, w in want["requests"].items():
            mine = got["codes"].get(rec)
            if mine is None or mine.shape != w["codes"].shape:
                codes += w["codes"].numel()
            else:
                codes += int(mine.ne(w["codes"]).sum())
            outs = got["outputs"].get(rec, [])
            missing += int(not outs)
            f = w["preds"].shape[0]
            for s, pr in outs:
                n = min(f, pr.shape[0])
                scores += int((s[:n] != w["scores"][:n]).sum()) + abs(f - pr.shape[0]) * k
                preds += int((pr[:n] != w["preds"][:n]).sum()) + abs(f - pr.shape[0])
        return {"code_mismatch": (codes, 0), "score_mismatch": (scores, 0),
                "pred_mismatch": (preds, 0), "bank_mismatch": (bank, 0),
                "recordings_unserved": (missing, 0)}


def request_work(hdc: dict, samples: int) -> dict:
    """Each kernel launch and copy to the card of one request, and the
    request's own work."""
    bits, win = hdc["lbp_bits"], hdc["window"]
    f = (samples - bits) // win
    kernel = "dense_hdc" if hdc["variant"] == "dense" else "hdc_encoder"
    return {"h2d": (samples * hdc["channels"] * 4, 0),
            "lbp": roofline.lbp_work(1, samples, hdc["channels"], bits),
            kernel: roofline.encode_work(hdc, f, hdc["n_classes"]),
            "request": roofline.review_work(hdc, samples)}
