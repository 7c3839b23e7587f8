"""The serving mix: a closed loop of ``clients`` clients, each round one
``serve()`` call with one new request from each, sent at the call.

A round's prompt lengths are a stratified draw of the mix's distribution
(the i-th request takes the quantile (i + u) / n, u uniform from the seed
and the round), its answer budgets likewise over their range, paired in
an order drawn from the seed: every round has the same spread of sizes,
and the seed changes which sizes meet and the token ids.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from . import judge, program, trace, weights


def _seed64(seed: int) -> int:
    return int(seed) % (1 << 64)


class ServeRun:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.conf, self.mix = cell.config, cell.traffic
        self.cfg = program.arch(self.conf)
        self.n = self.mix["clients"]
        self.rounds: List[dict] = []
        self.sent = 0

    # -- traffic ------------------------------------------------------------
    def round(self, r: int) -> List[tuple]:
        """Round r's requests: [(prompt int32 ids, max_new)]."""
        rng = np.random.default_rng([_seed64(self.seed), r])
        pr, mn = self.mix["prompt"], self.mix["max_new"]
        nd = statistics.NormalDist()
        q = (np.arange(self.n) + rng.random(self.n)) / self.n
        lens = [int(min(max(round(pr["median"] * math.exp(
            pr["sigma"] * nd.inv_cdf(float(x)))), pr["min"]), pr["max"]))
            for x in q]
        span = mn["max"] - mn["min"] + 1
        news = [mn["min"] + int((i + u) / self.n * span)
                for i, u in enumerate(rng.random(self.n))]
        lens = [lens[i] for i in rng.permutation(self.n)]
        news = [news[i] for i in rng.permutation(self.n)]
        return [(rng.integers(1, self.cfg.vocab_size, size=L,
                              dtype=np.int64).astype(np.int32), m)
                for L, m in zip(lens, news)]

    # -- the program ----------------------------------------------------------
    def setup(self):
        from repro_torch.models import registry as R
        tree = R.init_params(self.cfg, device="meta")
        self.template = weights.flatten(tree)
        flat = weights.make(self.template, program.sizes(self.conf),
                            self.seed, self.device)
        self.params = weights.unflatten_into(tree, flat)
        del flat
        self.routes0 = program.launches_by_route()
        pr, mn = self.mix["prompt"], self.mix["max_new"]
        rng = np.random.default_rng([_seed64(self.seed), 1 << 40])
        warm = [(rng.integers(1, self.cfg.vocab_size, size=pr["max"],
                              dtype=np.int64).astype(np.int32), mn["max"])
                for _ in range(self.n)]
        self._serve(warm)

    def _serve(self, reqs):
        from repro_torch.launch.serve import Request, serve
        rs = [Request(self.sent + i, p, m) for i, (p, m) in enumerate(reqs)]
        self.sent += len(rs)
        plen = max(len(p) for p, _ in reqs)
        t_send = time.time()
        for r in rs:
            r.t_submit = t_send
        done = serve(self.cfg, rs, slots=self.mix["slots"],
                     ctx_len=plen + self.mix["ctx_pad"], params=self.params,
                     moe_dispatch=self.conf["as_run"]["moe_dispatch"],
                     device=self.device)
        return rs, done, t_send

    def _record(self, r: int, reqs, rs, done, t_send) -> dict:
        by_id = {d.rid: d for d in done}
        rec = {"round": r, "plen": max(len(p) for p, _ in reqs),
               "prompts": [p for p, _ in reqs],
               "max_new": [m for _, m in reqs], "served": [],
               "latency_s": []}
        for req in rs:
            d = by_id.get(req.rid)
            ok = d is not None and d.t_done is not None and \
                len(d.generated) == req.max_new
            rec["served"].append(list(d.generated) if ok else None)
            rec["latency_s"].append(d.t_done - t_send if ok else None)
        return rec

    def window(self, seconds: float) -> dict:
        """Whole rounds until ``seconds`` have passed; ``step_s`` holds each
        round's time."""
        t0 = time.perf_counter()
        r = 0
        ends = []
        while True:
            reqs = self.round(r)
            rs, done, t_send = self._serve(reqs)
            ends.append(time.perf_counter())
            self.rounds.append(self._record(r, reqs, rs, done, t_send))
            r += 1
            if ends[-1] - t0 >= seconds:
                break
        el = time.perf_counter() - t0
        ok = [(len(p), len(s)) for rec in self.rounds
              for p, s in zip(rec["prompts"], rec["served"]) if s is not None]
        lat = [x for rec in self.rounds for x in rec["latency_s"]
               if x is not None]
        n_sent = sum(len(rec["prompts"]) for rec in self.rounds)
        self.stats = {"seconds": el, "rounds": r, "sent": n_sent,
                      "failed": n_sent - len(ok), "completed": ok,
                      "tokens": sum(a + b for a, b in ok),
                      "latency_s": lat,
                      "step_s": [b - a for a, b in zip([t0] + ends, ends)]}
        return self.stats

    def traced(self) -> trace.Trace:
        n = self.mix["traced_rounds"]
        first = len(self.rounds)
        info = []
        with trace.Window() as w:
            for r in range(first, first + n):
                reqs = self.round(r)
                with torch.profiler.record_function("portbench.serve_round"):
                    self._serve(reqs)
                info.append([len(p) for p, _ in reqs])
        done_tokens = sum(sum(lens) + sum(m for _, m in self.round(r))
                          for r, lens in zip(range(first, first + n), info))
        self.traced_info = {"rounds": n, "prompt_lens": info,
                            "tokens": done_tokens}
        return w.trace

    def end_to_end(self) -> dict:
        s = self.stats
        # a request that never completed counts as slower than any other
        lat = s["latency_s"] + [math.inf] * s["failed"]
        with np.errstate(invalid="ignore"):
            p95 = float(np.percentile(lat, 95))
        return {"serve_tokens_per_s": s["tokens"] / s["seconds"],
                "request_ms_p95": math.inf if math.isnan(p95) else 1e3 * p95}

    def attempted_failed(self):
        return self.stats["sent"], self.stats["failed"]

    def off_route(self) -> int:
        return program.off_route(self.routes0, program.launches_by_route(),
                                 "wgmma_bf16")

    def release(self):
        del self.params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------
    def sample(self) -> Dict[int, List[int]]:
        """{round: [request index]} checked: the longest request's round (a
        mixture of experts: whole rounds, whose requests meet in routing)
        or the longest request (a dense model), then others drawn from the
        seed until ``check_served_tokens`` served tokens are in."""
        rng = np.random.default_rng([_seed64(self.seed), 1 << 41])
        reqs = [(rec["round"], i, len(p) + len(s))
                for rec in self.rounds
                for i, (p, s) in enumerate(zip(rec["prompts"], rec["served"]))
                if s is not None]
        if not reqs:
            return {}
        longest = max(reqs, key=lambda t: t[2])
        moe = self.conf["model"].get("num_local_experts", 0) > 0
        want = self.mix["check_served_tokens"]
        picked: Dict[int, List[int]] = {}
        order = [longest] + [reqs[i] for i in rng.permutation(len(reqs))]
        served = 0
        for r, i, _ in order:
            if served >= want:
                break
            if moe:
                if r in picked:
                    continue
                rec = self.rounds[r]
                picked[r] = [j for j, s in enumerate(rec["served"])
                             if s is not None]
                served += sum(len(rec["served"][j]) for j in picked[r])
            elif i not in picked.setdefault(r, []):
                picked[r].append(i)
                served += len(self.rounds[r]["served"][i])
        return picked

    def reference(self, precs=("fp32",)) -> Dict[str, list]:
        """{prec: [(served tokens, logits (n, V)) of each sampled request]}:
        the plain reference over each sampled request's left-padded prompt
        (as ``serve`` pads it) and served tokens."""
        ref_model = program.reference(self.conf)
        ref_model.exact_float32()
        W = weights.make(self.template, program.sizes(self.conf), self.seed,
                         self.device, as_float32=True)
        spec = ref_model.Spec(self.conf)
        out = {p: [] for p in precs}
        for r, idx in sorted(self.sample().items()):
            rec = self.rounds[r]
            P = rec["plen"]
            if spec.moe:
                B = len(rec["prompts"])
                M = max(rec["max_new"]) - 1
                prompts = torch.zeros((B, P), dtype=torch.long)
                fed = torch.full((B, max(M, 0)), -1, dtype=torch.long)
                for b, (p, s) in enumerate(zip(rec["prompts"],
                                               rec["served"])):
                    prompts[b, P - len(p):] = torch.as_tensor(p)
                    if s is not None:
                        fed[b, :len(s)] = torch.as_tensor(s)[:M]
                for prec in precs:
                    lg = ref_model.prefill_decode_logits(
                        W, spec, prompts.to(self.device),
                        fed.to(self.device), prec)
                    for b in idx:
                        s = rec["served"][b]
                        out[prec].append((s, lg[b, :len(s)]))
                    del lg
                continue
            for c0 in range(0, len(idx), 4):
                chunk = idx[c0:c0 + 4]
                n = max(len(rec["served"][b]) for b in chunk)
                toks = torch.zeros((len(chunk), P + n - 1), dtype=torch.long)
                pos = []
                for row, b in enumerate(chunk):
                    p, s = rec["prompts"][b], rec["served"][b]
                    toks[row, P - len(p):P] = torch.as_tensor(p)
                    toks[row, P:P + len(s) - 1] = torch.as_tensor(s[:-1])
                    pos.append([P - 1 + j for j in range(len(s))])
                for prec in precs:
                    lg = ref_model.teacher_forced_logits(
                        W, spec, toks.to(self.device), pos, prec)
                    for row, b in enumerate(chunk):
                        out[prec].append((rec["served"][b], lg[row]))
        del W
        return out

    def readings(self, ref) -> dict:
        g = [x for s, lg in ref["fp32"] for x in judge.gaps(lg, s)]
        return judge.serve_readings(g)

    def control_readings(self, ref) -> dict:
        """The float8 reference's own first choices, read in the float32
        reference's logits."""
        g = []
        for (s, lg), (_, lg8) in zip(ref["fp32"], ref["fp8"]):
            g += judge.gaps(lg, lg8.argmax(-1).tolist())
        return judge.serve_readings(g)

    def calibration(self, control: bool, program: bool) -> dict:
        """After ``setup``, ``window`` and ``release``: the readings that a
        cell's limits are set from (``calibrate.py``): the program's against
        the float32 reference and, with ``control``, the float8 control's
        first choices read in the float32 reference's logits."""
        t0 = time.perf_counter()
        ref = self.reference(("fp32", "fp8") if control else ("fp32",))
        line = {"reference_s": time.perf_counter() - t0,
                "sampled_tokens": sum(len(s) for s, _ in ref["fp32"]),
                "rounds": self.stats["rounds"]}
        if program:
            line["program"] = self.readings(ref)
        if control:
            line["fp8"] = self.control_readings(ref)
        return line


Run = ServeRun
