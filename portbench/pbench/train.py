"""The training mix: ``make_train_step`` on batches of uniform token ids
drawn from the seed and the step, fed through the port's
``PrefetchLoader``.

Set-up builds the step with its model and AdamW state, runs the mix's
``checked_steps`` through the window's own call and feed, and keeps what
the comparison needs: each step's loss, the norm of step 1's gradient as
AdamW got it (its first moment / (1 - b1)) and the norm of each leaf's
change after the checked steps.  The window then runs the same object on.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from . import program, trace, weights


def _seed64(seed: int) -> int:
    return int(seed) % (1 << 64)


class TrainRun:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.conf, self.mix = cell.config, cell.traffic
        self.cfg = program.arch(self.conf)
        self.rows = self.mix["microbatches"] * self.mix["rows_per_microbatch"]
        self.seq = self.mix["seq_len"]
        self.steps_done = 0

    # -- traffic ------------------------------------------------------------
    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Step ``step``'s rows: uniform ids, each row's labels its tokens
        shifted by one."""
        rng = np.random.default_rng([_seed64(self.seed), step])
        a = rng.integers(0, self.cfg.vocab_size, size=(self.rows,
                                                       self.seq + 1),
                         dtype=np.int64).astype(np.int32)
        return {"tokens": a[:, :-1], "labels": a[:, 1:]}

    def _batches(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    # -- the program ----------------------------------------------------------
    def setup(self):
        from repro_torch.data import PrefetchLoader
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import registry as R
        from repro_torch.optim import AdamWConfig, adamw_init
        tree = R.init_params(self.cfg, device="meta",
                             param_dtype=torch.float32)
        self.template = weights.flatten(tree)
        flat = weights.make(self.template, program.sizes(self.conf),
                            self.seed, self.device)
        self.params = weights.unflatten_into(tree, flat)
        del flat
        self.opt = adamw_init(self.params)
        ocfg = AdamWConfig(**self.mix["optimizer"])
        self.step_fn = make_train_step(
            self.cfg, ocfg, moe_dispatch=self.conf["as_run"]["moe_dispatch"],
            accum_steps=self.mix["microbatches"], device=self.device)
        self.loader = PrefetchLoader(self._batches())
        self.routes0 = program.launches_by_route()
        self.losses: List[float] = []
        for i in range(self.mix["checked_steps"]):
            self.losses.append(self._step())
            if i == 0:
                scale = 1.0 - ocfg.b1
                self.grad_norms = {
                    p: float(m.double().norm()) / scale
                    for p, m in weights.flatten(self.opt.m).items()}
        now = weights.flatten(self.params)
        self.change_norms = {
            p: float((now[p].detach() - t).double().norm())
            for p, t in weights.draw(self.template, program.sizes(self.conf),
                                     self.seed, self.device)}

    def _step(self) -> float:
        batch = next(self.loader)
        self.params, self.opt, metrics = self.step_fn(self.params, self.opt,
                                                      batch)
        self.steps_done += 1
        return float(metrics["loss"])

    def window(self, seconds: float) -> dict:
        """Whole steps until ``seconds`` have passed; each step ends on the
        host reading its loss, so ``step_s`` holds each step's time."""
        steps = failed = 0
        ends = []
        t0 = time.perf_counter()
        while True:
            loss = self._step()
            ends.append(time.perf_counter())
            steps += 1
            failed += not math.isfinite(loss)
            if ends[-1] - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        el = time.perf_counter() - t0
        self.stats = {"seconds": el, "steps": steps, "failed": failed,
                      "tokens": steps * self.rows * self.seq,
                      "step_s": [b - a for a, b in zip([t0] + ends, ends)]}
        return self.stats

    def traced(self) -> trace.Trace:
        n = self.mix["traced_steps"]
        with trace.Window() as w:
            for _ in range(n):
                with torch.profiler.record_function("portbench.train_step"):
                    self._step()
        self.traced_info = {"steps": n, "tokens": n * self.rows * self.seq}
        return w.trace

    def end_to_end(self) -> dict:
        s = self.stats
        return {"train_tokens_per_s": s["tokens"] / s["seconds"]}

    def attempted_failed(self):
        return self.steps_done, self.stats["failed"] + sum(
            not math.isfinite(x) for x in self.losses)

    def off_route(self) -> int:
        return program.off_route(self.routes0, program.launches_by_route(),
                                 "wgmma_bf16")

    def release(self):
        self.loader.close()
        del self.params, self.opt, self.step_fn, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def reference(self, prec: str = "fp32", drop_half: bool = False):
        """The plain reference's (losses, step-1 gradient norms, change
        norms) over the checked steps from the same weights and batches.
        ``drop_half``: a planted fault, the second microbatch left out."""
        from reference import train as ref_train
        ref_model = program.reference(self.conf)
        ref_model.exact_float32()
        sizes = program.sizes(self.conf)
        W = weights.make(self.template, sizes, self.seed, self.device,
                         as_float32=True)
        mb = self.mix["rows_per_microbatch"]
        steps = []
        for i in range(self.mix["checked_steps"]):
            b = self.batch(i)
            micro = []
            for j in range(self.mix["microbatches"]):
                sl = slice(j * mb, (j + 1) * mb)
                micro.append(tuple(torch.as_tensor(b[k][sl], device=self.device)
                                   .long() for k in ("tokens", "labels")))
            steps.append(micro[:1] if drop_half else micro)
        spec = ref_model.Spec(self.conf)
        losses, g1 = ref_train.run(W, spec, steps, self.mix["optimizer"],
                                   prec, model=ref_model)
        change = ref_train.change_norms(
            W, lambda: weights.draw(self.template, sizes, self.seed,
                                    self.device))
        del W
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return losses, g1, change

    def readings(self, ref) -> dict:
        """The numbers compared: the program's against ``ref``."""
        from . import judge
        losses, g1, change = ref
        return judge.train_readings(self.losses, self.grad_norms,
                                    self.change_norms, losses, g1, change)

    def control_readings(self, ref, low) -> dict:
        """A lower-precision or faulty reference ``low`` held against ``ref``
        as the program is."""
        from . import judge
        return judge.train_readings(*low, *ref)

    def calibration(self, control: bool, program: bool) -> dict:
        """After ``setup``, ``window`` and ``release``: the readings that a
        cell's limits are set from (``calibrate.py``): the program's against
        the float32 reference and, with ``control``, the float8 control's,
        the half batch's and the unchanged state's against it."""
        from . import judge
        t0 = time.perf_counter()
        ref = self.reference("fp32")
        line = {"reference_s": time.perf_counter() - t0}
        if program:
            line["program"] = self.readings(ref)
            line["program_worst_leaves"] = judge.worst_leaves(
                self.grad_norms, self.change_norms, ref[1], ref[2])
        if control:
            line["fp8"] = self.control_readings(ref, self.reference("fp8"))
            line["half_batch"] = self.control_readings(
                ref, self.reference("fp32", drop_half=True))
            line["unchanged_state"] = self.control_readings(
                ref, (ref[0], ref[1], {k: 0.0 for k in ref[2]}))
        return line


Run = TrainRun
