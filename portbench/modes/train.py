"""Training: ``repro_torch.train.step.make_train_step``'s step on one
device, a fresh batch of G microbatches each step.

Set-up draws the fp32 masters from the seed (``weights.masters``: their
buffers are the masters the state holds), builds the port's
``TrainState`` around them (the bf16 model copied from them, fresh
optimizer state) and drives it through the first ``checked_steps`` steps
with the window's own step and feed; those steps warm every shape and are
what the reference follows. The window then runs whole steps, each
synchronised, until ``seconds`` have passed.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from .. import traffic, trace, weights
from ..flops import model as work_model
from ..reference import train as ref_train
from ..sizes import block_sizes, sizes_of
from ..spec import arch_of

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t = cell.traffic
        self.sz = sizes_of(cell.config)
        self.arch = arch_of(cell.config)
        self.steps_done = 0
        self.readings: Dict = {}

    # -- the program --------------------------------------------------------
    def feed(self, step: int) -> Dict[str, torch.Tensor]:
        return traffic.train_batch(self.t, self.sz.vocab, self.seed, step, self.device)

    def setup(self) -> None:
        from repro_torch.models.lm import LM, RunCfg
        from repro_torch.train.optim import OptimizerCfg, init_opt_state
        from repro_torch.train.step import TrainCfg, TrainState, make_train_step, sync_model
        dt = self.cell.config["dtype"]
        o = self.t["optimizer"]
        run = RunCfg(compute_dtype=DTYPES[dt["compute"]], param_dtype=DTYPES[dt["masters"]],
                     remat=self.t["remat"])
        opt = OptimizerCfg(peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
                           decay_steps=o["decay_steps"], min_lr_ratio=o["min_lr_ratio"], b1=o["b1"],
                           b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                           grad_clip=o["grad_clip"], moment_dtype=DTYPES[dt["moments"]])
        cfg = TrainCfg(run=run, opt=opt, num_microbatches=self.t["microbatches"])
        model = LM(self.arch, run, self.device)
        names = [n for n, _ in model.named_parameters()]
        masters = weights.masters(self.sz, self.seed, self.device)
        weights.check_leaves(dict(model.named_parameters()), self.sz)
        params = {n: masters[n] for n in names}
        state = TrainState(model, params)
        sync_model(state)
        state.opt_state = init_opt_state(opt, params)
        self.state, self.step_fn = state, make_train_step(self.arch, cfg)
        b1 = o["b1"]
        losses = []
        for _ in range(self.t["checked_steps"]):
            loss = self._step()
            losses.append(float(loss))
            if self.steps_done == 1:
                m = state.opt_state["m"]
                grad = {n: float(torch.linalg.vector_norm(m[n].float())) / (1 - b1) for n in names}
        v = {n: float(torch.linalg.vector_norm(state.opt_state["v"][n].float())) for n in names}
        copy = {n: w.detach().reshape(-1)[weights.copy_sample(self.seed, n, w.numel(), self.device)]
                .float().cpu() for n, w in model.named_parameters()}
        with torch.no_grad():
            change = {}
            for _, index, _ in weights.parts(self.sz):
                for n, p0 in weights.draw(self.sz, self.seed, index, self.device).items():
                    change[n] = float(torch.linalg.vector_norm(params[n].float() - p0))
        self.readings = {"loss": losses, "grad": grad, "v": v, "change": change, "copy": copy}
        self._sync()

    def _step(self) -> torch.Tensor:
        self.steps_done += 1
        batch = self.feed(self.steps_done)
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss"]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> Dict:
        tokens_a_step = self.t["microbatches"] * self.t["batch"] * self.t["seq_len"]
        self._sync()
        t0 = time.perf_counter()
        n, failed, end = 0, 0, t0
        while end - t0 < seconds:
            loss = self._step()
            self._sync()
            end = time.perf_counter()
            failed += int(not torch.isfinite(loss).item())
            n += 1
        return {"metrics": {"train_tokens_per_s": n * tokens_a_step / (end - t0)},
                "attempted": n, "failed": failed}

    def traced(self) -> trace.Trace:
        from repro_torch import kernels
        n = self.t["traced_steps"]
        step_work = work_model.train_step(self.sz, self.t["microbatches"], self.t["batch"],
                                          self.t["seq_len"])

        def run():
            w0 = time.time_ns()
            with torch.profiler.record_function(trace.WINDOW):
                for _ in range(n):
                    with torch.profiler.record_function(trace.STEP):
                        self._step()
                        self._sync()
            return {"steps": n, "launches": work,
                    "tokens": n * self.t["microbatches"] * self.t["batch"] * self.t["seq_len"],
                    "window_ns": (w0, time.time_ns())}

        work = work_model.Work()
        for _ in range(n):
            work.extend(step_work)
        return trace.capture(run, kernels.launch_counts, work.launches())

    def release(self) -> None:
        del self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def reference(self, lowp=None) -> Dict:
        o = dict(self.t["optimizer"])
        return ref_train.steps(self.sz, block_sizes(self.cell.config, self.sz), o, self.seed,
                               self.feed, self.t["checked_steps"], self.device,
                               DTYPES[self.cell.config["dtype"]["compute"]], lowp)

    def check(self, lowp=None) -> Dict[str, float]:
        """The numbers compared: the worst step's loss gap, the worst leaf's
        first-gradient, second-moment and change gaps, and the compute
        copy's share of stale or wrong elements (``compare``). Under
        ``lowp`` the reference at that precision takes the port's place."""
        got = self.readings if lowp is None else self.reference(lowp)
        ref = self.reference()
        self.detail = worst_leaves(got, ref)
        return compare(got, ref)


def compare(got: Dict, ref: Dict, floor_share: float = 1e-3) -> Dict[str, float]:
    """``loss``: the largest |loss - reference| / reference over the
    checked steps. ``grad``, ``v`` and ``change``: over the leaves, the
    largest gap between the port's norm and the reference's, over the
    larger of the reference's norm of that leaf and of the median leaf
    (``v``: the second moment after the checked steps). ``change`` leaves
    out the leaves whose first reference gradient is under ``floor_share``
    of the median leaf's: Adam moves those by round-off alone.

    ``copy``: over ``weights.copy_sample``'s elements of every leaf, those
    where the compute copy differs from the reference's weights after the
    steps rounded to the compute type by more than a hundredth of the
    element's fp32 change, over those whose rounded value the steps moved.
    A copy left stale reads about 1; one rounded from sound masters differs
    only where the two sides' masters straddle a rounding boundary."""
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))}
    med_grad = statistics.median(ref["grad"].values())
    for key in ("grad", "v", "change"):
        med = statistics.median(ref[key].values())
        names = [n for n in ref[key]
                 if key != "change" or ref["grad"][n] >= floor_share * med_grad]
        out[key] = max(abs(got[key][n] - ref[key][n]) / max(ref[key][n], med) for n in names)
    wrong = sum(int(((got["copy"][n] - ref["copy"][n]).abs() > ref["moved"][n] / 100).sum())
                for n in ref["copy"])
    moved = sum(int((ref["copy"][n] != ref["copy0"][n]).sum()) for n in ref["copy"])
    out["copy"] = wrong / max(moved, 1)
    return out


def worst_leaves(got: Dict, ref: Dict, floor_share: float = 1e-3) -> Dict:
    """Which leaf sets ``grad``, ``v`` and ``change``, and which leaves
    ``change`` leaves out, for the record."""
    med_grad = statistics.median(ref["grad"].values())
    out = {"left_out": sorted(n for n in ref["grad"] if ref["grad"][n] < floor_share * med_grad)}
    for key in ("grad", "v", "change"):
        med = statistics.median(ref[key].values())
        out[key] = max(ref[key], key=lambda n: abs(got[key][n] - ref[key][n]) / max(ref[key][n], med))
    return out
