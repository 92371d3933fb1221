"""Prefill in a closed loop: ``repro_torch.serving.serve.make_prefill_step``
on one device, ``clients`` clients (one) each sending its next request
once the first token of its last one is on the host.

A request is one prompt of B = 1 row; its time to first token runs from
its start to the host holding the argmax of the last position's logits.
Prompt lengths come from the traffic's table (``traffic.length_table``),
each cycle of the table in an order drawn from the seed, and each
prompt's token ids from a generator of its own. The window serves whole
cycles: it ends with the first cycle that ends after ``seconds``. Set-up serves each
length of the table once, so no shape meets the window cold.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from .. import traffic, trace, weights
from ..flops import model as work_model
from ..reference import lm as ref_lm
from ..sizes import block_sizes, sizes_of
from ..spec import arch_of
from .train import DTYPES


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t = cell.traffic
        if self.t["clients"] != 1 or self.t["batch"] != 1:
            raise NotImplementedError("the closed loop drives one client sending one row")
        self.sz = sizes_of(cell.config)
        self.arch = arch_of(cell.config)
        self.table = traffic.length_table(self.t["lengths"])
        self.served: List[Dict] = []

    def setup(self) -> None:
        from repro_torch.models.lm import LM, RunCfg
        from repro_torch.serving.serve import make_prefill_step
        run = RunCfg(compute_dtype=DTYPES[self.cell.config["dtype"]["compute"]], remat=False)
        model = LM(self.arch, run, self.device)
        weights.load_into(dict(model.named_parameters()), self.sz, self.seed)
        self.model, self.prefill = model, make_prefill_step(model)
        for i, L in enumerate(sorted(set(self.table))):
            tokens = traffic.prompt(self.sz.vocab, L, self.seed, -1, i, self.device)
            int(self.prefill({"tokens": tokens})[0, -1].argmax())

    def _requests(self):
        """(cycle, position in it, index, length) of each request in the
        order sent."""
        cycle = 0
        while True:
            for pos, i in enumerate(traffic.cycle_order(len(self.table), self.seed, cycle)):
                yield cycle, pos, i, self.table[i]
            cycle += 1

    def _serve(self, until, mark: bool) -> Dict:
        """Send whole cycles of the table until ``until(n, elapsed)``, asked
        as each cycle begins, says stop; each request that returns is kept
        with its logits for the check. Whole cycles give every run the same
        lengths, so a run's mix does not hang on where its window ends."""
        ttft, tokens, n = [], 0, 0
        t0 = time.perf_counter()
        end = t0
        for cycle, pos, i, L in self._requests():
            if pos == 0 and until(n, end - t0):
                break
            prompt = traffic.prompt(self.sz.vocab, L, self.seed, cycle, i, self.device)
            start = time.perf_counter()
            if mark:
                with torch.profiler.record_function(trace.REQUEST):
                    logits, token = self._one(prompt)
            else:
                logits, token = self._one(prompt)
            end = time.perf_counter()
            ttft.append(end - start)
            tokens += L
            n += 1
            self.served.append({"cycle": cycle, "index": i, "length": L, "token": token,
                                "logits": logits})
        return {"ttft": ttft, "tokens": tokens, "n": n, "window_s": end - t0}

    def _one(self, prompt):
        logits = self.prefill({"tokens": prompt})[0, -1]
        return logits, int(logits.argmax())

    def window(self, seconds: float) -> Dict:
        r = self._serve(lambda n, elapsed: elapsed >= seconds, mark=False)
        p95 = statistics.quantiles(r["ttft"], n=20, method="inclusive")[18]
        return {"metrics": {"ttft_p95_ms": 1e3 * p95,
                            "prefill_tokens_per_s": r["tokens"] / r["window_s"]},
                "attempted": r["n"], "failed": 0}

    def traced(self) -> trace.Trace:
        from repro_torch import kernels
        n = self.t["traced_cycles"] * len(self.table)
        lengths = [L for _, (_, _, _, L) in zip(range(n), self._requests())]
        work = work_model.Work()
        for L in lengths:
            work.extend(work_model.forward(self.sz, 1, L, last_only=True))

        def run():
            w0 = time.time_ns()
            with torch.profiler.record_function(trace.WINDOW):
                r = self._serve(lambda k, elapsed: k >= n, mark=True)
            return {"requests": n, "tokens": r["tokens"], "launches": work, "lengths": lengths,
                    "window_ns": (w0, time.time_ns())}

        return trace.capture(run, kernels.launch_counts, work.launches())

    def release(self) -> None:
        del self.model, self.prefill
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def sample(self) -> List[Dict]:
        """The requests checked: the first with the longest prompt, and
        ``checked_requests - 1`` more drawn from the seed among the rest."""
        k = self.t["checked_requests"]
        longest = max(range(len(self.served)), key=lambda j: (self.served[j]["length"], -j))
        rest = [j for j in range(len(self.served)) if j != longest]
        g = torch.Generator().manual_seed(traffic.subseed(self.seed, "sample"))
        picked = [rest[j] for j in torch.randperm(len(rest), generator=g)[:k - 1].tolist()]
        return [self.served[j] for j in [longest] + sorted(picked)]

    def reference(self, picked: List[Dict], lowp=None) -> List[torch.Tensor]:
        prompts = [traffic.prompt(self.sz.vocab, r["length"], self.seed, r["cycle"], r["index"],
                                  self.device)[0] for r in picked]
        served = DTYPES[self.cell.config["dtype"]["weights"]]
        return ref_lm.last_logits(self.sz, block_sizes(self.cell.config, self.sz), self.seed,
                                  prompts, self.device, served, lowp)

    def check(self, lowp=None) -> Dict[str, float]:
        """``token_gap``: the widest gap by which a served token's reference
        logit lies below the reference's best; ``logit_err``: the largest
        relative L2 distance of the served last logits from the
        reference's. Under ``lowp`` the reference at that precision takes
        the port's place."""
        picked = self.sample()
        ref = self.reference(picked)
        if lowp is None:
            got = [r["logits"].float() for r in picked]
        else:
            got = self.reference(picked, lowp)
        tokens = ([r["token"] for r in picked] if lowp is None
                  else [int(g.argmax()) for g in got])
        gaps, errs = [], []
        for g, r, tok in zip(got, ref, tokens):
            gaps.append(float(r.max() - r[tok]))
            errs.append(float(torch.linalg.vector_norm(g.to(r.device) - r)
                              / torch.linalg.vector_norm(r)))
        return {"token_gap": max(gaps), "logit_err": max(errs)}
