"""Prefill in a closed loop, as ``prefill_closed``, for a configuration of
mixed layer kinds with expert layers (``portbench.hybrid``:
granite-4.0-h-small). Only the weight draw, the launch count and the
reference differ.

The traced window first runs the cycle once under ``torch.profiler`` and a
registry of the program's metrics (``repro_torch.obs.registry.recording``).
After each request it reads the MoE counters (``host.moe.assignments``,
``host.moe.experts_hit``), from which the launches of the expert products
are worked out (``flops.hybrid``) for ``trace.capture``. The program's
spans mark the profiler's host timeline: each device op is credited to
the innermost span open at its launch (``portbench.spans.reduce``), once
over every op and once over the GEMMs alone, which splits the MoE layer's
span (``host.layer.moe``) into its GEMMs and the rest. The trace's
``work`` carries the counters, the spans' device time and the MoE's least
time.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import groups, hybrid, spans, trace, traffic
from ..flops import hybrid as work_hybrid
from ..reference import granite_h
from . import prefill_closed
from .train import DTYPES

COUNTERS = ("host.moe.assignments", "host.moe.experts_hit")


class Driver(prefill_closed.Driver):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.hz = hybrid.sizes_of(cell.config)
        self.per_request: List[Dict[str, float]] = []

    def setup(self) -> None:
        from repro_torch.models.lm import LM, RunCfg
        from repro_torch.serving.serve import make_prefill_step
        run = RunCfg(compute_dtype=DTYPES[self.cell.config["dtype"]["compute"]], remat=False)
        model = LM(self.arch, run, self.device)
        hybrid.load_into(dict(model.named_parameters()), self.hz, self.seed)
        self.model, self.prefill = model, make_prefill_step(model)
        for i, L in enumerate(sorted(set(self.table))):
            tokens = traffic.prompt(self.sz.vocab, L, self.seed, -1, i, self.device)
            int(self.prefill({"tokens": tokens})[0, -1].argmax())

    def _one(self, prompt):
        """A request; under a registry, the MoE counters it added."""
        from repro_torch.obs.registry import current
        reg = current()
        before = {k: reg.counter(k).value for k in COUNTERS} if reg else None
        out = super()._one(prompt)
        if reg:
            self.per_request.append({k: reg.counter(k).value - before[k] for k in COUNTERS})
        return out

    def _work(self, lengths: List[int]):
        """The launches of the requests of ``lengths``, from the counters of
        a run of them under a registry; the MoE's least time with them."""
        L = self.hz.num_layers
        work = work_hybrid.Work()
        moe_s = 0.0
        for S, got in zip(lengths, self.per_request):
            if got["host.moe.assignments"] != L * S * self.hz.top_k:
                raise trace.TraceError(f"{got['host.moe.assignments']} routed assignments in a "
                                       f"request of {S} tokens, {L * S * self.hz.top_k} expected")
            hits = got["host.moe.experts_hit"] / L
            work.extend(work_hybrid.forward(self.hz, 1, S, last_only=True, hits=hits))
            moe_s += L * work_hybrid.moe_bound(self.hz, S, hits)
        return work, moe_s

    def traced(self) -> trace.Trace:
        from repro_torch import kernels
        from repro_torch.obs.registry import MetricsRegistry, recording
        from torch.profiler import ProfilerActivity, profile
        n = self.t["traced_cycles"] * len(self.table)
        lengths = [L for _, (_, _, _, L) in zip(range(n), self._requests())]
        serve = lambda: self._serve(lambda k, elapsed: k >= n, mark=True)
        reg = MetricsRegistry()
        self.per_request = []
        with recording(reg):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    serve()
                torch.cuda.synchronize(self.device)
        work, moe_s = self._work(lengths)
        by_span, gemm_by_span = split_by_span(prof.profiler.kineto_results.events())

        def run():
            w0 = time.time_ns()
            with torch.profiler.record_function(trace.WINDOW):
                r = serve()
            return {"requests": n, "tokens": r["tokens"], "launches": work, "lengths": lengths,
                    "window_ns": (w0, time.time_ns())}

        tr = trace.capture(run, kernels.launch_counts, work.launches())
        tr.work.update(counters=reg.to_dict()["counters"], moe_bound_s=moe_s,
                       device_by_span=by_span, gemm_by_span=gemm_by_span)
        return tr

    def reference(self, picked: List[Dict], lowp=None) -> List[torch.Tensor]:
        prompts = [traffic.prompt(self.sz.vocab, r["length"], self.seed, r["cycle"], r["index"],
                                  self.device)[0] for r in picked]
        served = DTYPES[self.cell.config["dtype"]["weights"]]
        return granite_h.last_logits(self.hz, self.seed, prompts, self.device, served, lowp)


def split_by_span(events):
    """(device ns by span, the GEMMs' device ns by span) of a profiled run:
    ``spans.reduce`` over every event, then over the host events and the
    GEMM kernels alone."""
    cuda = torch.autograd.DeviceType.CUDA
    gemms = [e for e in events if e.device_type() != cuda or groups.group(e.name()) == groups.GEMM]
    return spans.reduce(events)["device_by_span"], spans.reduce(gemms)["device_by_span"]
