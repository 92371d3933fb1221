#!/usr/bin/env python3
"""The program's spans over a cell's traced work: each phase's host time
and device time, and what the host was doing while the device idled.

    python3 portbench/spans.py --workload NAME --seed N

From the root of a checkout, on one card. The cell's driver is set up as
``run.py`` sets it up; then the traffic's traced work (``traced_steps``
train steps, or ``traced_cycles`` cycles of prompts) runs five times:

1. unprofiled with no registry installed, so the program's spans are off:
   the mean host-clock window of two such runs is ``plain_window_s``;
2. under a registry (``repro_torch.obs.registry.recording``) and no
   profiler, twice, between the two runs of 1: the spans' ``<name>.us``
   and ``<name>.calls`` counters give each phase's host time, their calls
   must equal the work, and the mean window's excess over 1's is the cost
   of tracing when it is on;
3. under a registry and ``torch.profiler`` (host and device): each span
   then also marks the profiler's host timeline, so each device kernel is
   credited to the innermost span open on the main thread when it was
   launched (``device_by_span``; the backward's kernels are launched by
   autograd's device thread while the main thread waits inside
   ``host.train.backward``), and each idle gap of the device to the span
   at the gap and the innermost host op on the thread that launched the
   kernel that ends it (``idle_by_span``).

Prints one JSON line: the card, the windows, the span counters, each
span's host and device ms a step or request, the idle breakdown, and the
eight per-layer numbers under the names ``PERF.md`` gives them. Exits 2
without a card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]

PROGRAM = "host."                 # the program's span domain
OUTSIDE = "outside spans"
BETWEEN = "host between ops"
TRAIN_SPANS = ("host.train.forward", "host.train.backward", "host.train.apply_optimizer",
               "host.train.sync_model")
PREFILL_SPAN = "host.serve.prefill"
UPDATE_SPANS = ("host.train.apply_optimizer", "host.train.sync_model")

Interval = Tuple[str, int, int]   # name, start, end (ns, host clock)


def innermost(times: Sequence[int], intervals: Sequence[Interval]) -> List[Optional[str]]:
    """For each of ``times``, the name of the innermost interval that
    holds it, or None; intervals of one thread nest. ``times`` in any
    order."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    ivs = sorted(intervals, key=lambda h: (h[1], -h[2]))
    out: List[Optional[str]] = [None] * len(times)
    stack: List[Interval] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(ivs) and ivs[j][1] <= t:
            while stack and stack[-1][2] < ivs[j][1]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def device_by_span(device, launch: Dict[int, Tuple[int, int]],
                   spans: Sequence[Interval]) -> Dict[str, int]:
    """Device ns of each program span: every device op (name, start, end,
    correlation) credited to the innermost of ``spans`` (the main
    thread's) open at its host launch (``launch``: correlation -> (host
    time, thread)), else to ``OUTSIDE``."""
    out: Dict[str, int] = defaultdict(int)
    launched = [op for op in device if op[3] in launch]
    names = innermost([launch[op[3]][0] for op in launched], spans)
    for (_, s, e, _), name in zip(launched, names):
        out[name or OUTSIDE] += e - s
    for _, s, e, corr in device:
        if corr not in launch:
            out[OUTSIDE] += e - s
    return dict(out)


def gaps_by_launch(device, launch: Dict[int, Tuple[int, int]]) -> List[Tuple[int, int, int]]:
    """The device's idle gaps, each put on the host clock as the stretch of
    its length that ends at the launch of the op that ends it (as
    ``trace.device_gaps``), with the launching thread: (start, end, tid)."""
    gaps, end = [], None
    for _, s, e, corr in sorted(device, key=lambda d: (d[1], d[2])):
        if end is not None and s > end and corr in launch:
            t, tid = launch[corr]
            gaps.append((t - (s - end), t, tid))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_span(gaps, spans: Sequence[Interval],
                 host: Dict[int, Sequence[Interval]]) -> Dict[str, int]:
    """Idle ns by "<span> / <host op>": the innermost program span on the
    main thread at each gap's middle (else ``OUTSIDE``), then the
    innermost host op at the middle on the thread that launched the op
    ending the gap (``host``: thread -> its ops; else ``BETWEEN``)."""
    mids = [(s + e) // 2 for s, e, _ in gaps]
    span_at = innermost(mids, spans)
    op_at: List[Optional[str]] = [None] * len(gaps)
    by_tid: Dict[int, List[int]] = defaultdict(list)
    for i, (_, _, tid) in enumerate(gaps):
        by_tid[tid].append(i)
    for tid, idx in by_tid.items():
        for i, name in zip(idx, innermost([mids[i] for i in idx], host.get(tid, ()))):
            op_at[i] = name
    out: Dict[str, int] = defaultdict(int)
    for (s, e, _), sp, op in zip(gaps, span_at, op_at):
        out[f"{sp or OUTSIDE} / {op or BETWEEN}"] += e - s
    return dict(out)


def check_span_calls(counters: Dict[str, float], expected: Dict[str, int]) -> None:
    """Each span's ``.calls`` must equal the work's count."""
    from portbench.trace import TraceError
    for name, n in expected.items():
        got = counters.get(name + ".calls", 0)
        if got != n:
            raise TraceError(f"{name}: {got} calls in the window, {n} expected from its work")


def reduce(events) -> Dict:
    """Pass 3's profiler events -> (device_by_span, idle_by_span, idle ns
    in all, device op count). The main thread is the one that opened the
    harness's ``portbench.window`` span."""
    import torch
    from portbench import trace
    device = trace._device_events(events)
    window, launch = None, {}
    host: Dict[int, List[Interval]] = defaultdict(list)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        name, s, t, tid = e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()
        if name == trace.WINDOW:
            window = (s, t, tid)
        elif e.correlation_id() and name.startswith("cu"):
            launch[e.correlation_id()] = (s, tid)
        if name not in trace.SPANS:
            host[tid].append((name, s, t))
    if window is None:
        raise trace.TraceError(f"no {trace.WINDOW} span in the trace")
    main = window[2]
    spans = [h for h in host[main] if h[0].startswith(PROGRAM)]
    ops = {tid: [h for h in hs if not h[0].startswith(PROGRAM)] for tid, hs in host.items()}
    gaps = gaps_by_launch(device, launch)
    return {"device_by_span": device_by_span(device, launch, spans),
            "idle_by_span": idle_by_span(gaps, spans, ops),
            "idle_ns": sum(e - s for s, e, _ in gaps), "device_ops": len(device)}


def per_layer(kind: str, counters: Dict[str, float], device: Dict[str, int], n: int,
              update_bytes: int = 0, runs: int = 1) -> Dict[str, float]:
    """The eight per-layer numbers of ``PERF.md`` over ``n`` steps or
    requests: host ms from the counters of ``runs`` runs of them under a
    registry, device ms from one profiled run."""
    from portbench.flops import peaks
    us = lambda *names: sum(counters.get(s + ".us", 0.0) for s in names) / runs
    ns = lambda *names: sum(device.get(s, 0) for s in names)
    if kind == "prefill":
        return {"prefill_host_ms_per_req.serve": us(PREFILL_SPAN) / 1e3 / n}
    out = {"forward_host_ms_per_step.train": us("host.train.forward") / 1e3 / n,
           "backward_host_ms_per_step.train": us("host.train.backward") / 1e3 / n,
           "update_host_ms_per_step.train": us(*UPDATE_SPANS) / 1e3 / n,
           "forward_device_ms_per_step.train": ns("host.train.forward") / 1e6 / n,
           "backward_device_ms_per_step.train": ns("host.train.backward") / 1e6 / n,
           "update_device_ms_per_step.train": ns(*UPDATE_SPANS) / 1e6 / n}
    if ns(*UPDATE_SPANS):
        out["update_roofline.train"] = (100.0 * update_bytes / peaks.HBM_BYTES
                                        / (ns(*UPDATE_SPANS) / 1e9 / n))
    return out


def _timed(work) -> float:
    t0 = time.perf_counter()
    work()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import spec, trace, weights
    from portbench.flops.update import update_bytes
    from portbench.run import power_limit
    from portbench.sizes import sizes_of
    from repro_torch.obs.registry import MetricsRegistry, recording
    cell = spec.find_cell(spec.load_benchmark(ROOT), ROOT, args.workload)
    if not torch.cuda.is_available():
        print(f"portbench.spans: {cell.name} needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    driver = spec.mode_module(cell.traffic).Driver(cell, args.seed, device)
    driver.setup()
    t = cell.traffic
    kind = "train" if t["mode"] == "train" else "prefill"
    extra = {}
    if kind == "train":
        n = t["traced_steps"]
        G = t["microbatches"]
        expected = {"host.train.forward": G * n, "host.train.backward": G * n,
                    "host.train.apply_optimizer": n, "host.train.sync_model": n}

        def work():
            for _ in range(n):
                driver._step()
                driver._sync()
        dt = cell.config["dtype"]
        dtypes = {"masters": dt["masters"], "moments": dt["moments"], "compute": dt["compute"],
                  "grads": "float32" if G > 1 else dt["compute"]}
        sizes = [torch.Size(s).numel() for s in weights.expected_shapes(sizes_of(cell.config)).values()]
        by_shapes = update_bytes(sizes, dtypes)
        by_leaves = update_bytes([p.numel() for p in driver.state.model.parameters()], dtypes)
        if by_shapes != by_leaves:
            raise trace.TraceError(f"update bytes: {by_shapes} from shapes, {by_leaves} from the "
                                   f"port's leaves")
        extra = {"update_bytes_per_step": by_shapes, "parameters": sum(sizes)}
    else:
        n = t["traced_cycles"] * len(driver.table)
        expected = {PREFILL_SPAN: n}

        def work():
            driver._serve(lambda k, elapsed: k >= n, mark=False)
            torch.cuda.synchronize(device)

    plain_s, spans_s, reg = 0.0, 0.0, MetricsRegistry()
    for on in (False, True, True, False):                # 1 and 2, in turns: off, on, on, off
        if on:
            with recording(reg):
                spans_s += _timed(work)
        else:
            plain_s += _timed(work)
    counters = reg.to_dict()["counters"]
    check_span_calls(counters, {k: 2 * v for k, v in expected.items()})
    plain_s, spans_s = plain_s / 2, spans_s / 2
    with recording(MetricsRegistry()):                   # 3: spans on the profiler's clock
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                work()
            torch.cuda.synchronize(device)
    found = reduce(prof.profiler.kineto_results.events())
    dev = found["device_by_span"]
    idle = sorted(found["idle_by_span"].items(), key=lambda kv: -kv[1])
    by_span: Dict[str, int] = defaultdict(int)
    for k, v in idle:
        by_span[k.split(" / ")[0]] += v
    names = TRAIN_SPANS if kind == "train" else (PREFILL_SPAN,)
    result = {
        "workload": cell.name, "seed": args.seed, "device": torch.cuda.get_device_name(device),
        "power_limit": power_limit(), "work": n, "plain_window_s": plain_s,
        "spans_window_s": spans_s, "tracing_cost_pct": 100.0 * (spans_s / plain_s - 1.0),
        "counters": counters,
        "host_ms": {s: counters.get(s + ".us", 0.0) / 1e3 / (2 * n) for s in names},
        "device_ms": {s: v / 1e6 / n for s, v in sorted(dev.items())},
        "idle_s": found["idle_ns"] / 1e9, "idle_outside_spans_pct":
            100.0 * by_span[OUTSIDE] / max(found["idle_ns"], 1),
        "idle_by_span_s": {k: v / 1e9 for k, v in sorted(by_span.items())},
        "idle": [[k, v / 1e9] for k, v in idle[:16]], "device_ops": found["device_ops"],
        "metrics": per_layer(kind, counters, dev, n, extra.get("update_bytes_per_step", 0), runs=2),
        **extra}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
