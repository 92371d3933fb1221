"""The traced window: ``torch.profiler`` over a fixed amount of a cell's
work, reduced to what the per-layer readers take.

The work runs three times. First without the profiler: its host-clock
time is what a share of the peak and the idle share divide by, since the
profiler's own cost lengthens a host-paced window. Pass B then profiles
host and device, with the harness's own spans (``record_function``:
``portbench.window``, ``portbench.step``, ``portbench.request``): every
kernel of a port group must have been launched inside a call of that
kernel's operator (``repro_torch::<op>``), which also gives each kernel's
device launches a call; its host ops name what the host was doing while
the device idled (``breakdown``), under the profiler's own cost. Pass A
profiles the device alone (CUPTI's kernel records): its kernels' times
and the union of their intervals (``busy_s``) are what the other readers
take, and its host-clock window is ``window_s``.

Each pass profiles ``run()`` alone, which starts and ends with the device
idle, so every device record in it is the window's work. The device's
timestamps drift from the host clock by up to a few percent of a window
on the card, so nothing compares the two clocks: a device gap is put on
the host clock back from the launch of the kernel that ends it. CUPTI
now and then loses a few records of a card-paced window; a pass that
lost any (a port kernel's launches short of its calls, or pass A short
of pass B's records) is run again, up to ``ATTEMPTS`` times. In both
passes each port kernel's calls must equal the port's counter
(``repro_torch.kernels.launch_counts``) and the count worked out from
shapes (``flops.model``), and in pass A its device launches must equal
its calls times pass B's launches a call; otherwise the run fails rather
than credit time to the wrong kernel.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from . import groups

WINDOW, STEP, REQUEST = "portbench.window", "portbench.step", "portbench.request"
SPANS = (WINDOW, STEP, REQUEST)
PORT_OP = "repro_torch::"


ATTEMPTS = 5


class TraceError(RuntimeError):
    """The trace does not add up: a launch count or an attribution fails."""


class RecordsLost(TraceError):
    """The profiler lost device or launch records of a pass."""


@dataclass
class Trace:
    window_ns: Tuple[int, int]
    ops: List[Tuple[str, str, int, int]]          # device ops: name, group, start, end (ns)
    work: Dict = field(default_factory=dict)       # the driver's account of the window's work
    idle_by_host: Dict[str, int] = field(default_factory=dict)   # pass B's idle ns by host op

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def time_s(self, pred: Callable[[str], bool]) -> float:
        """Summed device time of the ops whose group satisfies ``pred``."""
        return sum(e - s for _, g, s, e in self.ops if pred(g)) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in busy_intervals(self.ops)) / 1e9

    def breakdown(self) -> Dict:
        """The ten device ops that took most time, and the ten host
        activities under which the device idled longest."""
        by_op: Dict[str, int] = defaultdict(int)
        for name, _, s, e in self.ops:
            by_op[short(name)] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    name = re.sub(r"\bat::native::", "", name)
    return name[:100]


def busy_intervals(ops) -> List[Tuple[int, int]]:
    """The union of the device ops' intervals (an op's last two fields are
    its start and end)."""
    merged: List[List[int]] = []
    for s, e in sorted((op[-2], op[-1]) for op in ops):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def device_gaps(device, launch) -> List[Tuple[int, int]]:
    """The device's idle gaps between its ops, each put on the host clock
    as the stretch of its length that ends at the launch of the op that
    ends it (``launch``: correlation -> host launch time): the device
    waited for that launch. ``device``: (name, start, end, correlation)."""
    gaps, end = [], None
    for _, s, e, corr in sorted(device, key=lambda d: (d[1], d[2])):
        if end is not None and s > end and corr in launch:
            gaps.append((launch[corr] - (s - end), launch[corr]))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_host(gaps, host) -> Dict[str, int]:
    """Idle device time by the innermost host op running at each gap's
    middle (``gaps`` on the host clock; host ops of one thread nest)."""
    gaps = sorted(gaps, key=lambda g: g[0] + g[1])
    out: Dict[str, int] = defaultdict(int)
    ops = sorted(host, key=lambda h: (h[1], -h[2]))
    stack: List[Tuple[str, int, int]] = []
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(ops) and ops[i][1] <= mid:
            while stack and stack[-1][2] < ops[i][1]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out[stack[-1][0] if stack else "host between ops"] += e - s
    return dict(out)


def _device_events(events):
    """(name, start, end, correlation) of the device's kernels, copies and
    fills; the host spans' images on the device timeline are left out."""
    out = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if name in SPANS or name.startswith(PORT_OP) or getattr(e, "is_user_annotation", bool)():
            continue
        out.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
    return out


def _profile(run, counts, activities):
    from torch.profiler import profile
    before = counts()
    with profile(activities=activities) as prof:
        work = run()
        torch.cuda.synchronize()
    after = counts()
    counted = {k: after[k] - before.get(k, 0) for k in after}
    return prof.profiler.kineto_results.events(), work, counted


def capture(run: Callable[[], Dict], counts: Callable[[], Dict[str, int]],
            expected: Dict[str, int]) -> Trace:
    """Run ``run()`` without the profiler (its host-clock window is the
    work's ``plain_window_s``), under pass B, then under pass A, and reduce
    the passes.
    ``run()`` does the window's work, marks it and its steps or requests,
    ends synchronised and returns its account, with ``window_ns`` (its
    host-clock bounds, ``time.time_ns``, the profiler's clock). ``counts()``
    reads the port's launch counters; ``expected`` is the launches worked
    out from shapes for one run's work."""
    from torch.profiler import ProfilerActivity
    plain = run()
    per_call, idle, records_b = _attempts(lambda: _pass_b(
        *_profile(run, counts, [ProfilerActivity.CPU, ProfilerActivity.CUDA])[::2], expected))
    work, ops = _attempts(lambda: _pass_a(
        *_profile(run, counts, [ProfilerActivity.CUDA]), expected, per_call, records_b))
    work["plain_window_s"] = (plain["window_ns"][1] - plain["window_ns"][0]) / 1e9
    return Trace(window_ns=work["window_ns"], ops=ops, work=work, idle_by_host=idle)


def _attempts(profile_pass):
    """``profile_pass()``, run again while it raises ``RecordsLost``."""
    for attempt in range(ATTEMPTS):
        try:
            return profile_pass()
        except RecordsLost:
            if attempt == ATTEMPTS - 1:
                raise


def _pass_a(events, work, counted, expected, per_call, records_b):
    """Check pass A's counts; return (the run's account, its device ops
    with their groups)."""
    device = _device_events(events)
    if len(device) < records_b * (1 - 5e-4):
        raise RecordsLost(f"pass A: {len(device)} device records against pass B's {records_b}")
    ops = [(n, groups.group(n), s, t) for n, s, t, _ in device]
    _check_counts("pass A", {}, counted, expected)
    launched: Dict[str, int] = defaultdict(int)
    for _, label, _, _ in ops:
        kernel = groups.port_kernel(label)
        if kernel is not None:
            launched[kernel] += 1
    for kernel, n in expected.items():
        got, want = launched.get(kernel, 0), n * per_call.get(kernel, 0)
        if got != want:
            error = RecordsLost if got < want else TraceError
            raise error(f"{kernel}: {got} device launches in pass A, {n} calls of "
                        f"{per_call.get(kernel, 0)} each expected")
    return work, ops


def _pass_b(events, counted, expected):
    """Check pass B's attribution and counts; return (device launches a
    call of each port kernel, idle ns by host op, its device records)."""
    window = None
    device, cpu, launch = _device_events(events), [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        name, s, t, tid = e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()
        if name == WINDOW:
            window = (s, t, tid)
        elif e.correlation_id() and name.startswith("cu"):
            launch[e.correlation_id()] = s
        cpu.append((name, s, t, tid))
    if window is None:
        raise TraceError(f"no {WINDOW} span in the trace")
    w0, w1, main = window
    calls: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for name, s, t, _ in cpu:
        if name.startswith(PORT_OP) and s >= w0 and t <= w1:
            calls[kernel_of_op(name)].append((s, t))
    for v in calls.values():
        v.sort()
    launched = _check_attribution(device, launch, calls, cpu)
    _check_counts("pass B", {k: len(v) for k, v in calls.items()}, counted, expected)
    per_call = {}
    for kernel, n in expected.items():
        if n:
            per_call[kernel], rest = divmod(launched.get(kernel, 0), n)
            if rest or not per_call[kernel]:
                raise RecordsLost(f"{kernel}: {launched.get(kernel, 0)} device launches for {n} calls")
    host = [(n, s, t) for n, s, t, tid in cpu if tid == main and w0 <= s and t <= w1
            and n not in SPANS]
    return per_call, idle_by_host(device_gaps(device, launch), host), len(device)


def kernel_of_op(name: str) -> str:
    """The port's counter name of an operator: ``repro_torch::flash_attention_fwd``
    counts under ``flash_attention``."""
    op = name[len(PORT_OP):].split(".")[0]
    return op[:-len("_fwd")] if op.endswith("_fwd") else op


def _check_attribution(device, launch, calls, cpu) -> Dict[str, int]:
    """Each kernel of a port group was launched inside a call of its
    kernel's operator; returns the device launches of each port kernel."""
    launched: Dict[str, int] = defaultdict(int)
    for name, _, _, corr in device:
        label = groups.group(name)
        kernel = groups.port_kernel(label)
        if kernel is None:
            continue
        if corr not in launch:
            raise RecordsLost(f"no host launch found for {name[:80]}")
        t = launch[corr]
        spans = calls.get(kernel, [])
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        if i < 0 or not spans[i][0] <= t <= spans[i][1]:
            around = sorted({n for n, s, e, _ in cpu if s <= t <= e})[:12]
            raise TraceError(f"{name[:80]} (group {label!r}) was not launched inside "
                             f"{PORT_OP}{kernel}: host ops around its launch {around}, "
                             f"port operators in the trace {sorted(calls)}")
        launched[kernel] += 1
    return launched


def _check_counts(where: str, calls: Dict[str, int], counted: Dict[str, int],
                  expected: Dict[str, int]) -> None:
    """The window's calls of each port kernel by the trace (pass B only),
    by the port's counter and by shapes must agree."""
    kernels = set(expected) | {k for k, v in counted.items() if v} | set(calls)
    for kernel in sorted(kernels):
        got = (counted.get(kernel, 0), expected.get(kernel, 0))
        if where == "pass B":
            got += (calls.get(kernel, 0),)
        if len(set(got)) != 1:
            raise TraceError(f"{where}, {kernel}: {got[0]} calls by the port's counter, {got[1]} "
                             f"from shapes" + (f", {got[2]} in the trace" if len(got) > 2 else ""))
