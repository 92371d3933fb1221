"""Closed-form fast tier of the two-tier simulator core.

The event kernel (:mod:`repro_torch.core.events`) prices every NoC leg, DRAM
stream and compute phase through the Python heap — the binding cost at
scale-out sizes (ROADMAP; Proteus shows the remedy). This module is the
analytic tier: it *replays* the scheduler's deterministic work lists in
plain arithmetic under the assumption that no resource is ever contended,
then **validates** that assumption against the full set of resource busy
intervals the run would have produced. Only when the optimistic execution
is proven contention-free is its result returned; otherwise the caller
falls back to the generator/heap kernel (the refinement tier).

Why this is exact, not approximate: under zero contention every
``Resource.request`` in the event kernel grants immediately (no time
advance), sequential ``yield``s accumulate durations left-to-right, and
``all_of`` completes at the max of its branches. Both facts commute with
IEEE-754 rounding (``t + max(a, b) == max(t + a, t + b)`` because
rounding is monotone), so evaluating the same float expression tree in
chain form reproduces the event kernel's timestamps bit-for-bit. The
models therefore export ``*_chain`` builders (``NoCModel.transfer_chain``
etc.) that mirror their generator bodies node-for-node rather than
algebraically simplified closed forms.

Chain nodes (plain tuples, struct-of-arrays evaluated):

* ``("dt", x)``          — advance local time by ``x``
* ``("hold", keys, x)``  — record a busy interval ``[t, t+x]`` on every
  packed ``(lane_kind, lane_id)`` key (:func:`repro_torch.core.trace.pack_lane`),
  then advance by ``x``
* ``("par", branches)``  — evaluate every branch from the current time,
  continue at the max end (``all_of`` of concurrently spawned processes)
* ``("bytes", acc, n)``  — bump the ``noc``/``dram``/``fabric`` counter
* ``("spawn", chain)``   — evaluate the chain from the current time
  without advancing (an async ``env.process``); its end time joins the
  stage's pending-DP barrier

Contention validation: the recorded intervals are sorted per lane by
``(start, -duration)``; the run is contention-free iff no interval starts
strictly before its same-lane predecessor ends. Sorting by start makes
the consecutive-pair check complete (if any pair overlaps, a consecutive
pair does), and the ``-duration`` tie-break conservatively flags a
zero-length hold landing at the start of a longer one (whose event-tier
ordering would be heap-order dependent). Touching endpoints are exact:
the queued request is granted at the very release instant, displacing
nothing.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

try:
    import numpy as _np
except ImportError:         # pragma: no cover - exercised by CI bench-smoke
    _np = None

from .enums import BoundaryMode
from .parallelism import BD, FD, GU
from .trace import (
    KIND_BD,
    KIND_DRAM,
    KIND_FABRIC,
    KIND_FD,
    KIND_GU,
    TraceRecorder,
)

__all__ = ["FastPathIneligible", "classify", "classify_cached",
           "compile_stage_chains", "replay_chains", "try_fast_run",
           "StageChains", "reason_code"]


class FastPathIneligible(Exception):
    """The mapped graph (or its observed traffic) needs the event tier."""


# machine-readable codes for the prose rejection reasons this module and
# fastbatch produce (substring-matched so wording can carry detail);
# surfaced in RunReport.metrics["host"]["fastpath_rejection"] and as
# host.fastpath.reject.<code> sweep counters
_REASON_CODES = (
    ("interleaved virtual stages", "interleave"),
    ("group-to-group boundary", "strategy_boundary"),
    ("resource contention", "contention"),
    ("replay stalled", "stalled"),
    ("non-finite inference throughput", "nonfinite_throughput"),
    ("batch compilation failed", "batch_compile"),
)


def reason_code(reason: Optional[str]) -> str:
    """Map a prose fast-path rejection reason to its stable code."""
    if not reason:
        return "other"
    for needle, code in _REASON_CODES:
        if needle in reason:
            return code
    return "other"


# ---------------------------------------------------------------------------
# static classification
# ---------------------------------------------------------------------------

def classify(sim) -> Optional[str]:
    """Static contention-detection pass: return the reason this mapped
    graph cannot take the fast path, or ``None`` when it is a candidate.

    Only constructs whose *timing semantics* the chain algebra cannot
    express are rejected here; ordinary resource contention (links, DRAM
    channels, fabric) is detected dynamically by interval validation
    after the optimistic replay.
    """
    if sim.plan.interleave > 1:
        return ("interleaved virtual stages serialize on a shared "
                "PriorityResource (the 1F1B Prior Selector)")
    if (sim.boundary_mode == BoundaryMode.STRATEGY
            and sim.mapped.num_stages > 1
            and any(len(st.devices) > 1 for st in sim.mapped.stages)):
        return "strategy-mode group-to-group boundary hand-off"
    return None


def _classify_key(sim) -> Tuple:
    """Memo key: hardware digest + plan structure summary. Deliberately
    excludes ``global_batch`` (classification is invariant under
    micro-batch truncation), so multi-fidelity search rungs of the same
    (hardware, plan) candidate share one entry. Sound for memos scoped to
    one experiment: within an experiment the mapping *structure* (stage
    count, per-stage device groups) is a function of the hardware and the
    plan's structural fields alone."""
    p = sim.plan
    return (sim.hw.name, str(sim.boundary_mode), p.interleave,
            p.pp, p.dp, p.tp, bool(p.training), str(p.schedule),
            str(p.layout), bool(p.tp_contiguous), p.microbatch)


def classify_cached(sim, memo: Optional[Dict] = None) -> Optional[str]:
    """:func:`classify` through an optional caller-owned memo dict.

    The sweep path keys one memo per experiment (per worker), so the
    static classifier runs once per (hardware digest, plan summary)
    instead of once per job — microbatch-truncated fidelity rungs of the
    same candidate hit the same entry."""
    if memo is None:
        return classify(sim)
    key = _classify_key(sim)
    try:
        return memo[key]
    except KeyError:
        memo[key] = reason = classify(sim)
        return reason


# ---------------------------------------------------------------------------
# chain evaluation (struct-of-arrays interval recording)
# ---------------------------------------------------------------------------

class _ChainEval:
    """Evaluates chains, recording busy intervals + byte counters."""

    __slots__ = ("keys", "starts", "ends", "noc_bytes", "dram_bytes",
                 "fabric_bytes", "level_bytes", "nodes", "spawned")

    def __init__(self):
        self.keys: List[int] = []       # pack_lane(kind, lane) ids
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.noc_bytes = 0.0
        self.dram_bytes = 0.0
        self.fabric_bytes = 0.0
        self.level_bytes: Dict[int, float] = {}   # fabric level -> bytes
        self.nodes = 0          # chain-node evaluations (sim-cost metric)
        self.spawned: List[float] = []

    def run(self, chain, t: float) -> float:
        # hot loop: local bindings + bulk extends; every branch preserves
        # the exact float expression the event kernel would evaluate
        self.nodes += len(chain)
        keys = self.keys
        starts = self.starts
        ends = self.ends
        run = self.run
        for node in chain:
            tag = node[0]
            if tag == "dt":
                t += node[1]
            elif tag == "hold":
                ks = node[1]
                end = t + node[2]
                n = len(ks)
                if n == 1:
                    keys.append(ks[0])
                    starts.append(t)
                    ends.append(end)
                else:
                    keys.extend(ks)
                    starts.extend([t] * n)
                    ends.extend([end] * n)
                t = end
            elif tag == "par":
                branches = node[1]
                if branches:
                    best = run(branches[0], t)
                    for b in branches[1:]:
                        e2 = run(b, t)
                        if e2 > best:
                            best = e2
                    t = best
            elif tag == "bytes":
                acc = node[1]
                if acc == "noc":
                    self.noc_bytes += node[2]
                elif acc == "dram":
                    self.dram_bytes += node[2]
                else:
                    self.fabric_bytes += node[2]
                    if len(node) > 3:
                        # per-level payload metadata, present only when
                        # the fabric compiled with metrics_levels set
                        lb = self.level_bytes
                        for lvl, b in node[3]:
                            lb[lvl] = lb.get(lvl, 0.0) + b
            else:  # "spawn"
                self.spawned.append(run(node[1], t))
        return t


def _validate_and_order(ev: _ChainEval):
    """Contention-check the recorded intervals, and (when clean) return
    them sorted by ``(end, start, key)`` — the order the event tier
    closes busy intervals in, used for timeline rows and the occupancy
    fallback's float accumulation.

    Returns ``(contended, kinds, lanes, starts, ends)``; the four column
    lists are empty when contended.
    """
    n = len(ev.keys)
    if n == 0:
        return False, [], [], [], []
    if _np is not None:
        key = _np.asarray(ev.keys, dtype=_np.int64)     # pack_lane ids
        s = _np.asarray(ev.starts)
        e = _np.asarray(ev.ends)
        if n > 1:
            order = _np.lexsort((s - e, s, key))   # key, start, -duration
            ks, ss, es = key[order], s[order], e[order]
            if bool(_np.any((ks[1:] == ks[:-1]) & (ss[1:] < es[:-1]))):
                return True, [], [], [], []
        order = _np.lexsort((key, s, e))        # end, start, key
        key = key[order]
        return (False, (key >> 32).tolist(), (key & 0xFFFFFFFF).tolist(),
                s[order].tolist(), e[order].tolist())
    rows = sorted(zip(ev.keys, ev.starts, ev.ends),
                  key=lambda r: (r[0], r[1], r[1] - r[2]))
    for a, b in zip(rows, rows[1:]):
        if b[0] == a[0] and b[1] < a[2]:
            return True, [], [], [], []
    rows.sort(key=lambda r: (r[2], r[1], r[0]))
    return (False, [r[0] >> 32 for r in rows],
            [r[0] & 0xFFFFFFFF for r in rows],
            [r[1] for r in rows], [r[2] for r in rows])


# ---------------------------------------------------------------------------
# chain compilation (mirrors PipelineSimulator's FD/BD/GU bodies)
# ---------------------------------------------------------------------------

def _dram_and_compute_chain(sim, stage, act_bytes, weight_bytes,
                            compute_s) -> List:
    if act_bytes + weight_bytes <= 0:
        return [("dt", compute_s)]
    shards = (stage.weight_shards if sim.plan.weight_multicast
              else len(stage.devices))
    dram = sim.dram.group_access_chain(stage.devices, act_bytes,
                                       shared_bytes=weight_bytes,
                                       num_shards=shards)
    if sim.plan.stream_overlap:
        return [("par", (tuple(dram), (("dt", compute_s),)))]
    return dram + [("dt", compute_s)]


def _collectives_chain(sim, stage, comms, phase) -> List:
    branches = []
    precision = sim.hw.precision_bytes
    for task in comms:
        if task.phase != phase:
            continue
        groups = stage.groups.get(task.axis)
        if not groups:
            continue
        per_dev_bytes = task.elems * precision
        for g in groups:
            branches.append(tuple(sim.noc.collective_chain(
                task.kind, g, per_dev_bytes)))
    return [("par", tuple(branches))] if branches else [("dt", 0.0)]


def _boundary_chain(sim, src: int, dst: int) -> List:
    s_from = sim.mapped.stages[src]
    s_to = sim.mapped.stages[dst]
    nbytes = (sim.mapped.boundary_elems(min(src, dst))
              * sim.hw.precision_bytes)
    # strategy mode with multi-device groups was rejected statically;
    # what remains is the pairwise Megatron-style P2P
    n = min(len(s_from.devices), len(s_to.devices))
    per = nbytes / n
    return [("par", tuple(tuple(sim.noc.transfer_chain(
        s_from.devices[i], s_to.devices[i], per)) for i in range(n)))]


def _fd_body_chain(sim, sid: int) -> List:
    stage = sim.mapped.stages[sid]
    chain: List = []
    if sid == 0 and stage.split_ops:
        first = stage.split_ops[0]
        nbytes = first.act_in_elems_tile * sim.hw.precision_bytes
        chain += sim.dram.group_access_chain(stage.devices, nbytes)
    for split, acc in zip(stage.split_ops, sim.access[sid]):
        chain += _dram_and_compute_chain(
            sim, stage, acc.fd_act, acc.fd_weight,
            sim._compute_time(split.fwd_flops_tile, split.matmul_fraction))
        chain += _collectives_chain(sim, stage, split.comms, FD)
    return chain


def _bd_body_chain(sim, sid: int, last_mb: bool) -> List:
    stage = sim.mapped.stages[sid]
    chain: List = []
    for split, acc in zip(reversed(stage.split_ops),
                          reversed(sim.access[sid])):
        compute = sim._compute_time(split.bwd_flops_tile,
                                    split.matmul_fraction)
        if sim.recompute:
            compute += sim._compute_time(split.fwd_flops_tile,
                                         split.matmul_fraction)
        chain += _dram_and_compute_chain(sim, stage, acc.bd_act,
                                         acc.bd_weight, compute)
        chain += _collectives_chain(sim, stage, split.comms, BD)
        if last_mb:
            chain.append(("spawn",
                          tuple(_collectives_chain(sim, stage, split.comms,
                                                   GU))))
    return chain


def _gu_chain(sim, sid: int) -> List:
    stage = sim.mapped.stages[sid]
    gu_bytes = sum(a.gu_bytes for a in sim.access[sid])
    if gu_bytes <= 0:
        return []
    return (sim.dram.group_access_chain(
                stage.devices, 0.0, shared_bytes=gu_bytes / 2,
                num_shards=stage.weight_shards)
            + sim.dram.group_access_chain(
                stage.devices, 0.0, write=True, shared_bytes=gu_bytes / 2,
                num_shards=stage.weight_shards))


# ---------------------------------------------------------------------------
# optimistic replay
# ---------------------------------------------------------------------------

class StageChains(NamedTuple):
    """The compiled per-stage chain set one replay consumes — shared
    between the scalar replay below and the batched evaluator
    (:mod:`repro_torch.core.fastbatch`), which groups jobs by the chains'
    structural signature."""

    fd_body: List[List]
    fd_post: List[Optional[List]]
    bd_body: List[Optional[List]]
    bd_last: List[Optional[List]]
    bd_post: List[Optional[List]]
    gu_body: List[Optional[List]]


def compile_stage_chains(sim) -> StageChains:
    """Compile every FD/BD/GU body and boundary pass of a mapped graph
    into chain form (one walk of the models' ``*_chain`` builders)."""
    S = sim.mapped.num_stages
    training = sim.plan.training
    return StageChains(
        fd_body=[_fd_body_chain(sim, s) for s in range(S)],
        fd_post=[(_boundary_chain(sim, s, s + 1) if s + 1 < S else None)
                 for s in range(S)],
        bd_body=[(_bd_body_chain(sim, s, False) if training else None)
                 for s in range(S)],
        bd_last=[(_bd_body_chain(sim, s, True) if training else None)
                 for s in range(S)],
        bd_post=[(_boundary_chain(sim, s, s - 1) if training and s > 0
                  else None) for s in range(S)],
        gu_body=[(_gu_chain(sim, s) if training else None)
                 for s in range(S)],
    )


def try_fast_run(sim, strict: bool = False):
    """Attempt the analytic tier on a freshly constructed
    :class:`~repro_torch.core.scheduler.PipelineSimulator`.

    Returns the bit-identical :class:`~repro_torch.core.scheduler.SimResult`
    (``engine="fast"``) when the run is provably contention-free, else
    ``None`` — or raises :class:`FastPathIneligible` under ``strict``.
    The simulator instance is left untouched either way, so the caller
    can still run the event tier on it.
    """
    sim.fastpath_reason = None      # clear any stale batch-tier rejection
    reason = classify(sim)
    if reason is None:
        result, reason = _attempt(sim)
        if result is not None:
            return result
    # leave the rejection on the simulator so the metrics layer can
    # attach a machine-readable reason to the event-tier run that follows
    sim.fastpath_reason = reason
    if strict:
        raise FastPathIneligible(reason)
    return None


def _attempt(sim):
    return replay_chains(sim, compile_stage_chains(sim))


def replay_chains(sim, chains: StageChains):
    """Optimistically replay pre-compiled stage chains; returns
    ``(SimResult | None, reason | None)`` exactly like the fast tier —
    the chain-compilation half lives in :func:`compile_stage_chains` so
    the batched evaluator can reuse it."""
    from .scheduler import SimResult

    S = sim.mapped.num_stages
    M = sim.plan.num_microbatches
    training = sim.plan.training

    fd_body, fd_post, bd_body, bd_last, bd_post, gu_body = chains

    ev = _ChainEval()
    rec = TraceRecorder()
    work = [list(sim._work_list(s)) for s in range(S)]
    pos = [0] * S
    cursor = [0.0] * S
    prev_row = [-1] * S
    row_idx: Dict[Tuple[int, int, int], int] = {}
    act = {(0, i): 0.0 for i in range(M)}
    grad: Dict[Tuple[int, int], float] = {}
    fd_done: Dict[Tuple[int, int], float] = {}
    pending: List[List[float]] = [[] for _ in range(S)]
    gu_todo = [training] * S

    progress = True
    while progress:
        progress = False
        for s in range(S):
            while pos[s] < len(work[s]):
                kind, mb = work[s][pos[s]]
                if kind == FD:
                    dep = act.get((s, mb))
                    if dep is None:
                        break
                    t0 = cursor[s]
                    start = max(t0, dep)
                    end = ev.run(fd_body[s], start)
                    fd_done[(s, mb)] = end
                    pred = (row_idx.get((s - 1, KIND_FD, mb), -1)
                            if dep > t0 and s > 0 else prev_row[s])
                    r = rec.compute(s, KIND_FD, mb, start, end, pred)
                    row_idx[(s, KIND_FD, mb)] = r
                    prev_row[s] = r
                    if fd_post[s] is not None:
                        t_post = ev.run(fd_post[s], end)
                        act[(s + 1, mb)] = t_post
                        cursor[s] = t_post
                    else:
                        if training:
                            grad[(s, mb)] = end
                        cursor[s] = end
                else:
                    dep = grad.get((s, mb))
                    if dep is None:
                        break
                    t0 = cursor[s]
                    start = max(t0, dep)
                    n_sp = len(ev.spawned)
                    body = bd_last[s] if mb == M - 1 else bd_body[s]
                    end = ev.run(body, start)
                    pending[s].extend(ev.spawned[n_sp:])
                    if dep > t0:
                        pred = (row_idx.get((s, KIND_FD, mb), -1)
                                if s == S - 1
                                else row_idx.get((s + 1, KIND_BD, mb), -1))
                    else:
                        pred = prev_row[s]
                    r = rec.compute(s, KIND_BD, mb, start, end, pred)
                    row_idx[(s, KIND_BD, mb)] = r
                    prev_row[s] = r
                    if bd_post[s] is not None:
                        t_post = ev.run(bd_post[s], end)
                        grad[(s - 1, mb)] = t_post
                        cursor[s] = t_post
                    else:
                        cursor[s] = end
                pos[s] += 1
                progress = True
            if pos[s] == len(work[s]) and gu_todo[s]:
                t0 = cursor[s]
                start = max([t0] + pending[s])
                pred = (row_idx.get((s, KIND_BD, M - 1), -1)
                        if start > t0 else prev_row[s])
                end = ev.run(gu_body[s], start)
                r = rec.compute(s, KIND_GU, 0, start, end, pred)
                row_idx[(s, KIND_GU, 0)] = r
                prev_row[s] = r
                cursor[s] = end
                gu_todo[s] = False
                progress = True

    if any(pos[s] < len(work[s]) for s in range(S)) or any(gu_todo):
        # a mailbox never filled: the deterministic work lists deadlocked,
        # which the event tier would too — surface instead of mis-pricing
        return None, "work-list replay stalled (mailbox never filled)"

    contended, ikinds, ilanes, istarts, iends = _validate_and_order(ev)
    if contended:
        return None, "resource contention detected by interval validation"

    if ev.level_bytes:
        # successful replay owns the run: publish per-level fabric payload
        # where the event tier would have accumulated it
        sim.noc.level_bytes.update(ev.level_bytes)

    total = max(cursor, default=0.0)
    samples = sim.plan.global_batch
    if training:
        throughput = samples / total if total > 0 else 0.0
    else:
        finishes = sorted(t for (s, i), t in fd_done.items() if s == S - 1)
        mb_size = samples / M
        if len(finishes) > 1:
            throughput = ((len(finishes) - 1) * mb_size
                          / (finishes[-1] - finishes[0]))
        else:
            throughput = samples / total if total > 0 else 0.0

    if sim.collect_timeline:
        # resource lanes: the event tier emits one row per closed busy
        # interval (zero-length intervals suppressed). Raw row order is
        # tier-dependent; use Trace.canonical() for cross-tier comparison.
        for kk, ll, st, en in zip(ikinds, ilanes, istarts, iends):
            if en > st:
                rec.resource(kk, ll, st, en)

    fallback: Dict[int, float] = {}
    if not sim.collect_timeline:
        # mirror SimResult.noc_occupancy_fallback: per-link busy fraction
        # over every touched NoC/fabric link (fabric ids offset past the
        # chips' NoC id ranges, as in FabricModel.occupancy_report);
        # intervals arrive in (end, start) order so the float sums
        # accumulate exactly as the event tier closes them
        fabric_base = (getattr(sim.noc, "num_chips", 0)
                       * getattr(sim.noc, "_noc_stride", 0))
        busy: Dict[int, float] = {}
        for kk, ll, st, en in zip(ikinds, ilanes, istarts, iends):
            if kk == KIND_DRAM:
                continue
            occ = ll + fabric_base if kk == KIND_FABRIC else ll
            busy[occ] = busy.get(occ, 0.0) + (en - st)
        fallback = {occ: (busy[occ] / total if total > 0 else 0.0)
                    for occ in sorted(busy)}

    return SimResult(
        total_time=total,
        throughput=throughput,
        stage_memory=sim.memory,
        recompute=sim.recompute,
        event_count=ev.nodes,
        noc_bytes=ev.noc_bytes + ev.fabric_bytes,
        dram_bytes=ev.dram_bytes,
        engine="fast",
        trace=rec.freeze(total, S),
        noc_occupancy_fallback=fallback,
    ), None
