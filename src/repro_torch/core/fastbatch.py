"""Batched analytic tier: vectorize the fast path across configurations.

The fast tier (:mod:`repro_torch.core.fastpath`) made *one* run cheap; the
binding cost in a sweep is then the per-job Python dispatch — every
(hardware, plan) point walks its own chains node-by-node through
``_ChainEval.run``. But a co-design sweep is dominated by configurations
that share the *structure* of their chains (same mesh topology, same
mapped graph shape, same schedule) and differ only in the float leaves
(compute times, transfer times, byte counts) that the hardware axes
scale. This module exploits that:

1. every fast-path-eligible job's compiled :class:`~repro_torch.core.
   fastpath.StageChains` is *skeletonized* — float leaves stripped into a
   flat per-job leaf vector, structure hashed into a chain **shape
   signature** (stage count, microbatch count, work lists, hold lanes,
   par/spawn nesting);
2. jobs are grouped by signature and each group's leaf vectors are
   packed into one ``(num_leaves, num_configs)`` float64 matrix;
3. one structural replay evaluates the whole group: each chain is
   compiled once into an int32 program, every evaluation of it is one
   ``chain_replay`` launch over the group's configurations (one thread a
   configuration, strict left folds), and the scheduler's mailbox replay
   runs *once* with ``(num_configs,)`` time vectors instead of once per
   job.

On the card: per-job classification, chain compilation and grouping stay
on the host. A group's leaf matrix and programs go to the device once;
the mailbox glue (NaN-propagating maxima and selects), the interval
validation (stable sorts) and the totals are torch ops there; the
per-config results come back in one transfer a group. ``device="cpu"``
runs the same code on CPU tensors, where ``chain_replay`` takes its plain
version.

Why grouping is sound: the optimistic replay's control flow is purely
structural — which mailbox fills at which step, which chain body runs
next, when the work lists drain — none of it depends on the float
values, only on the (shared) structure. And why the numbers are
bit-identical: every time is the strict sequential left fold
``((t + x1) + x2)...`` the scalar tier evaluates (a parallel scan such
as ``torch.cumsum`` would reassociate, so the kernel folds a row at a
time), elementwise float64 ops equal their scalar counterparts per
element (divisions are tensor by tensor: a CUDA division by a host scalar
multiplies by its reciprocal), and every fold (par joins, totals, byte
counters) runs in the same fixed node order as the scalar tier, so
IEEE-754 never reassociates.

Per-job semantics are preserved: interval validation runs per config
(stable sorts over each config's intervals, which is the reference's
flat lexsort with the config as primary key), contended or otherwise
ineligible configs fall back individually, and groups too small to
amortize the vector overhead take the scalar replay.

Known divergence: batched results leave ``noc_occupancy_fallback``
empty (its float accumulation order cannot be cheaply vectorized); the
field is compare-excluded and the sweep layer clears it anyway.
"""

from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter
from typing import Dict, List, Optional, Tuple

import numpy as _np
import torch

from .. import resolve_device
from ..kernels.chain_replay import CHAIN_OPS, MAX_DEPTH, chain_replay
from ..kernels.ref import np_maximum, np_minimum
from .fastpath import (
    StageChains,
    classify_cached,
    compile_stage_chains,
    replay_chains,
)
from .parallelism import FD
from .trace import KIND_BD, KIND_FD, KIND_GU, Trace

__all__ = ["run_fast_batch", "compile_chain", "BatchCompileError"]

_CONTENDED = "resource contention detected by interval validation"
_STALLED = "work-list replay stalled (mailbox never filled)"

_SEG, _PAR, _BRANCH_END, _PAR_END, _SPAWN, _SPAWN_END, _END = (
    CHAIN_OPS[k] for k in ("seg", "par", "branch_end", "par_end", "spawn",
                           "spawn_end", "end"))


def _padd(profile: Optional[Dict], key: str, val) -> None:
    if profile is not None:
        profile[key] = profile.get(key, 0) + val


# ---------------------------------------------------------------------------
# skeletonization: split a chain into structure (hashable) + float leaves
# ---------------------------------------------------------------------------

def _skeletonize(chain, leaves: List[float]) -> Tuple:
    """Strip a chain's float leaves (appended to ``leaves`` in walk
    order) and return its hashable structure. The walk order — node
    order, par branches left-to-right, spawn bodies inline — is the
    contract :class:`_Compiler` assigns leaf rows by."""
    out = []
    for node in chain:
        tag = node[0]
        if tag == "dt":
            leaves.append(node[1])
            out.append(("dt",))
        elif tag == "hold":
            leaves.append(node[2])
            out.append(("hold", tuple(node[1])))
        elif tag == "par":
            out.append(("par", tuple(_skeletonize(b, leaves)
                                     for b in node[1])))
        elif tag == "bytes":
            leaves.append(node[2])
            out.append(("bytes", node[1]))
        else:  # "spawn"
            out.append(("spawn", _skeletonize(node[1], leaves)))
    return tuple(out)


def _signature(sim, chains: StageChains):
    """Chain shape signature + this job's leaf vector.

    Two jobs with equal signatures replay identically modulo leaf
    values: same stages, same microbatch count and work lists, same
    hold lanes, same par/spawn nesting — so one structural replay
    serves the whole group."""
    S = sim.mapped.num_stages
    leaves: List[float] = []
    skels = []
    for slot in chains:         # NamedTuple order == _Compiler walk order
        skels.append(tuple(None if ch is None else _skeletonize(ch, leaves)
                           for ch in slot))
    work = tuple(tuple(sim._work_list(s)) for s in range(S))
    sig = (S, sim.plan.num_microbatches, bool(sim.plan.training),
           bool(sim.collect_timeline), work, tuple(skels))
    return sig, leaves


# ---------------------------------------------------------------------------
# program compilation: skeleton -> chain_replay bytecode
# ---------------------------------------------------------------------------

class _Prog:
    """One compiled chain: its first word in the group's program buffer,
    the packed lane keys of its holds in emission order, and the counts
    one evaluation produces. ``nodes`` is the total chain-node count this
    program contributes per evaluation, *including* par branches and
    spawn bodies — the scalar ``_ChainEval`` adds ``len(chain)`` on
    every (recursive) ``run`` call, and it never skips a branch, so the
    per-run total is static."""

    __slots__ = ("entry", "keys", "spawns", "depth", "nodes")

    def __init__(self, entry, keys, spawns, depth, nodes):
        self.entry = entry
        self.keys = keys            # (holds,) int64 pack_lane ids
        self.spawns = spawns
        self.depth = depth          # deepest par/spawn nesting
        self.nodes = nodes


_ACC_IDX = {"noc": 0, "dram": 1}        # anything else is fabric (2)


class _Compiler:
    """Compiles a signature's skeletons into one int32 program buffer
    (the format of ``csrc/chain_replay.cu``), assigning every float leaf
    a row in the group's leaf matrix. One compiler walks all chain slots
    in :class:`StageChains` order, so the row assignment matches
    :func:`_skeletonize`'s leaf collection order exactly.

    A maximal run of dt/hold nodes and the byte counters interleaved with
    them is one segment: the leaf rows to advance by in order, the prefix
    position of each hold (one entry a lane key: the interval
    ``[P[j], P[j+1]]``), and each accumulator's rows in walk order (each
    accumulator is its own left fold, so grouping them keeps every
    bit)."""

    def __init__(self):
        self.row = 0
        self.code: List[int] = []

    def prog(self, skel) -> _Prog:
        entry = len(self.code)
        keys: List[int] = []
        nodes, spawns, depth = self._emit(skel, keys)
        self.code.append(_END)
        if depth > MAX_DEPTH:
            raise ValueError(f"chain nests par/spawn {depth} deep; chain_replay "
                             f"holds {MAX_DEPTH}")
        return _Prog(entry, _np.asarray(keys, dtype=_np.int64), spawns,
                     depth, nodes)

    def _emit(self, skel, keys: List[int]) -> Tuple[int, int, int]:
        """Append ``skel``'s code; returns (nodes, spawns, depth)."""
        code = self.code
        nodes, spawns, depth = len(skel), 0, 0
        adv: List[int] = []
        hold_pos: List[int] = []
        bytes_rows: Dict[int, List[int]] = {}

        def flush():
            nonlocal adv, hold_pos, bytes_rows
            if adv or bytes_rows:
                rows = [bytes_rows.get(a, []) for a in range(3)]
                code.extend((_SEG, len(adv), len(hold_pos),
                             *(len(r) for r in rows)))
                code.extend(adv)
                code.extend(hold_pos)
                for r in rows:
                    code.extend(r)
                adv, hold_pos, bytes_rows = [], [], {}

        for node in skel:
            tag = node[0]
            if tag == "dt":
                adv.append(self.row)
                self.row += 1
            elif tag == "hold":
                j = len(adv)        # interval = [P[j], P[j+1]] per key
                adv.append(self.row)
                self.row += 1
                for k in node[1]:
                    hold_pos.append(j)
                    keys.append(k)
            elif tag == "bytes":
                bytes_rows.setdefault(_ACC_IDX.get(node[1], 2),
                                      []).append(self.row)
                self.row += 1
            elif tag == "par":
                flush()
                code.append(_PAR)
                inner = 0
                for b in node[1]:
                    n, sp, d = self._emit(b, keys)
                    code.append(_BRANCH_END)
                    nodes += n
                    spawns += sp
                    inner = max(inner, d)
                code.append(_PAR_END)
                depth = max(depth, inner + 1)
            else:  # "spawn"
                flush()
                code.append(_SPAWN)
                n, sp, d = self._emit(node[1], keys)
                code.append(_SPAWN_END)
                nodes += n
                spawns += sp + 1
                depth = max(depth, d + 1)
        flush()
        return nodes, spawns, depth


def _compile_group(skels) -> Tuple[StageChains, int, _np.ndarray]:
    """(the group's programs, leaf rows, the int32 program buffer)."""
    comp = _Compiler()
    slots = [[None if sk is None else comp.prog(sk) for sk in slot]
             for slot in skels]
    return (StageChains(*slots), comp.row,
            _np.asarray(comp.code, dtype=_np.int32))


def compile_chain(chain):
    """One chain as a ``chain_replay`` program: (the int32 code, its
    :class:`_Prog`, the chain's leaf vector in row order). For holding
    the kernel against the scalar ``_ChainEval`` on chains of any shape."""
    leaves: List[float] = []
    comp = _Compiler()
    prog = comp.prog(_skeletonize(chain, leaves))
    return _np.asarray(comp.code, dtype=_np.int32), prog, leaves


# ---------------------------------------------------------------------------
# vector chain evaluation
# ---------------------------------------------------------------------------

class _BatchEval:
    """The vector counterpart of ``_ChainEval``: time is a
    ``(num_configs,)`` float64 tensor, one ``run`` is one ``chain_replay``
    call, intervals are recorded as ``(keys, (n, G) start/end)`` chunks,
    byte counters are a ``(3, G)`` tensor the kernel adds into in walk
    order."""

    __slots__ = ("code", "V", "key_chunks", "start_chunks", "end_chunks",
                 "accs", "nodes", "spawned")

    def __init__(self, code, V):
        self.code = code                # the group's int32 programs
        self.V = V                      # (num_leaves, G) leaf matrix
        self.key_chunks: List = []
        self.start_chunks: List = []
        self.end_chunks: List = []
        self.accs = V.new_zeros((3, V.shape[1]))
        self.nodes = 0
        self.spawned: List = []

    def run(self, prog: _Prog, t):
        self.nodes += prog.nodes
        t, starts, ends, spawned = chain_replay(
            self.code, self.V, t, self.accs, entry=prog.entry,
            holds=len(prog.keys), spawns=prog.spawns, depth=prog.depth)
        if len(prog.keys):
            self.key_chunks.append(prog.keys)
            self.start_chunks.append(starts)
            self.end_chunks.append(ends)
        self.spawned.extend(spawned.unbind(0))
        return t


# ---------------------------------------------------------------------------
# interval validation
# ---------------------------------------------------------------------------

def _argsort(x, dim):
    return torch.sort(x, dim=dim, stable=True)[1]


def _lexsort_rows(keys):
    """``np.lexsort(keys)`` along the last dim of each row: stable sorts
    from the last key to the first (``keys[-1]`` is the primary key).
    Returns the permutation, (rows, n) int64."""
    order = _argsort(keys[0], 1)
    for k in keys[1:]:
        order = order.gather(1, _argsort(k.gather(1, order), 1))
    return order


def _validate_rows(keys, starts, ends):
    """The reference's flat path, a config per row: (contended (G,),
    and each config's intervals ordered by (end, start, key) as (G, N)
    starts, ends and keys). ``keys`` (N,) int64; ``starts``/``ends`` (N, G)."""
    S = starts.T.contiguous()
    E = ends.T.contiguous()
    K = keys.expand(S.shape[0], -1)
    order = _lexsort_rows((S - E, S, K))        # key, start, -duration
    ks, ss, es = K.gather(1, order), S.gather(1, order), E.gather(1, order)
    bad = (ks[:, 1:] == ks[:, :-1]) & (ss[:, 1:] < es[:, :-1])
    order2 = _lexsort_rows((K, S, E))           # end, start, key
    return (bad.any(dim=1), S.gather(1, order2), E.gather(1, order2),
            K.gather(1, order2))


def _validate_lanes(keys_np, starts, ends):
    """The reference's per-lane path: within each lane, two stacked
    stable sorts along the interval axis — by (s - e), then by s — give
    the (s, s - e, emission-order) ordering; contended where a start
    falls before its predecessor's end. Lanes with the same number of
    intervals are sorted together as one (lanes, L, G) block."""
    G = starts.shape[1]
    contended = torch.zeros(G, dtype=torch.bool, device=starts.device)
    lane_order = _np.argsort(keys_np, kind="stable")
    ks = keys_np[lane_order]
    blocks = _np.split(lane_order, _np.flatnonzero(ks[1:] != ks[:-1]) + 1)
    by_len: Dict[int, List] = {}
    for rows in blocks:
        if len(rows) >= 2:
            by_len.setdefault(len(rows), []).append(rows)
    for rows in by_len.values():
        idx = torch.from_numpy(_np.stack(rows)).to(starts.device)
        A, B = starts[idx], ends[idx]           # (lanes, L, G)
        o1 = _argsort(A - B, 1)
        A1, B1 = A.gather(1, o1), B.gather(1, o1)
        o2 = _argsort(A1, 1)
        A2, B2 = A1.gather(1, o2), B1.gather(1, o2)
        contended |= (A2[:, 1:] < B2[:, :-1]).any(dim=1).any(dim=0)
    return contended


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# group replay (the vectorized mirror of fastpath.replay_chains)
# ---------------------------------------------------------------------------

def _replay_group(sims, progs: StageChains, code, V, profile: Optional[Dict]):
    """Replay one signature group; returns the per-sim outcome list
    (``(SimResult | None, reason | None)`` in ``sims`` order).

    Structurally this is ``fastpath.replay_chains`` with every float
    replaced by a ``(G,)`` tensor; every branch the scalar replay takes
    on float *presence* (mailbox filled or not) is structural, so one
    pass serves the whole group."""
    from .scheduler import SimResult

    dev = V.device
    sim0 = sims[0]
    G = len(sims)
    S = sim0.mapped.num_stages
    M = sim0.plan.num_microbatches
    training = sim0.plan.training
    collect_timeline = sim0.collect_timeline

    fd_body, fd_post, bd_body, bd_last, bd_post, gu_body = progs

    ev = _BatchEval(code, V)
    work = [list(sim0._work_list(s)) for s in range(S)]
    pos = [0] * S
    zero = V.new_zeros(G)
    cursor = [zero] * S                 # entries replaced, never mutated
    prev_row = [-1] * S                 # structural (same row for all configs)
    row_idx: Dict[Tuple[int, int, int], int] = {}
    act = {(0, i): zero for i in range(M)}
    grad: Dict[Tuple[int, int], object] = {}
    fd_done: Dict[Tuple[int, int], object] = {}
    pending: List[List] = [[] for _ in range(S)]
    gu_todo = [training] * S

    # trace rows: structural columns + per-config float/pred columns
    tr_stage: List[int] = []
    tr_kind: List[int] = []
    tr_micro: List[int] = []
    tr_start: List = []
    tr_end: List = []
    tr_pred: List = []                  # scalar int or (G,) int tensor

    def rec(s, kind, mb, start, end, pred) -> int:
        tr_stage.append(s)
        tr_kind.append(kind)
        tr_micro.append(mb)
        tr_start.append(start)
        tr_end.append(end)
        tr_pred.append(pred)
        return len(tr_stage) - 1

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
                    start = np_maximum(t0, dep)
                    end = ev.run(fd_body[s], start)
                    fd_done[(s, mb)] = end
                    if s > 0:
                        pred = torch.where(dep > t0,
                                           row_idx.get((s - 1, KIND_FD, mb),
                                                       -1),
                                           prev_row[s])
                    else:
                        pred = prev_row[s]
                    r = rec(s, KIND_FD, mb, start, end, pred)
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
                    start = np_maximum(t0, dep)
                    n_sp = len(ev.spawned)
                    body = bd_last[s] if mb == M - 1 else bd_body[s]
                    end = ev.run(body, start)
                    pending[s].extend(ev.spawned[n_sp:])
                    row = (row_idx.get((s, KIND_FD, mb), -1) if s == S - 1
                           else row_idx.get((s + 1, KIND_BD, mb), -1))
                    pred = torch.where(dep > t0, row, prev_row[s])
                    r = rec(s, KIND_BD, mb, start, end, pred)
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
                start = t0
                for p in pending[s]:
                    start = np_maximum(start, p)
                pred = torch.where(start > t0,
                                   row_idx.get((s, KIND_BD, M - 1), -1),
                                   prev_row[s])
                end = ev.run(gu_body[s], start)
                r = rec(s, KIND_GU, 0, start, end, pred)
                row_idx[(s, KIND_GU, 0)] = r
                prev_row[s] = r
                cursor[s] = end
                gu_todo[s] = False
                progress = True

    if any(pos[s] < len(work[s]) for s in range(S)) or any(gu_todo):
        # deadlock is structural: the whole group stalls identically
        return [(None, _STALLED)] * G

    # -- per-config interval validation -------------------------------------
    if profile is not None:
        _sync(dev)
    t_val = perf_counter()
    contended = torch.zeros(G, dtype=torch.bool, device=dev)
    N = 0
    sorted_cols = ()
    if ev.key_chunks:
        keys_np = _np.concatenate(ev.key_chunks)        # (N,) packed lanes
        starts = torch.cat(ev.start_chunks)             # (N, G)
        ends = torch.cat(ev.end_chunks)
        N = len(keys_np)
        if collect_timeline:
            # timeline runs need the full per-config resource rows anyway,
            # so validate off the same per-config sort that orders the
            # emission
            contended, *sorted_cols = _validate_rows(
                torch.from_numpy(keys_np).to(dev), starts, ends)
        else:
            contended = _validate_lanes(keys_np, starts, ends)
    if profile is not None:
        _sync(dev)
    _padd(profile, "validate_us", (perf_counter() - t_val) * 1e6)

    # -- totals & throughput -------------------------------------------------
    total = cursor[0]
    for s in range(1, S):
        total = np_maximum(total, cursor[s])
    samples = torch.tensor([float(sim.plan.global_batch) for sim in sims],
                           dtype=torch.float64, device=dev)
    bad_thpt = torch.zeros(G, dtype=torch.bool, device=dev)
    if training or M <= 1:
        throughput = torch.where(total > 0, samples / total, 0.0)
    else:
        first = fd_done[(S - 1, 0)]
        last = first
        for i in range(1, M):
            v = fd_done[(S - 1, i)]
            first = np_minimum(first, v)
            last = np_maximum(last, v)
        # tensor by tensor: CUDA divides by a host scalar through its
        # reciprocal, which is not IEEE division
        per_mb = samples / torch.full_like(samples, float(M))
        throughput = (M - 1) * per_mb / (last - first)
        bad_thpt = ~torch.isfinite(throughput)

    # -- one transfer: every per-config column of the group ------------------
    R = len(tr_stage)
    pred_mat = torch.stack([
        p.to(torch.float64) if isinstance(p, torch.Tensor)
        else torch.full((G,), float(p), dtype=torch.float64, device=dev)
        for p in tr_pred]) if R else V.new_empty((0, G))
    parts = [total, throughput, contended.to(torch.float64),
             bad_thpt.to(torch.float64), ev.accs,
             torch.stack(tr_start) if R else V.new_empty((0, G)),
             torch.stack(tr_end) if R else V.new_empty((0, G)), pred_mat,
             *(c.to(torch.float64) for c in sorted_cols)]
    host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    sizes = [p.numel() for p in parts]
    total, throughput, contended, bad_thpt, accs, start_mat, end_mat, \
        pred_mat, *cols = [
            a.reshape(p.shape) for a, p in
            zip(_np.split(host, _np.cumsum(sizes)[:-1]), parts)]

    # -- per-config SimResults ----------------------------------------------
    stage_col = _np.asarray(tr_stage, dtype=_np.int32)
    kind_col = _np.asarray(tr_kind, dtype=_np.int8)
    micro_col = _np.asarray(tr_micro, dtype=_np.int32)
    res_col = _np.full(R, -1, dtype=_np.int32)
    pred_mat = pred_mat.astype(_np.int32)

    out = []
    for g, sim in enumerate(sims):
        if contended[g]:
            out.append((None, _CONTENDED))
            _padd(profile, "contended_jobs", 1)
            continue
        if bad_thpt[g]:
            out.append((None, "non-finite inference throughput"))
            continue
        st_g = _np.ascontiguousarray(start_mat[:, g])
        en_g = _np.ascontiguousarray(end_mat[:, g])
        pr_g = _np.ascontiguousarray(pred_mat[:, g])
        if collect_timeline and N:
            stv, env, kv = cols[0][g], cols[1][g], cols[2][g]
            keep = env > stv            # zero-length intervals suppressed
            kk = kv[keep].astype(_np.int64)
            n_res = len(kk)
            trace = Trace(
                stage=_np.concatenate(
                    [stage_col, _np.full(n_res, -1, dtype=_np.int32)]),
                kind=_np.concatenate(
                    [kind_col, (kk >> 32).astype(_np.int8)]),
                micro=_np.concatenate(
                    [micro_col, _np.full(n_res, -1, dtype=_np.int32)]),
                resource=_np.concatenate(
                    [res_col, (kk & 0xFFFFFFFF).astype(_np.int32)]),
                start=_np.concatenate([st_g, stv[keep]]),
                end=_np.concatenate([en_g, env[keep]]),
                pred=_np.concatenate(
                    [pr_g, _np.full(n_res, -1, dtype=_np.int32)]),
                total_time=float(total[g]), num_stages=S)
        else:
            trace = Trace(stage=stage_col, kind=kind_col, micro=micro_col,
                          resource=res_col, start=st_g, end=en_g,
                          pred=pr_g, total_time=float(total[g]),
                          num_stages=S)
        out.append((SimResult(
            total_time=float(total[g]),
            throughput=float(throughput[g]),
            stage_memory=sim.memory,
            recompute=sim.recompute,
            event_count=ev.nodes,
            noc_bytes=float(accs[0][g] + accs[2][g]),
            dram_bytes=float(accs[1][g]),
            engine="fast",
            trace=trace,
            noc_occupancy_fallback={},
        ), None))
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

class BatchCompileError(Exception):
    """The host half of a batch (per-job classification, chain compilation,
    signature grouping, the scalar replay of a job no group takes) tripped
    on one configuration. A sweep catches this one and re-runs the batch
    job by job, as the reference does for any error of its batch. A group's
    program compiler, its replay on the device and ``chain_replay``'s own
    refusals are not wrapped: their errors propagate."""


@contextmanager
def _host_compile():
    try:
        yield
    except (ValueError, KeyError, TypeError) as e:
        raise BatchCompileError(f"{type(e).__name__}: {e}") from e


def run_fast_batch(sims, *, min_group: int = 2,
                   classify_memo: Optional[Dict] = None,
                   profile: Optional[Dict] = None, device=None):
    """Evaluate many simulators through the fast tier, vectorizing
    across configurations that share a chain shape signature.

    Returns one ``(SimResult | None, reason | None)`` pair per input
    sim, in order — exactly the contract of a ``try_fast_run`` per job
    (``None`` result means the caller should fall back to the event
    tier for that job; the reason says why). Results are bit-identical
    to the scalar fast tier. ``min_group`` is the smallest signature
    group worth the vector overhead; smaller groups take the scalar
    replay on their already-compiled chains. ``classify_memo`` and
    ``profile`` are optional caller-owned dicts (classifier cache and
    per-phase timing/count accumulator). ``device`` is where the groups
    replay: ``None`` means the card (and raises without one), ``"cpu"``
    the plain versions on the host. An error of the host half raises
    :class:`BatchCompileError`; any other error is raised as it is."""
    dev = resolve_device(device)
    out: List = [None] * len(sims)
    _padd(profile, "jobs", len(sims))

    t0 = perf_counter()
    groups: Dict[Tuple, List[int]] = {}
    per: List = [None] * len(sims)      # (chains, leaves) for eligible jobs
    with _host_compile():
        for i, sim in enumerate(sims):
            reason = classify_cached(sim, classify_memo)
            if reason is not None:
                out[i] = (None, reason)
                _padd(profile, "ineligible_jobs", 1)
                continue
            chains = compile_stage_chains(sim)
            if getattr(sim.noc, "metrics_levels", False):
                # per-level payload metadata rides as extra chain-node fields
                # the group skeletonizer does not model — the scalar replay
                # preserves it, so fabric jobs with metrics enabled skip
                # signature grouping
                out[i] = replay_chains(sim, chains)
                _padd(profile, "scalar_jobs", 1)
                continue
            sig, leaves = _signature(sim, chains)
            per[i] = (chains, leaves)
            groups.setdefault(sig, []).append(i)
    _padd(profile, "compile_us", (perf_counter() - t0) * 1e6)

    for sig, idxs in groups.items():
        if len(idxs) < min_group:
            _padd(profile, "scalar_jobs", len(idxs))
            with _host_compile():
                for i in idxs:
                    out[i] = replay_chains(sims[i], per[i][0])
            continue
        t1 = perf_counter()
        v0 = profile.get("validate_us", 0) if profile is not None else 0
        progs, n_rows, code = _compile_group(sig[5])
        if n_rows != len(per[idxs[0]][1]):      # pragma: no cover - invariant
            raise AssertionError("leaf row assignment out of sync with "
                                 "skeleton walk")
        V = _np.ascontiguousarray(_np.asarray(
            [per[i][1] for i in idxs], dtype=_np.float64).T)
        results = _replay_group([sims[i] for i in idxs], progs,
                                torch.from_numpy(code).to(dev),
                                torch.from_numpy(V).to(dev), profile)
        for j, i in enumerate(idxs):
            out[i] = results[j]
        dv = ((profile.get("validate_us", 0) - v0)
              if profile is not None else 0)
        _padd(profile, "eval_us", (perf_counter() - t1) * 1e6 - dv)
        _padd(profile, "groups", 1)
        _padd(profile, "batched_jobs", len(idxs))
    return out
