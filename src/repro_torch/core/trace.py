"""Columnar event trace — the simulator's first-class execution artifact.

PALM's value is event-driven visibility into FD/BD/GU and NoC/DRAM
interactions; this module stores that timeline as a struct-of-arrays
:class:`Trace` instead of a Python ``List[Tuple]``:

* five core columns — ``stage`` (int32), ``kind`` (int8 event-kind code),
  ``micro`` (int32 micro-batch), ``start``/``end`` (float64 seconds) —
  plus a ``resource`` column (int32) carrying the NoC link id / DRAM
  channel id for resource busy-interval rows (``-1`` on compute rows);
* numpy-backed when numpy is importable, ``array.array``-backed otherwise
  (the simulator core stays dependency-free, matching pyproject);
* compact, *lossless* wire form: pickling a Trace serializes the columns
  through :meth:`to_bytes` (zlib over byte-shuffled, xor-delta'd column
  buffers), which is what makes ``return_timelines=True`` sweeps cheap
  across the process pool (see ``benchmarks/bench_sweep_engine.py``);
* ``to_npz``/``from_npz`` (numpy), JSON-safe ``to_dict``/``from_dict``,
  ``concat``/``filter``/``slice_time`` views;
* derived analytics: :meth:`stage_utilization`, :meth:`bubble_fraction`,
  :meth:`critical_path`, :meth:`resource_occupancy` — the scalar
  ``stage_busy``/``noc_occupancy`` dicts of the legacy ``SimResult`` are
  now views over this data;
* :func:`chrome_trace` renders the Chrome/Perfetto ``traceEvents`` JSON
  (one lane per pipeline stage, separate NoC/DRAM process groups) so
  training and serving timelines are directly comparable in one viewer.

:class:`TraceRecorder` is the write-side half: the scheduler appends
compute events, and NoC links / DRAM channels close busy intervals into
it through :meth:`TraceRecorder.interval_cb`.
"""

from __future__ import annotations

import array
import json
import struct
import sys
import zlib
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

try:
    import numpy as _np
except ImportError:         # pragma: no cover - exercised by CI bench-smoke
    _np = None

__all__ = [
    "KIND_FD", "KIND_BD", "KIND_GU", "KIND_NOC", "KIND_DRAM",
    "KIND_PREFILL", "KIND_DECODE", "KIND_QUEUE", "KIND_FABRIC",
    "KIND_NAMES", "KIND_CODES", "COMPUTE_KINDS", "RESOURCE_KINDS",
    "REQUEST_KINDS", "pack_lane",
    "TraceRow", "Trace", "TraceRecorder", "TraceDiff", "chrome_trace",
    "diff",
]

# event-kind enum codes (paper Fig. 4/5 taxonomy + resource lanes)
KIND_FD, KIND_BD, KIND_GU = 0, 1, 2        # compute lanes (per stage)
KIND_NOC, KIND_DRAM = 3, 4                 # resource busy-interval lanes
# per-request serving lanes (repro.serving.system): the `resource` column
# carries the request id, `micro` the batching episode (bumped on each
# eviction/resume), `stage` stays -1
KIND_PREFILL, KIND_DECODE, KIND_QUEUE = 5, 6, 7
# scale-out fabric link busy intervals (repro.fabric): the `resource`
# column carries the fabric link id
KIND_FABRIC = 8


def pack_lane(kind: int, lane: int) -> int:
    """Pack a ``(kind, lane)`` resource identity into one int.

    The fast tier (:mod:`repro_torch.core.fastpath`) records busy intervals on
    packed lanes so validation can lexsort a flat int column; the packing
    is order-preserving (kind major, lane minor — both non-negative and
    lane < 2**32), so sorting packed ints equals sorting the tuples.
    """
    return (kind << 32) | lane


KIND_NAMES: Tuple[str, ...] = ("FD", "BD", "GU", "NOC", "DRAM",
                               "PREFILL", "DECODE", "QUEUE", "FABRIC")
KIND_CODES: Dict[str, int] = {name: code for code, name in enumerate(KIND_NAMES)}
COMPUTE_KINDS: Tuple[int, ...] = (KIND_FD, KIND_BD, KIND_GU)
RESOURCE_KINDS: Tuple[int, ...] = (KIND_NOC, KIND_DRAM, KIND_FABRIC)
REQUEST_KINDS: Tuple[int, ...] = (KIND_PREFILL, KIND_DECODE, KIND_QUEUE)

_SCHEMA = 2          # v2 adds the per-row `pred` causality column
_MAGIC = b"PTRC"

# array.array typecodes with guaranteed widths (int is 4 bytes on every
# CPython platform we target; guard anyway so to_bytes stays portable)
_I32 = "i" if array.array("i").itemsize == 4 else "l"
assert array.array(_I32).itemsize == 4, "no 4-byte int array typecode"


# ---------------------------------------------------------------------------
# column backends
# ---------------------------------------------------------------------------

def _col(typecode: str, values: Sequence) -> "array.array | _np.ndarray":
    """Build one column; numpy when available, array.array otherwise."""
    if _np is not None:
        dtype = {"b": _np.int8, _I32: _np.int32, "d": _np.float64}[typecode]
        return _np.asarray(values, dtype=dtype)
    if isinstance(values, array.array) and values.typecode == typecode:
        return values
    return array.array(typecode, values)


def _col_bytes(col) -> bytes:
    b = col.tobytes()
    if sys.byteorder != "little":       # pragma: no cover - big-endian host
        a = array.array(_typecode_of(col), b)
        a.byteswap()
        b = a.tobytes()
    return b


def _col_from_bytes(typecode: str, b: bytes):
    a = array.array(typecode)
    a.frombytes(b)
    if sys.byteorder != "little":       # pragma: no cover - big-endian host
        a.byteswap()
    return _col(typecode, a)


def _typecode_of(col) -> str:
    if _np is not None and isinstance(col, _np.ndarray):
        return {"int8": "b", "int32": _I32, "float64": "d"}[col.dtype.name]
    return col.typecode


def _col_eq(a, b) -> bool:
    if len(a) != len(b):
        return False
    if _np is not None and isinstance(a, _np.ndarray) and isinstance(b, _np.ndarray):
        return bool(_np.array_equal(a, b))
    return list(a) == list(b)


# ---------------------------------------------------------------------------
# lossless byte transforms for the compressed wire form
# ---------------------------------------------------------------------------

def _shuffle(b: bytes, width: int) -> bytes:
    """Byte-transpose a ``width``-byte-item buffer (Blosc-style shuffle):
    groups the slowly-varying high-order bytes so zlib sees long runs."""
    return b"".join(b[i::width] for i in range(width))


def _unshuffle(b: bytes, width: int) -> bytes:
    n = len(b) // width
    out = bytearray(len(b))
    for i in range(width):
        out[i::width] = b[i * n:(i + 1) * n]
    return bytes(out)


def _xor_delta(b: bytes) -> bytes:
    """out[i] = x[i] ^ x[i-1] over the u64 bit patterns (lossless; event
    times are near-monotone, so consecutive words share high bits)."""
    if _np is not None:
        x = _np.frombuffer(b, dtype="<u8")
        out = x.copy()
        out[1:] = x[1:] ^ x[:-1]
        return out.tobytes()
    a = array.array("Q")
    a.frombytes(b)
    prev = 0
    for i, cur in enumerate(a):
        a[i] = cur ^ prev
        prev = cur
    return a.tobytes()


def _xor_undelta(b: bytes) -> bytes:
    if _np is not None:
        x = _np.frombuffer(b, dtype="<u8")
        return _np.bitwise_xor.accumulate(x).tobytes()
    a = array.array("Q")
    a.frombytes(b)
    acc = 0
    for i, cur in enumerate(a):
        acc ^= cur
        a[i] = acc
    return a.tobytes()


class TraceRow(NamedTuple):
    """One materialized trace event (row view over the columns)."""

    stage: int
    kind: int
    micro: int
    resource: int
    start: float
    end: float

    @property
    def kind_name(self) -> str:
        return KIND_NAMES[self.kind]

    @property
    def duration(self) -> float:
        return self.end - self.start


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------

class Trace:
    """Struct-of-arrays event timeline.

    Rows appear in record order (the scheduler appends compute events at
    completion time, so the compute lanes replay the legacy tuple list
    exactly). ``total_time`` is the simulation horizon analytics divide
    by; ``num_stages`` fixes the utilization denominator even for stages
    that never ran.
    """

    __slots__ = ("stage", "kind", "micro", "resource", "start", "end",
                 "pred", "total_time", "num_stages")

    def __init__(self, stage: Sequence[int] = (), kind: Sequence[int] = (),
                 micro: Sequence[int] = (), resource: Sequence[int] = (),
                 start: Sequence[float] = (), end: Sequence[float] = (),
                 pred: Optional[Sequence[int]] = None,
                 total_time: float = 0.0, num_stages: int = 0):
        n = len(stage)
        if not (len(kind) == len(micro) == len(resource) == len(start)
                == len(end) == n):
            raise ValueError("trace columns must have equal length")
        if pred is None:
            pred = [-1] * n
        elif len(pred) != n:
            raise ValueError("trace columns must have equal length")
        self.stage = _col(_I32, stage)
        self.kind = _col("b", kind)
        self.micro = _col(_I32, micro)
        self.resource = _col(_I32, resource)
        self.start = _col("d", start)
        self.end = _col("d", end)
        # `pred[i]` is the row index of the event whose completion bound
        # row i's start (-1 = unknown / no predecessor): explicit event
        # causality recorded by the scheduler, making critical_path()
        # exact even when resource contention delays an event past its
        # structural dependencies
        self.pred = _col(_I32, pred)
        self.total_time = float(total_time)
        self.num_stages = int(num_stages)

    # -- basics -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.stage)

    def __repr__(self) -> str:
        return (f"Trace({len(self)} events, {self.num_stages} stages, "
                f"total_time={self.total_time:.6g})")

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Trace):
            return NotImplemented
        return (self.total_time == other.total_time
                and self.num_stages == other.num_stages
                and all(_col_eq(getattr(self, c), getattr(other, c))
                        for c in ("stage", "kind", "micro", "resource",
                                  "start", "end", "pred")))

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def rows(self) -> Iterator[TraceRow]:
        for i in range(len(self)):
            yield TraceRow(int(self.stage[i]), int(self.kind[i]),
                           int(self.micro[i]), int(self.resource[i]),
                           float(self.start[i]), float(self.end[i]))

    def __getitem__(self, i: int) -> TraceRow:
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        i %= max(1, len(self))
        return TraceRow(int(self.stage[i]), int(self.kind[i]),
                        int(self.micro[i]), int(self.resource[i]),
                        float(self.start[i]), float(self.end[i]))

    @property
    def nbytes(self) -> int:
        """In-memory column payload size (bytes)."""
        return sum(len(getattr(self, c)) * _itemsize(getattr(self, c))
                   for c in ("stage", "kind", "micro", "resource", "start",
                             "end", "pred"))

    # -- legacy view ---------------------------------------------------------
    def compute_tuples(self) -> List[Tuple[int, str, int, float, float]]:
        """The legacy ``SimResult.timeline`` tuple list: compute lanes only,
        in record order, kind as its string name."""
        return [(r.stage, KIND_NAMES[r.kind], r.micro, r.start, r.end)
                for r in self.rows() if r.kind in COMPUTE_KINDS]

    # -- views ---------------------------------------------------------------
    def filter(self, stages: Optional[Sequence[int]] = None,
               kinds: Optional[Sequence[int]] = None,
               micro: Optional[Sequence[int]] = None) -> "Trace":
        """Row-subset copy matching every provided criterion."""
        stages = None if stages is None else set(stages)
        kinds = None if kinds is None else set(kinds)
        micro = None if micro is None else set(micro)
        idx = [i for i in range(len(self))
               if (stages is None or int(self.stage[i]) in stages)
               and (kinds is None or int(self.kind[i]) in kinds)
               and (micro is None or int(self.micro[i]) in micro)]
        return self._take(idx)

    def slice_time(self, t0: float, t1: float) -> "Trace":
        """Rows whose [start, end) interval intersects [t0, t1) (intervals
        are kept whole, not clipped)."""
        idx = [i for i in range(len(self))
               if float(self.end[i]) > t0 and float(self.start[i]) < t1]
        return self._take(idx)

    def _take(self, idx: List[int]) -> "Trace":
        # pred indices are row positions: remap through the selection,
        # dropping edges whose predecessor was filtered out
        remap = {old: new for new, old in enumerate(idx)}
        return Trace(stage=[int(self.stage[i]) for i in idx],
                     kind=[int(self.kind[i]) for i in idx],
                     micro=[int(self.micro[i]) for i in idx],
                     resource=[int(self.resource[i]) for i in idx],
                     start=[float(self.start[i]) for i in idx],
                     end=[float(self.end[i]) for i in idx],
                     pred=[remap.get(int(self.pred[i]), -1) for i in idx],
                     total_time=self.total_time, num_stages=self.num_stages)

    @classmethod
    def concat(cls, traces: Sequence["Trace"]) -> "Trace":
        """Row-wise concatenation; total_time is the max horizon and
        num_stages the max stage count of the parts. pred indices are
        offset so each part's causality edges stay internally valid."""
        traces = list(traces)
        if not traces:
            return cls()
        pred: List[int] = []
        base = 0
        for t in traces:
            pred.extend(int(p) + base if int(p) >= 0 else -1 for p in t.pred)
            base += len(t)
        return cls(
            stage=[s for t in traces for s in t.stage],
            kind=[k for t in traces for k in t.kind],
            micro=[m for t in traces for m in t.micro],
            resource=[r for t in traces for r in t.resource],
            start=[x for t in traces for x in t.start],
            end=[x for t in traces for x in t.end],
            pred=pred,
            total_time=max(t.total_time for t in traces),
            num_stages=max(t.num_stages for t in traces))

    def canonical(self) -> "Trace":
        """Deterministically ordered copy: rows sorted by
        ``(end, start, kind, stage, micro, resource)`` with pred edges
        remapped through the permutation. Event-tier and fast-tier runs
        of the same workload record identical row *sets* but may differ
        in append order (completion order vs. analytic replay order) —
        compare their ``canonical()`` forms."""
        idx = sorted(range(len(self)),
                     key=lambda i: (float(self.end[i]), float(self.start[i]),
                                    int(self.kind[i]), int(self.stage[i]),
                                    int(self.micro[i]), int(self.resource[i])))
        return self._take(idx)

    # -- analytics -----------------------------------------------------------
    def stage_busy(self, kinds: Sequence[int] = (KIND_FD, KIND_BD)) -> Dict[int, float]:
        """Per-stage busy seconds over the given compute kinds (default
        FD+BD, the legacy ``SimResult.stage_busy`` definition — GU overlaps
        the async DP collectives and counts as pipeline tail, not busy)."""
        kinds = set(kinds)
        busy = {s: 0.0 for s in range(self.num_stages)}
        for i in range(len(self)):
            if int(self.kind[i]) in kinds:
                s = int(self.stage[i])
                busy[s] = busy.get(s, 0.0) + float(self.end[i]) - float(self.start[i])
        return busy

    def stage_utilization(self, kinds: Sequence[int] = COMPUTE_KINDS) -> Dict[int, float]:
        """Busy fraction per stage (all compute kinds by default)."""
        if self.total_time <= 0:
            return {s: 0.0 for s in range(self.num_stages)}
        return {s: b / self.total_time
                for s, b in self.stage_busy(kinds).items()}

    def bubble_fraction(self, kinds: Sequence[int] = (KIND_FD, KIND_BD)) -> float:
        """1 - mean stage busy fraction (the legacy ``bubble_ratio``)."""
        busy = self.stage_busy(kinds)
        if not busy or self.total_time <= 0:
            return 0.0
        return 1.0 - sum(busy.values()) / len(busy) / self.total_time

    def resource_occupancy(self, kind: int = KIND_NOC) -> Dict[int, float]:
        """Busy fraction per resource id for one resource lane, in sorted
        key order (deterministic across pool workers)."""
        busy: Dict[int, float] = {}
        for i in range(len(self)):
            if int(self.kind[i]) == kind:
                rid = int(self.resource[i])
                busy[rid] = busy.get(rid, 0.0) + float(self.end[i]) - float(self.start[i])
        if self.total_time <= 0:
            return {rid: 0.0 for rid in sorted(busy)}
        return {rid: busy[rid] / self.total_time for rid in sorted(busy)}

    def critical_path(self) -> List[TraceRow]:
        """Binding-dependency chain through the compute lanes, in
        chronological order.

        When the trace carries recorded causality (``pred`` column, any
        entry >= 0) the path is *exact*: it follows the scheduler's
        per-event binding-predecessor edges, which account for resource
        contention (a compute event delayed by a shared tile group points
        at the event that released the resource, not at a structural
        neighbour). Traces without recorded causality (schema-1 files,
        serving timelines) fall back to the structural heuristic: walking
        back from the last-finishing compute event, the predecessor is
        the latest-ending candidate among the event's structural
        dependencies (previous event on the same stage; the upstream FD
        for an FD; the downstream BD — or the local loss FD — for a BD;
        the stage's last BD for a GU)."""
        if self._has_pred():
            comp_idx = [i for i in range(len(self))
                        if int(self.kind[i]) in COMPUTE_KINDS]
            if not comp_idx:
                return []
            cur = max(comp_idx, key=lambda i: (float(self.end[i]), i))
            path: List[TraceRow] = []
            seen = set()
            while 0 <= cur < len(self) and cur not in seen:
                seen.add(cur)
                path.append(self[cur])
                cur = int(self.pred[cur])
            path.reverse()
            return path
        comp = [(i, TraceRow(int(self.stage[i]), int(self.kind[i]),
                             int(self.micro[i]), int(self.resource[i]),
                             float(self.start[i]), float(self.end[i])))
                for i in range(len(self))
                if int(self.kind[i]) in COMPUTE_KINDS]
        if not comp:
            return []
        by_key = {(r.stage, r.kind, r.micro): r for _, r in comp}
        prev_on_stage: Dict[int, Dict[Tuple[int, int, int], Optional[TraceRow]]] = {}
        last: Dict[int, Optional[TraceRow]] = {}
        last_bd: Dict[int, TraceRow] = {}
        for _, r in comp:                       # record order == per-stage order
            prev_on_stage.setdefault(r.stage, {})[(r.stage, r.kind, r.micro)] = \
                last.get(r.stage)
            last[r.stage] = r
            if r.kind == KIND_BD:
                last_bd[r.stage] = r
        max_stage = max(r.stage for _, r in comp)

        cur = max(comp, key=lambda ir: (ir[1].end, ir[0]))[1]
        path = [cur]
        for _ in range(len(comp)):              # bounded walk (no cycles)
            cands: List[Optional[TraceRow]] = [
                prev_on_stage[cur.stage].get((cur.stage, cur.kind, cur.micro))]
            if cur.kind == KIND_FD and cur.stage > 0:
                cands.append(by_key.get((cur.stage - 1, KIND_FD, cur.micro)))
            elif cur.kind == KIND_BD:
                if cur.stage < max_stage:
                    cands.append(by_key.get((cur.stage + 1, KIND_BD, cur.micro)))
                else:                           # loss computed locally after FD
                    cands.append(by_key.get((cur.stage, KIND_FD, cur.micro)))
            elif cur.kind == KIND_GU:
                cands.append(last_bd.get(cur.stage))
            cands = [c for c in cands if c is not None and c is not cur
                     and c.end <= cur.start + 1e-12]
            if not cands:
                break
            cur = max(cands, key=lambda r: r.end)
            path.append(cur)
        path.reverse()
        return path

    def _has_pred(self) -> bool:
        """True when any row carries a recorded causality edge."""
        if _np is not None and isinstance(self.pred, _np.ndarray):
            return bool((self.pred >= 0).any())
        return any(p >= 0 for p in self.pred)

    def summary(self) -> Dict[str, Any]:
        """JSON-safe analytics digest (what reports embed)."""
        path = self.critical_path()
        return {
            "events": len(self),
            "compute_events": sum(1 for i in range(len(self))
                                  if int(self.kind[i]) in COMPUTE_KINDS),
            "total_time": self.total_time,
            "num_stages": self.num_stages,
            "stage_utilization": {str(s): u
                                  for s, u in self.stage_utilization().items()},
            "bubble_fraction": self.bubble_fraction(),
            "critical_path": {
                "length": len(path),
                "busy_time": sum(r.duration for r in path),
                "exact": self._has_pred(),
            },
            "noc_occupancy": {str(k): v
                              for k, v in self.resource_occupancy(KIND_NOC).items()},
            "dram_occupancy": {str(k): v
                               for k, v in self.resource_occupancy(KIND_DRAM).items()},
            "fabric_occupancy": {str(k): v
                                 for k, v in self.resource_occupancy(KIND_FABRIC).items()},
        }

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Compact JSON-safe dict (plain lists, kinds as enum codes)."""
        return {
            "schema": _SCHEMA,
            "total_time": self.total_time,
            "num_stages": self.num_stages,
            "stage": [int(v) for v in self.stage],
            "kind": [int(v) for v in self.kind],
            "micro": [int(v) for v in self.micro],
            "resource": [int(v) for v in self.resource],
            "start": [float(v) for v in self.start],
            "end": [float(v) for v in self.end],
            "pred": [int(v) for v in self.pred],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Trace":
        # schema 1 lacks the pred column; it reads back as all -1
        if d.get("schema", _SCHEMA) not in (1, _SCHEMA):
            raise ValueError(f"unknown trace schema {d.get('schema')!r}")
        return cls(stage=d["stage"], kind=d["kind"], micro=d["micro"],
                   resource=d["resource"], start=d["start"], end=d["end"],
                   pred=d.get("pred"),
                   total_time=d["total_time"], num_stages=d["num_stages"])

    def to_bytes(self) -> bytes:
        """Lossless compressed wire form (also the pickle payload).

        Events are recorded at completion time, so the ``end`` column is
        near-monotone: xor-delta over its u64 bit patterns leaves mostly
        shared high bits. ``start`` is stored as the duration
        ``end - start`` — event-driven timelines repeat a handful of
        distinct durations thousands of times — with an explicit fixup
        list for the (rare) rows where ``end - dur`` does not reproduce
        ``start`` bit-exactly. Float payloads are byte-shuffled, then the
        whole body is zlib-compressed."""
        # pred is near-monotone (mostly "the previous row on this stage"),
        # so it ships as the small, highly repetitive offset `i - pred[i]`;
        # the no-predecessor rows (-1) ship as 0, which is unambiguous
        # (a real pred is always an earlier row, so i - pred >= 1)
        start = [float(v) for v in self.start] if _np is None else None
        if _np is None:
            pred_b = _col_bytes(_col(_I32, [0 if p < 0 else i - int(p)
                                            for i, p
                                            in enumerate(self.pred)]))
            end = [float(v) for v in self.end]
            dur = [e - s for s, e in zip(start, end)]
            fix_idx = [i for i in range(len(self))
                       if end[i] - dur[i] != start[i]]
            dur_b = _col_bytes(_col("d", dur))
            fix_idx_b = _col_bytes(_col(_I32, fix_idx))
            fix_val_b = _col_bytes(_col("d", [start[i] for i in fix_idx]))
        else:
            rel = (_np.arange(len(self), dtype=_np.int64)
                   - self.pred).astype(_np.int32)
            rel[self.pred < 0] = 0
            pred_b = _col_bytes(rel)
            dur = self.end - self.start
            bad = (self.end - dur) != self.start
            idx = _np.nonzero(bad)[0].astype(_np.int32)
            dur_b = _col_bytes(dur)
            fix_idx_b = _col_bytes(idx)
            fix_val_b = _col_bytes(self.start[bad])
            fix_idx = idx
        body = (_col_bytes(self.stage) + _col_bytes(self.kind)
                + _col_bytes(self.micro) + _col_bytes(self.resource)
                + pred_b
                + _shuffle(_xor_delta(_col_bytes(self.end)), 8)
                + _shuffle(dur_b, 8) + fix_idx_b + fix_val_b)
        header = json.dumps({"v": _SCHEMA, "n": len(self),
                             "nfix": len(fix_idx),
                             "total_time": self.total_time,
                             "num_stages": self.num_stages}).encode()
        return (_MAGIC + struct.pack("<I", len(header)) + header
                + zlib.compress(body, 6))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Trace":
        if blob[:4] != _MAGIC:
            raise ValueError("not a Trace byte stream")
        (hlen,) = struct.unpack("<I", blob[4:8])
        meta = json.loads(blob[8:8 + hlen].decode())
        if meta["v"] not in (1, _SCHEMA):
            raise ValueError(f"unknown trace schema {meta['v']!r}")
        has_pred = meta["v"] >= 2       # schema-1 blobs lack the pred column
        n, nfix = meta["n"], meta["nfix"]
        body = zlib.decompress(blob[8 + hlen:])
        sizes = [4 * n, n, 4 * n, 4 * n]
        if has_pred:
            sizes.append(4 * n)
        sizes += [8 * n, 8 * n, 4 * nfix, 8 * nfix]
        if len(body) != sum(sizes):
            raise ValueError("corrupt trace payload")
        parts, off = [], 0
        for sz in sizes:
            parts.append(body[off:off + sz])
            off += sz
        pred_b = parts.pop(4) if has_pred else None
        end_b = _xor_undelta(_unshuffle(parts[4], 8))
        end = _col_from_bytes("d", end_b)
        dur = _col_from_bytes("d", _unshuffle(parts[5], 8))
        fix_idx = _col_from_bytes(_I32, parts[6])
        fix_val = _col_from_bytes("d", parts[7])
        if _np is not None:
            start = end - dur
            start[_np.asarray(fix_idx, dtype=_np.int64)] = fix_val
        else:
            start = array.array("d", (e - d for e, d in zip(end, dur)))
            for i, v in zip(fix_idx, fix_val):
                start[i] = v
        out = cls.__new__(cls)
        out.stage = _col_from_bytes(_I32, parts[0])
        out.kind = _col_from_bytes("b", parts[1])
        out.micro = _col_from_bytes(_I32, parts[2])
        out.resource = _col_from_bytes(_I32, parts[3])
        if pred_b is None:
            out.pred = _col(_I32, [-1] * n)
        else:
            rel = _col_from_bytes(_I32, pred_b)
            if _np is not None:
                pred = (_np.arange(n, dtype=_np.int64)
                        - rel).astype(_np.int32)
                pred[_np.asarray(rel) == 0] = -1
                out.pred = pred
            else:
                out.pred = _col(_I32, [-1 if r == 0 else i - int(r)
                                       for i, r in enumerate(rel)])
        out.start = _col("d", start)
        out.end = end
        out.total_time = float(meta["total_time"])
        out.num_stages = int(meta["num_stages"])
        return out

    def __reduce__(self):
        # columnar + compressed on the wire: this is what cuts sweep IPC
        return (Trace.from_bytes, (self.to_bytes(),))

    def to_npz(self, path) -> None:
        """Write the columns as a compressed ``.npz`` archive (numpy only)."""
        if _np is None:
            raise RuntimeError("to_npz needs numpy; use to_bytes/to_dict "
                               "in numpy-free environments")
        _np.savez_compressed(
            path,
            stage=_np.asarray(self.stage, dtype=_np.int32),
            kind=_np.asarray(self.kind, dtype=_np.int8),
            micro=_np.asarray(self.micro, dtype=_np.int32),
            resource=_np.asarray(self.resource, dtype=_np.int32),
            start=_np.asarray(self.start, dtype=_np.float64),
            end=_np.asarray(self.end, dtype=_np.float64),
            pred=_np.asarray(self.pred, dtype=_np.int32),
            meta=_np.array([self.total_time, float(self.num_stages),
                            float(_SCHEMA)]))

    @classmethod
    def from_npz(cls, path) -> "Trace":
        if _np is None:
            raise RuntimeError("from_npz needs numpy")
        with _np.load(path) as z:
            meta = z["meta"]
            if int(meta[2]) not in (1, _SCHEMA):
                raise ValueError(f"unknown trace schema {int(meta[2])}")
            return cls(stage=z["stage"], kind=z["kind"], micro=z["micro"],
                       resource=z["resource"], start=z["start"], end=z["end"],
                       pred=z["pred"] if "pred" in z.files else None,
                       total_time=float(meta[0]), num_stages=int(meta[1]))


def _itemsize(col) -> int:
    return col.itemsize     # same attribute on ndarray and array.array


# ---------------------------------------------------------------------------
# TraceRecorder (write side)
# ---------------------------------------------------------------------------

class TraceRecorder:
    """Append-only builder the simulator records into; ``freeze`` produces
    the immutable columnar :class:`Trace`."""

    def __init__(self):
        self._stage: List[int] = []
        self._kind: List[int] = []
        self._micro: List[int] = []
        self._resource: List[int] = []
        self._start: List[float] = []
        self._end: List[float] = []
        self._pred: List[int] = []

    def __len__(self) -> int:
        return len(self._stage)

    def compute(self, stage: int, kind: int, micro: int,
                start: float, end: float, pred: int = -1) -> int:
        """One FD/BD/GU event on a pipeline stage. ``pred`` is the row
        index of the event whose completion bound this event's start
        (-1 = none known). Returns this row's index so callers can wire
        later events' causality to it."""
        self._stage.append(stage)
        self._kind.append(kind)
        self._micro.append(micro)
        self._resource.append(-1)
        self._start.append(start)
        self._end.append(end)
        self._pred.append(pred)
        return len(self._stage) - 1

    def resource(self, kind: int, resource_id: int,
                 start: float, end: float) -> None:
        """One busy interval on a NoC link / DRAM channel."""
        self._stage.append(-1)
        self._kind.append(kind)
        self._micro.append(-1)
        self._resource.append(resource_id)
        self._start.append(start)
        self._end.append(end)
        self._pred.append(-1)

    def request(self, kind: int, request_id: int, episode: int,
                start: float, end: float) -> None:
        """One per-request serving span (PREFILL/DECODE/QUEUE): the
        ``resource`` column carries the request id and ``micro`` the
        batching episode (bumped each time a preempted request resumes)."""
        self._stage.append(-1)
        self._kind.append(kind)
        self._micro.append(episode)
        self._resource.append(request_id)
        self._start.append(start)
        self._end.append(end)
        self._pred.append(-1)

    def interval_cb(self, kind: int, resource_id: int) -> Callable[[float, float], None]:
        """Busy-interval callback for one resource (what
        :class:`~repro_torch.core.events.Resource` calls on busy->idle)."""
        def cb(start: float, end: float) -> None:
            self.resource(kind, resource_id, start, end)
        return cb

    def freeze(self, total_time: float, num_stages: int) -> Trace:
        return Trace(stage=self._stage, kind=self._kind, micro=self._micro,
                     resource=self._resource, start=self._start,
                     end=self._end, pred=self._pred, total_time=total_time,
                     num_stages=num_stages)


# ---------------------------------------------------------------------------
# Chrome / Perfetto export
# ---------------------------------------------------------------------------

_PID_STAGES, _PID_NOC, _PID_DRAM, _PID_REQUESTS, _PID_FABRIC = 0, 1, 2, 3, 4
_PID_COUNTERS = 5


def chrome_trace(trace: Trace, label: str = "palm",
                 counters: Optional[Dict[str, List[List[float]]]] = None,
                 ) -> Dict[str, Any]:
    """Render a Trace as the Chrome/Perfetto ``traceEvents`` JSON dict
    (load via chrome://tracing or https://ui.perfetto.dev).

    Pipeline stages are threads of process 0 (one row per stage); NoC link
    and DRAM channel busy intervals are threads of processes 1 and 2;
    serving per-request lanes (PREFILL/DECODE/QUEUE spans, one thread per
    request id) are threads of process 3; scale-out fabric link busy
    intervals are threads of process 4. Timestamps are microseconds (the
    format's unit); durations are complete events (``ph: "X"``).

    ``counters`` maps series names to ``[t_seconds, value]`` samples
    (see :mod:`repro.obs.tracks`); each series becomes a Perfetto counter
    track (``ph: "C"``) on process 5."""
    events: List[Dict[str, Any]] = []
    for pid, name in ((_PID_STAGES, f"{label}: pipeline stages"),
                      (_PID_NOC, f"{label}: NoC links"),
                      (_PID_DRAM, f"{label}: DRAM channels"),
                      (_PID_REQUESTS, f"{label}: requests"),
                      (_PID_FABRIC, f"{label}: fabric links")):
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": name}})
    if counters:
        events.append({"ph": "M", "pid": _PID_COUNTERS,
                       "name": "process_name",
                       "args": {"name": f"{label}: counters"}})
        for series_name in sorted(counters):
            for t, v in counters[series_name]:
                events.append({"ph": "C", "pid": _PID_COUNTERS, "tid": 0,
                               "name": series_name, "ts": t * 1e6,
                               "args": {"value": v}})
    seen_tids = set()
    for r in trace.rows():
        if r.kind in COMPUTE_KINDS:
            pid, tid = _PID_STAGES, r.stage
            name = f"{KIND_NAMES[r.kind]} mb{r.micro}"
            args: Dict[str, Any] = {"micro": r.micro}
            tname = f"stage {r.stage}"
        elif r.kind in REQUEST_KINDS:
            pid, tid = _PID_REQUESTS, r.resource
            name = f"{KIND_NAMES[r.kind]} ep{r.micro}"
            args = {"episode": r.micro}
            tname = f"req {r.resource}"
        elif r.kind == KIND_FABRIC:
            pid, tid = _PID_FABRIC, r.resource
            name = "busy"
            args = {}
            tname = f"flink {r.resource}"
        else:
            pid = _PID_NOC if r.kind == KIND_NOC else _PID_DRAM
            tid = r.resource
            name = "busy"
            args = {}
            tname = (f"link {r.resource}" if r.kind == KIND_NOC
                     else f"channel {r.resource}")
        if (pid, tid) not in seen_tids:
            seen_tids.add((pid, tid))
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": tname}})
        events.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "cat": KIND_NAMES[r.kind], "ts": r.start * 1e6,
                       "dur": (r.end - r.start) * 1e6, "args": args})
    return {"displayTimeUnit": "ms", "traceEvents": events}


# ---------------------------------------------------------------------------
# Trace diff (hardware / plan A/B studies)
# ---------------------------------------------------------------------------

def _paired(a: Dict[int, float], b: Dict[int, float]) -> Dict[int, Tuple[float, float]]:
    """Union the key sets; missing entries read as 0.0."""
    return {k: (a.get(k, 0.0), b.get(k, 0.0))
            for k in sorted(set(a) | set(b))}


class TraceDiff:
    """Structural comparison of two timelines (A vs B).

    Every per-key dict maps to an ``(a, b)`` value pair over the union of
    the two traces' keys (a stage / resource present in only one trace
    reads as 0.0 in the other), so a hardware variant that adds NoC links
    or drops a pipeline stage still diffs cleanly. Deltas are ``b - a``.
    """

    def __init__(self, a: Trace, b: Trace):
        self.total_time = (a.total_time, b.total_time)
        self.events = (len(a), len(b))
        self.bubble_fraction = (a.bubble_fraction(), b.bubble_fraction())
        self.stage_busy = _paired(a.stage_busy(), b.stage_busy())
        self.stage_utilization = _paired(a.stage_utilization(),
                                         b.stage_utilization())
        self.noc_occupancy = _paired(a.resource_occupancy(KIND_NOC),
                                     b.resource_occupancy(KIND_NOC))
        self.dram_occupancy = _paired(a.resource_occupancy(KIND_DRAM),
                                      b.resource_occupancy(KIND_DRAM))
        self.fabric_occupancy = _paired(a.resource_occupancy(KIND_FABRIC),
                                        b.resource_occupancy(KIND_FABRIC))

    # -- deltas (b - a) ------------------------------------------------------
    @property
    def total_time_delta(self) -> float:
        return self.total_time[1] - self.total_time[0]

    @property
    def bubble_delta(self) -> float:
        return self.bubble_fraction[1] - self.bubble_fraction[0]

    def stage_busy_delta(self) -> Dict[int, float]:
        return {s: b - a for s, (a, b) in self.stage_busy.items()}

    def stage_utilization_delta(self) -> Dict[int, float]:
        return {s: b - a for s, (a, b) in self.stage_utilization.items()}

    def noc_occupancy_delta(self) -> Dict[int, float]:
        return {r: b - a for r, (a, b) in self.noc_occupancy.items()}

    def dram_occupancy_delta(self) -> Dict[int, float]:
        return {r: b - a for r, (a, b) in self.dram_occupancy.items()}

    def fabric_occupancy_delta(self) -> Dict[int, float]:
        return {r: b - a for r, (a, b) in self.fabric_occupancy.items()}

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        def pairs(d: Dict[int, Tuple[float, float]]) -> Dict[str, Any]:
            return {str(k): {"a": a, "b": b, "delta": b - a}
                    for k, (a, b) in d.items()}
        return {
            "total_time": {"a": self.total_time[0], "b": self.total_time[1],
                           "delta": self.total_time_delta},
            "events": {"a": self.events[0], "b": self.events[1],
                       "delta": self.events[1] - self.events[0]},
            "bubble_fraction": {"a": self.bubble_fraction[0],
                                "b": self.bubble_fraction[1],
                                "delta": self.bubble_delta},
            "stage_busy": pairs(self.stage_busy),
            "stage_utilization": pairs(self.stage_utilization),
            "noc_occupancy": pairs(self.noc_occupancy),
            "dram_occupancy": pairs(self.dram_occupancy),
            "fabric_occupancy": pairs(self.fabric_occupancy),
        }

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    def table(self, top: int = 10) -> str:
        """Human-readable digest: scalar deltas plus the per-stage table
        and the ``top`` NoC/DRAM lanes by absolute occupancy delta."""
        ta, tb = self.total_time
        rel = f" ({(tb - ta) / ta:+.1%})" if ta > 0 else ""
        lines = [
            f"total_time: {ta:.6g}s -> {tb:.6g}s"
            f" (delta {self.total_time_delta:+.6g}s{rel})",
            f"bubble:     {self.bubble_fraction[0]:.1%} -> "
            f"{self.bubble_fraction[1]:.1%} (delta {self.bubble_delta:+.1%})",
            f"events:     {self.events[0]} -> {self.events[1]}",
            "",
            f"{'stage':>5s} {'busy_a (s)':>12s} {'busy_b (s)':>12s} "
            f"{'delta (s)':>12s} {'util delta':>10s}",
        ]
        util_delta = self.stage_utilization_delta()
        for s, (a, b) in self.stage_busy.items():
            lines.append(f"{s:5d} {a:12.6g} {b:12.6g} {b - a:+12.6g} "
                         f"{util_delta.get(s, 0.0):+10.1%}")
        for label, paired in (("NoC link", self.noc_occupancy),
                              ("DRAM channel", self.dram_occupancy),
                              ("Fabric link", self.fabric_occupancy)):
            if not paired:
                continue
            ranked = sorted(paired.items(),
                            key=lambda kv: -abs(kv[1][1] - kv[1][0]))[:top]
            lines.append("")
            lines.append(f"{label:>12s} {'occ_a':>8s} {'occ_b':>8s} "
                         f"{'delta':>8s}   (top {len(ranked)} by |delta|)")
            for rid, (a, b) in ranked:
                lines.append(f"{rid:12d} {a:8.1%} {b:8.1%} {b - a:+8.1%}")
        return "\n".join(lines)


def diff(a: Trace, b: Trace) -> TraceDiff:
    """Per-stage / per-lane busy & bubble deltas between two timelines
    (e.g. the same workload on two hardware variants)."""
    return TraceDiff(a, b)
