"""Typed metrics registry — the host-domain half of ``repro_torch.obs``.

A :class:`MetricsRegistry` holds named **counters** (monotonic adds),
**gauges** (last-write / high-water values), **histograms** (count, sum,
min, max — bucket-free so merging across process-pool shards is exact)
and lightweight wall-clock **spans** (a context manager that folds
elapsed microseconds into a ``<name>.us`` counter plus a
``<name>.calls`` counter).

Two strictly separated domains, enforced by name prefix:

* ``sim.*``  — deterministic values derived only from simulated
  time/bytes. These must be bit-identical across engine tiers
  (``fast``/``event``) and executors (serial/pool); see
  :mod:`repro_torch.obs.simmetrics`, which derives them post-hoc from
  :class:`~repro_torch.core.scheduler.SimResult` data rather than from
  instrumentation inside the hot loops.
* ``host.*`` — wall-clock and process-level observations (tier
  selection counts, fast-path rejection reasons, pool shard timing,
  graph-memo hit rates). Never part of result equality.

Zero overhead when disabled: :data:`NULL_REGISTRY` is a falsy no-op
singleton whose metric handles and spans do nothing and allocate
nothing, so instrumented call sites guard with ``if registry:`` (or
just call through — the no-ops are attribute lookups plus a pass).

The process's current registry: :func:`recording` installs one for the
length of a ``with`` block (the previous one comes back on exit) and
:func:`span` opens a span on whichever is installed, so code deep in a
step can be timed without a registry threaded through its calls. With
none installed (:data:`NULL_REGISTRY`) a span site reads one global and
gets the shared no-op span. While ``torch.profiler`` records, a live
span also opens ``torch.profiler.record_function(name)``, which puts it
on the profiler's host clock beside the device kernels it launched.

JSON round-trip: ``to_dict()`` emits a plain
``{"counters": {...}, "gauges": {...}, "histograms": {...}}`` document;
``MetricsRegistry.from_dict`` restores it; ``merge_dict`` folds another
document in (counters add, gauges last-write, histograms combine) —
the operation the sweep engine applies to worker-side registries
shipped back from process-pool shards.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager
from time import perf_counter
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_REGISTRY", "make_registry", "summarize_metrics",
    "current", "recording", "span",
]

_DOMAINS = ("sim.", "host.")


class Counter:
    """Monotonic add-only value (int or float)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write value with a high-water helper."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = v

    def high(self, v: float) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Bucket-free distribution digest: count / sum / min / max.

    Exact under merging (no bucket-boundary loss), which is what the
    cross-shard registry merge needs; percentile-grade digests belong
    to the callers that keep raw series (e.g. ``ServingReport``)."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self, count: int = 0, total: float = 0.0,
                 vmin: float = 0.0, vmax: float = 0.0):
        self.count = count
        self.sum = total
        self.min = vmin
        self.max = vmax

    def observe(self, x: float) -> None:
        if self.count == 0:
            self.min = self.max = x
        else:
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
        self.count += 1
        self.sum += x

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}


def _profiler_range(name: str):
    """An open ``torch.profiler.record_function(name)`` while the
    profiler records, else None. torch is read from ``sys.modules``: a
    process that never imported it has no profiler running."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """Wall-clock span: ``with registry.span("host.sweep.evaluate"):``
    adds elapsed microseconds to ``<name>.us`` and bumps
    ``<name>.calls`` (and marks the profiler's timeline while it
    records)."""

    __slots__ = ("_name", "_us", "_calls", "_t0", "_range")

    def __init__(self, name: str, us: Counter, calls: Counter):
        self._name = name
        self._us = us
        self._calls = calls
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "_Span":
        self._range = _profiler_range(self._name)
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._us.inc((perf_counter() - self._t0) * 1e6)
        self._calls.inc()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


class MetricsRegistry:
    """Ordered name -> typed-metric store with strict domain prefixes."""

    enabled = True

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def __bool__(self) -> bool:
        return True

    @staticmethod
    def _check(name: str) -> None:
        if not name.startswith(_DOMAINS):
            raise ValueError(
                f"metric name {name!r} must carry a domain prefix "
                f"('sim.' or 'host.')")

    # -- typed accessors (create on first use) ------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._check(name)
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._check(name)
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            self._check(name)
            h = self._histograms[name] = Histogram()
        return h

    def span(self, name: str) -> _Span:
        return _Span(name, self.counter(name + ".us"),
                     self.counter(name + ".calls"))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain JSON-serializable document (sorted names, so documents
        compare equal independent of instrumentation order)."""
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].to_dict()
                           for k in sorted(self._histograms)},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MetricsRegistry":
        reg = cls()
        reg.merge_dict(d)
        return reg

    def merge_dict(self, d: Optional[Dict[str, Any]]) -> None:
        """Fold another registry document in: counters add, gauges take
        the incoming value (last write wins), histograms combine
        exactly."""
        if not d:
            return
        for k, v in d.get("counters", {}).items():
            self.counter(k).inc(v)
        for k, v in d.get("gauges", {}).items():
            self.gauge(k).set(v)
        for k, hv in d.get("histograms", {}).items():
            h = self.histogram(k)
            if hv.get("count"):
                if h.count == 0:
                    h.min, h.max = hv["min"], hv["max"]
                else:
                    h.min = min(h.min, hv["min"])
                    h.max = max(h.max, hv["max"])
                h.count += hv["count"]
                h.sum += hv["sum"]

    def merge(self, other: "MetricsRegistry") -> None:
        self.merge_dict(other.to_dict())

    # -- reporting ----------------------------------------------------------
    def rows(self) -> List[Tuple[str, Any]]:
        """Flat (name, value) rows, sorted; histograms render their
        digest dict."""
        out: List[Tuple[str, Any]] = []
        out += [(k, c.value) for k, c in self._counters.items()]
        out += [(k, g.value) for k, g in self._gauges.items()]
        out += [(k, h.to_dict()) for k, h in self._histograms.items()]
        out.sort(key=lambda kv: kv[0])
        return out

    def summary(self) -> str:
        """Text report grouped by domain."""
        lines: List[str] = []
        rows = self.rows()
        for domain in ("sim", "host"):
            block = [(k, v) for k, v in rows
                     if k.startswith(domain + ".")]
            if not block:
                continue
            lines.append(f"[{domain}]")
            for k, v in block:
                lines.append(f"  {k:<42s} {_fmt_value(k, v)}")
        return "\n".join(lines) if lines else "(no metrics recorded)"


class _NullMetric:
    """Shared do-nothing Counter/Gauge/Histogram stand-in."""

    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0
    min = 0.0
    max = 0.0
    mean = 0.0

    def inc(self, n: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def high(self, v: float) -> None:
        pass

    def observe(self, x: float) -> None:
        pass

    def to_dict(self) -> Dict[str, float]:
        return {}


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_METRIC = _NullMetric()
_NULL_SPAN = _NullSpan()


class NullRegistry:
    """Falsy no-op registry: every accessor returns a shared do-nothing
    handle, ``to_dict`` is empty, merging is a pass. The disabled path
    therefore costs one attribute lookup + call per site and adds zero
    rows to any report."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def span(self, name: str) -> _NullSpan:
        return _NULL_SPAN

    def to_dict(self) -> Dict[str, Any]:
        return {}

    def merge_dict(self, d: Optional[Dict[str, Any]]) -> None:
        pass

    def merge(self, other) -> None:
        pass

    def rows(self) -> List[Tuple[str, Any]]:
        return []

    def summary(self) -> str:
        return "(metrics disabled)"


NULL_REGISTRY = NullRegistry()


def make_registry(enabled: bool):
    """The one constructor call sites use: a live registry when enabled,
    the shared no-op singleton otherwise."""
    return MetricsRegistry() if enabled else NULL_REGISTRY


_current = NULL_REGISTRY


def current():
    """The registry :func:`span` records into: the innermost
    :func:`recording`'s, else :data:`NULL_REGISTRY`."""
    return _current


@contextmanager
def recording(registry) -> Iterator:
    """Install ``registry`` as the process's current registry for the
    ``with`` block; the previous one comes back on exit, also on an
    exception."""
    global _current
    previous, _current = _current, registry
    try:
        yield registry
    finally:
        _current = previous


def span(name: str):
    """A span on the current registry: the shared no-op span when none is
    installed, so an instrumented hot path costs a global read and a
    call."""
    return _current.span(name)


# ---------------------------------------------------------------------------
# text rendering for report-attached metrics documents
# ---------------------------------------------------------------------------

def _fmt_value(name: str, v: Any) -> str:
    if isinstance(v, dict):
        if "count" in v:
            return (f"n={v.get('count', 0)} sum={_fmt_num(v.get('sum', 0))} "
                    f"min={_fmt_num(v.get('min', 0))} "
                    f"max={_fmt_num(v.get('max', 0))}")
        return " ".join(f"{k}={_fmt_num(x)}" for k, x in v.items())
    return _fmt_num(v, us=name.endswith(".us"))


def _fmt_num(v: Any, us: bool = False) -> str:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return str(v)
    if us:
        return f"{v / 1e3:.2f}ms" if v >= 1e3 else f"{v:.1f}us"
    if isinstance(v, int) or v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def _walk(prefix: str, node: Any, out: List[str]) -> None:
    if isinstance(node, dict):
        for k in node:
            _walk(f"{prefix}.{k}" if prefix else str(k), node[k], out)
    elif isinstance(node, (list, tuple)):
        vals = ", ".join(_fmt_num(x) for x in node)
        out.append(f"  {prefix:<42s} [{vals}]")
    else:
        out.append(f"  {prefix:<42s} {_fmt_value(prefix, node)}")


def summarize_metrics(metrics: Optional[Dict[str, Any]],
                      title: str = "metrics") -> str:
    """Render a report-attached metrics document — the ``{"sim": ...,
    "host": ...}`` shape carried by ``SimResult.metrics`` (and the
    reference's ``RunReport`` / ``SweepReport`` / ``ServingReport``) — as
    the text report the reference's ``python -m repro metrics``
    subcommand prints."""
    if not metrics:
        return f"{title}: (none recorded — run with metrics enabled)"
    lines = [f"== {title} =="]
    for domain in ("sim", "host"):
        node = metrics.get(domain)
        if node is None:
            continue
        lines.append(f"[{domain}]")
        block: List[str] = []
        if isinstance(node, dict) and ("counters" in node
                                       or "gauges" in node
                                       or "histograms" in node):
            reg = MetricsRegistry.from_dict(node)
            block = reg.summary().splitlines()
            block = [ln for ln in block if not ln.startswith("[")]
        else:
            _walk("", node, block)
        lines += block
    extra: Iterable[str] = (k for k in metrics
                            if k not in ("sim", "host"))
    for k in extra:
        block = []
        _walk(k, metrics[k], block)
        lines += block
    return "\n".join(lines)
