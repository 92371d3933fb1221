"""``repro_torch.obs`` — unified metrics & instrumentation layer.

Two strictly separated metric domains (enforced by name prefix in the
registry):

* **sim-domain** (``sim.*``): deterministic values derived only from
  simulated time/bytes — bit-identical across engine tiers
  (``fast``/``event``) and executors (serial/pool). Derived post-hoc by
  :mod:`repro_torch.obs.simmetrics`.
* **host-domain** (``host.*``): wall-clock spans and process-level
  counts — tier selection, fast-path rejection reasons, pool shard
  timing, graph-memo hit rates, search rung timing. Recorded live into
  a :class:`MetricsRegistry` and merged across pool shards.

See ``docs/observability.md`` for the full schema and the overhead
gate.

The port's copy of the reference's ``repro.obs``. It is host work: the
documents fold numpy reductions over a few hundred trace rows in a fixed
order, which a device reduction would not keep, so nothing here runs on
the card.
"""

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       NULL_REGISTRY, make_registry, summarize_metrics)
from .simmetrics import (aggregate_run_metrics, run_metrics,
                         serving_sim_metrics, sim_metrics)
from .tracks import activity_counters, metrics_counters, serving_counters

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_REGISTRY",
    "make_registry", "summarize_metrics",
    "sim_metrics", "run_metrics", "aggregate_run_metrics",
    "serving_sim_metrics",
    "activity_counters", "serving_counters", "metrics_counters",
]
