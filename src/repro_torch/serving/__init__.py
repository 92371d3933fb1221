"""Serving: batched prefill/decode runtime + traffic-driven system simulator.

Two halves:

* runtime (``serve``) — the port's prefill/decode step factories on one
  device or a mesh (:func:`make_serve_step`, :func:`greedy_generate`);
* simulation (``workload`` / ``batcher`` / ``system`` / ``planner``) —
  the request-level serving simulator (continuous batching, KV-cache
  pressure, SLO metrics) built on the PALM event core, host code.

The runtime half is imported on first use, so ``python -m repro_torch
serve-sim`` / ``serve-plan`` do not load the model code.
"""

from typing import TYPE_CHECKING

from .batcher import ActiveRequest, ContinuousBatcher, KVCacheModel
from .planner import plan_serving
from .system import (
    ServingReport,
    ServingSimulator,
    ServingSpec,
    StepCostModel,
    simulate_serving,
)
from .workload import Request, WorkloadSpec, workload_from_json, workload_to_json

if TYPE_CHECKING:                       # runtime half (lazy at runtime)
    from .serve import greedy_generate, make_prefill_step, make_serve_step

__all__ = [
    "ActiveRequest",
    "ContinuousBatcher",
    "KVCacheModel",
    "Request",
    "ServingReport",
    "ServingSimulator",
    "ServingSpec",
    "StepCostModel",
    "WorkloadSpec",
    "greedy_generate",
    "make_prefill_step",
    "make_serve_step",
    "plan_serving",
    "simulate_serving",
    "workload_from_json",
    "workload_to_json",
]

_RUNTIME_EXPORTS = ("make_prefill_step", "make_serve_step", "greedy_generate")


def __getattr__(name: str):
    if name in _RUNTIME_EXPORTS:
        from . import serve
        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
