"""Fault tolerance: straggler detection, checkpoint/restart and elastic
mesh resharding, the counterpart of ``repro.train.fault_tolerance``
(whose module imports jax, so the port keeps its own copy).

* :class:`StragglerMonitor` — per-step wall-time ring buffer; flags steps
  exceeding ``threshold x`` the running median and recommends an action.
* :func:`run_with_restart` — drives a step function under a fault
  injector; on failure restores the latest checkpoint and replays
  (exactly-once semantics come from the counter-based data pipeline).
* :func:`elastic_reshard` — moves a sharded state onto a different mesh
  (e.g. after losing part of it): every leaf's placements derive from its
  name (``parallel.sharding``), so resharding is a gather to the host and
  a distribution at the new mesh's placements.
"""

from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..parallel.comm import is_dtensor
from ..parallel.sharding import MeshPlacements, ShardingPlanner

__all__ = ["StragglerMonitor", "run_with_restart", "elastic_reshard"]


@dataclass
class StragglerMonitor:
    window: int = 50
    threshold: float = 2.0
    grace_steps: int = 5                 # ignore warmup/compile steps
    _times: collections.deque = field(default_factory=lambda: collections.deque(maxlen=256))
    events: List[Dict] = field(default_factory=list)

    def record(self, step: int, seconds: float) -> Optional[Dict]:
        self._times.append(seconds)
        if len(self._times) < self.grace_steps + 3:
            return None
        window = list(self._times)[-self.window:-1]
        med = statistics.median(window)
        if med > 0 and seconds > self.threshold * med:
            event = {"step": step, "seconds": seconds, "median": med,
                     "ratio": seconds / med,
                     "action": "re-dispatch shard / evict host if recurrent"}
            self.events.append(event)
            return event
        return None

    @property
    def median_step_time(self) -> float:
        return statistics.median(self._times) if self._times else 0.0


def run_with_restart(
    step_fn: Callable[[int, Any], Any],
    init_state: Any,
    num_steps: int,
    save_fn: Callable[[int, Any], None],
    restore_fn: Callable[[], Tuple[Optional[int], Any]],
    fault_injector: Optional[Callable[[int], bool]] = None,
    max_restarts: int = 10,
) -> Tuple[Any, Dict]:
    """Checkpoint/restart driver. ``step_fn(step, state) -> state``;
    ``restore_fn() -> (last_step, state)``. A 'fault' raises inside the
    loop; recovery restores and replays from the checkpoint."""
    state = init_state
    step = 0
    restarts = 0
    while step < num_steps:
        try:
            if fault_injector is not None and fault_injector(step):
                raise RuntimeError(f"injected node failure at step {step}")
            state = step_fn(step, state)
            step += 1
            save_fn(step, state)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            last, restored = restore_fn()
            if last is None:
                state, step = init_state, 0
            else:
                state, step = restored, last
    return state, {"restarts": restarts, "final_step": step}


def elastic_reshard(state: Dict[str, Any], arch, new_mesh) -> Dict[str, Any]:
    """Re-place a {"params": {name: tensor}, "opt_state": {"m", "v", "step"}}
    state onto ``new_mesh`` (grown or shrunk): each leaf gathered whole
    (``full_tensor``, a collective over its old mesh, which every rank of
    the process group calls) and distributed at the new mesh's placements
    (``ShardingPlanner``). Plain tensors are taken as whole. The step, a
    scalar, and any other entry come back as they are. Ranks outside
    ``new_mesh`` get empty shards."""
    whole = lambda t: t.full_tensor() if is_dtensor(t) else t
    planner = ShardingPlanner(new_mesh, arch)
    out: Dict[str, Any] = dict(state)
    names = state["params"] if "params" in state else state["opt_state"]["m"]
    placed = planner.params({n: tuple(t.shape) for n, t in names.items()})

    def move(tree):
        return {n: MeshPlacements(new_mesh, placed[n]).distribute(whole(t.detach()))
                for n, t in tree.items()}

    if "params" in state:
        out["params"] = move(state["params"])
    if "opt_state" in state:
        opt = state["opt_state"]
        out["opt_state"] = {**opt, "m": move(opt["m"]), "v": move(opt["v"])}
    return out
