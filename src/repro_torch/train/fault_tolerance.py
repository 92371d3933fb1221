"""Fault tolerance: straggler detection and checkpoint/restart, copied
from ``repro.train.fault_tolerance`` (whose module imports jax, so the port
keeps its own copy). ``elastic_reshard`` moves a state onto another mesh
and comes with distribution (ROADMAP queue 1).

* :class:`StragglerMonitor` — per-step wall-time ring buffer; flags steps
  exceeding ``threshold x`` the running median and recommends an action.
* :func:`run_with_restart` — drives a step function under a fault
  injector; on failure restores the latest checkpoint and replays
  (exactly-once semantics come from the counter-based data pipeline).
"""

from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["StragglerMonitor", "run_with_restart"]


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
