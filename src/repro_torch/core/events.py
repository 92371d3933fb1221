"""Discrete event-driven simulation kernel (PALM §II-D2, §IV).

PALM is built on a discrete event-driven framework — the paper uses SimPy
[49]; SimPy is not available in this environment, so this module provides an
equivalent, deterministic, generator-based process/resource kernel.

Semantics mirror the SimPy subset PALM needs:

* ``Environment``   — event heap + virtual clock.
* ``Event``         — one-shot triggerable value carrier.
* ``Timeout``       — event that fires after a virtual delay.
* ``Process``       — generator coroutine; ``yield`` an event to wait on it.
* ``Resource``      — capacity-limited FIFO resource (NoC links, DRAM ports).
* ``PriorityResource`` — resource whose queue is ordered by priority
  (used by the 1F1B Prior Selector: BD requests pre-empt queued FD ones).
* ``AllOf/AnyOf``   — condition events.

Determinism: the heap is keyed ``(time, priority, seq)`` where ``seq`` is a
monotone counter, so identical-time events always replay in schedule order.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Generator, Iterable, List, Optional

__all__ = [
    "Environment",
    "Event",
    "Timeout",
    "Process",
    "Resource",
    "PriorityResource",
    "AllOf",
    "AnyOf",
    "Interrupt",
]


class Interrupt(Exception):
    """Raised inside a process that has been interrupted."""

    def __init__(self, cause: Any = None):
        super().__init__(cause)
        self.cause = cause


class Event:
    """A one-shot event that processes can wait on."""

    __slots__ = ("env", "callbacks", "_value", "_ok", "_triggered", "_processed", "name")

    def __init__(self, env: "Environment", name: str = ""):
        self.env = env
        self.callbacks: List[Callable[["Event"], None]] = []
        self._value: Any = None
        self._ok = True
        self._triggered = False
        self._processed = False
        self.name = name

    # -- state ------------------------------------------------------------
    @property
    def triggered(self) -> bool:
        return self._triggered

    @property
    def processed(self) -> bool:
        return self._processed

    @property
    def ok(self) -> bool:
        return self._ok

    @property
    def value(self) -> Any:
        return self._value

    # -- triggering -------------------------------------------------------
    def succeed(self, value: Any = None, priority: int = 0) -> "Event":
        if self._triggered:
            raise RuntimeError(f"event {self.name!r} already triggered")
        self._triggered = True
        self._value = value
        self.env._schedule(self, delay=0.0, priority=priority)
        return self

    def fail(self, exc: BaseException, priority: int = 0) -> "Event":
        if self._triggered:
            raise RuntimeError(f"event {self.name!r} already triggered")
        self._triggered = True
        self._ok = False
        self._value = exc
        self.env._schedule(self, delay=0.0, priority=priority)
        return self

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "processed" if self._processed else ("triggered" if self._triggered else "pending")
        return f"<{type(self).__name__} {self.name!r} {state} @{self.env.now:.6g}>"


class Timeout(Event):
    """Event that fires ``delay`` virtual seconds after creation."""

    def __init__(self, env: "Environment", delay: float, value: Any = None, name: str = ""):
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        super().__init__(env, name=name or f"timeout({delay:.3g})")
        self._triggered = True
        self._value = value
        env._schedule(self, delay=delay)


class Process(Event):
    """Runs a generator; the process event triggers when the generator ends.

    The generator may ``yield`` any :class:`Event`; it is resumed with the
    event's value (or the event's exception is thrown into it).
    """

    __slots__ = ("_gen", "_target")

    def __init__(self, env: "Environment", gen: Generator, name: str = ""):
        super().__init__(env, name=name or getattr(gen, "__name__", "process"))
        self._gen = gen
        self._target: Optional[Event] = None
        # bootstrap: resume on the next scheduling round at the current time
        init = Event(env, name=f"{self.name}.init")
        init.callbacks.append(self._resume)
        init._triggered = True
        env._schedule(init, delay=0.0)

    def interrupt(self, cause: Any = None) -> None:
        """Throw :class:`Interrupt` into the process at the current time."""
        if self._triggered:
            return
        evt = Event(self.env, name=f"{self.name}.interrupt")
        evt._ok = False
        evt._value = Interrupt(cause)
        evt.callbacks.append(self._resume)
        evt._triggered = True
        # detach from whatever we were waiting on
        target, self._target = self._target, None
        if target is not None and self._resume in target.callbacks:
            target.callbacks.remove(self._resume)
        self.env._schedule(evt, delay=0.0, priority=-1)

    # -- engine -----------------------------------------------------------
    def _resume(self, event: Event) -> None:
        self._target = None
        try:
            if event.ok:
                nxt = self._gen.send(event.value)
            else:
                nxt = self._gen.throw(event.value)
        except StopIteration as stop:
            self.succeed(getattr(stop, "value", None))
            return
        except BaseException as exc:  # propagate failures to waiters
            if self.callbacks:
                self.fail(exc)
                return
            raise
        if not isinstance(nxt, Event):
            raise TypeError(
                f"process {self.name!r} yielded {nxt!r}; processes must yield Event instances"
            )
        self._target = nxt
        if nxt._processed:
            # already fired: resume immediately at current time
            relay = Event(self.env, name=f"{self.name}.relay")
            relay._ok = nxt._ok
            relay._value = nxt._value
            relay.callbacks.append(self._resume)
            relay._triggered = True
            self.env._schedule(relay, delay=0.0)
        else:
            nxt.callbacks.append(self._resume)


class _Condition(Event):
    """Base for AllOf/AnyOf."""

    __slots__ = ("_events", "_count")

    def __init__(self, env: "Environment", events: Iterable[Event], name: str):
        super().__init__(env, name=name)
        self._events = list(events)
        self._count = 0
        if not self._events:
            self.succeed({})
            return
        for evt in self._events:
            if evt._processed:
                self._on_fire(evt)
            else:
                evt.callbacks.append(self._on_fire)

    def _on_fire(self, event: Event) -> None:
        raise NotImplementedError


class AllOf(_Condition):
    """Triggers when every child event has fired. Value: dict event->value."""

    def __init__(self, env: "Environment", events: Iterable[Event], name: str = "all_of"):
        super().__init__(env, events, name)

    def _on_fire(self, event: Event) -> None:
        if self._triggered:
            return
        if not event.ok:
            self.fail(event.value if isinstance(event.value, BaseException) else RuntimeError(event.value))
            return
        self._count += 1
        if self._count == len(self._events):
            self.succeed({e: e.value for e in self._events})


class AnyOf(_Condition):
    """Triggers when the first child event fires. Value: dict event->value."""

    def __init__(self, env: "Environment", events: Iterable[Event], name: str = "any_of"):
        super().__init__(env, events, name)

    def _on_fire(self, event: Event) -> None:
        if self._triggered:
            return
        if not event.ok:
            self.fail(event.value if isinstance(event.value, BaseException) else RuntimeError(event.value))
            return
        self.succeed({event: event.value})


class Environment:
    """Virtual-time event loop."""

    def __init__(self, initial_time: float = 0.0):
        self.now: float = float(initial_time)
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self.event_count = 0  # total processed events (sim-cost metric)

    # -- scheduling ---------------------------------------------------------
    def _schedule(self, event: Event, delay: float = 0.0, priority: int = 0) -> None:
        heapq.heappush(self._heap, (self.now + delay, priority, next(self._seq), event))

    def event(self, name: str = "") -> Event:
        return Event(self, name=name)

    def timeout(self, delay: float, value: Any = None, name: str = "") -> Timeout:
        return Timeout(self, delay, value=value, name=name)

    def process(self, gen: Generator, name: str = "") -> Process:
        return Process(self, gen, name=name)

    def all_of(self, events: Iterable[Event]) -> AllOf:
        return AllOf(self, events)

    def any_of(self, events: Iterable[Event]) -> AnyOf:
        return AnyOf(self, events)

    # -- execution ------------------------------------------------------------
    def step(self) -> None:
        time, _prio, _seq, event = heapq.heappop(self._heap)
        if time < self.now - 1e-12:
            raise RuntimeError("time went backwards")
        self.now = max(self.now, time)
        event._processed = True
        callbacks, event.callbacks = event.callbacks, []
        self.event_count += 1
        for cb in callbacks:
            cb(event)

    def run(self, until: Optional[float] = None, until_event: Optional[Event] = None) -> Any:
        """Run until the heap drains, ``until`` time passes, or event fires.

        The ``until`` horizon only *peeks* at the heap head — the first
        event past the horizon is never popped, so a resumed
        ``run(until=later)`` (or a final ``run()``) replays it exactly
        once at its own timestamp. The clock never rewinds: a horizon
        earlier than ``now`` is a no-op, and a fired ``until_event`` is
        reported even when the next head already lies past ``until``.
        """
        while self._heap:
            if until_event is not None and until_event._processed:
                return until_event.value
            if until is not None and self._heap[0][0] > until:
                self.now = max(self.now, until)
                return None
            self.step()
        if until_event is not None and until_event._processed:
            return until_event.value
        if until is not None:
            self.now = max(self.now, until)
        return None


class Resource:
    """Capacity-limited resource with a FIFO wait queue.

    ``request()`` returns an Event that fires once a slot is granted; pass the
    same request object to ``release``. PALM models each NoC link and each
    DRAM channel as a ``Resource(capacity=1)`` — "treating the link as an
    exclusive resource during execution" (§IV-C).
    """

    def __init__(self, env: Environment, capacity: int = 1, name: str = "",
                 interval_cb: Optional[Callable[[float, float], None]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.env = env
        self.capacity = capacity
        self.name = name
        self._users: List[Event] = []
        self._queue: List[tuple] = []
        self._qseq = itertools.count()
        # instrumentation: busy-time integral for utilisation reporting;
        # interval_cb additionally receives each closed (start, end) busy
        # interval (the trace recorder's resource lanes)
        self._busy_since: Optional[float] = None
        self.busy_time: float = 0.0
        self.grant_count: int = 0
        self._interval_cb = interval_cb

    # -- API ----------------------------------------------------------------
    def request(self, priority: int = 0) -> Event:
        req = Event(self.env, name=f"{self.name}.req")
        if len(self._users) < self.capacity:
            self._grant(req)
        else:
            heapq.heappush(self._queue, (priority, next(self._qseq), req))
        return req

    def release(self, req: Event) -> None:
        try:
            self._users.remove(req)
        except ValueError:
            raise RuntimeError(f"release of non-user request on {self.name!r}")
        if not self._users and self._busy_since is not None:
            self.busy_time += self.env.now - self._busy_since
            if self._interval_cb is not None and self.env.now > self._busy_since:
                self._interval_cb(self._busy_since, self.env.now)
            self._busy_since = None
        while self._queue and len(self._users) < self.capacity:
            _, _, nxt = heapq.heappop(self._queue)
            self._grant(nxt)

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    @property
    def busy_since(self) -> Optional[float]:
        """Start of the currently open busy interval (None when idle)."""
        return self._busy_since

    @property
    def in_use(self) -> int:
        return len(self._users)

    def utilization(self, horizon: Optional[float] = None) -> float:
        horizon = self.env.now if horizon is None else horizon
        busy = self.busy_time
        if self._busy_since is not None:
            busy += self.env.now - self._busy_since
        return busy / horizon if horizon > 0 else 0.0

    # -- internals ------------------------------------------------------------
    def _grant(self, req: Event) -> None:
        self._users.append(req)
        if self._busy_since is None:
            self._busy_since = self.env.now
        self.grant_count += 1
        req.succeed(self)


class PriorityResource(Resource):
    """Resource whose waiters are served lowest-priority-value-first.

    The 1F1B "Prior Selector" (PALM Fig. 4) grants backward (priority 0)
    before forward (priority 1) work when both are queued on a stage's
    virtual tile.
    """

    pass  # behaviour comes from the priority heap in Resource.request
