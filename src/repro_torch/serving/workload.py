"""Request workloads for the serving simulator (traffic generators).

A :class:`WorkloadSpec` describes an inference request stream the way the
TCO-survey pipeline frames it (workload -> simulator -> cost): a seeded
arrival process (Poisson or bursty Markov-modulated Poisson), prompt and
decode length distributions (fixed or discretized lognormal), or a
replayable request trace. :meth:`WorkloadSpec.generate` materializes the
deterministic request list — same spec, same seed, bit-identical
requests, in this process or a pool worker — and the JSON trace form
(:func:`workload_to_json` / :func:`workload_from_json`) makes any
generated stream replayable and shareable.

Everything here is dependency-free (``random.Random`` only) so the
serving simulator runs in the same environments as the event core.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Request", "WorkloadSpec", "workload_to_json", "workload_from_json"]

_SCHEMA = 1

# arrival-process kinds
POISSON, BURSTY, REPLAY = "poisson", "bursty", "replay"
_KINDS = (POISSON, BURSTY, REPLAY)


@dataclass(frozen=True)
class Request:
    """One inference request: arrival time (s), prompt length (tokens to
    prefill) and decode length (tokens to generate, >= 1 — the first
    output token comes out of the prefill)."""

    rid: int
    arrival: float
    prompt_len: int
    decode_len: int

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.decode_len

    def to_row(self) -> List:
        return [self.arrival, self.prompt_len, self.decode_len]


def _lognormal_int(rng: random.Random, mean: float, cv: float,
                   lo: int, hi: Optional[int]) -> int:
    """Discretized lognormal with the given mean and coefficient of
    variation; ``cv=0`` degenerates to the (rounded) mean."""
    if cv <= 0:
        v = mean
    else:
        sigma2 = math.log(1.0 + cv * cv)
        mu = math.log(mean) - sigma2 / 2.0
        v = rng.lognormvariate(mu, math.sqrt(sigma2))
    out = max(lo, int(round(v)))
    return min(out, hi) if hi is not None else out


@dataclass
class WorkloadSpec:
    """Seeded request-stream description.

    ``kind`` selects the arrival process:

    * ``"poisson"`` — stationary Poisson arrivals at ``rate`` req/s.
    * ``"bursty"``  — two-state Markov-modulated Poisson: the rate
      alternates between ``rate * burst_factor`` (burst) and
      ``rate / burst_factor`` (lull), with exponentially distributed
      state dwell times of mean ``burst_dwell_s`` seconds. Exponential
      memorylessness makes the advance-to-switch-and-redraw simulation
      exact.
    * ``"replay"``  — play back an explicit request list (``requests``,
      e.g. loaded via :func:`workload_from_json`).

    Prompt/decode lengths draw from discretized lognormals with the given
    mean and coefficient of variation (``cv = 0`` means fixed lengths);
    decode lengths are always >= 1 (the prefill emits the first token).
    """

    kind: str = POISSON
    rate: float = 4.0                     # mean arrival rate (requests/s)
    num_requests: int = 64
    seed: int = 0
    prompt_mean: float = 512.0
    prompt_cv: float = 0.0
    prompt_max: Optional[int] = None
    decode_mean: float = 64.0
    decode_cv: float = 0.0
    decode_max: Optional[int] = None
    burst_factor: float = 4.0             # bursty: hi = rate*f, lo = rate/f
    burst_dwell_s: float = 2.0            # mean dwell per MMPP state
    # replay payload (kind == "replay"); rows are [arrival, prompt, decode]
    requests: Optional[List[List]] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}; "
                             f"known: {', '.join(_KINDS)}")
        if self.kind == REPLAY:
            if not self.requests:
                raise ValueError("replay workload needs a `requests` list")
        else:
            if self.rate <= 0:
                raise ValueError("arrival rate must be > 0")
            if self.num_requests < 1:
                raise ValueError("num_requests must be >= 1")
        if self.kind == BURSTY and self.burst_factor < 1:
            raise ValueError("burst_factor must be >= 1")

    # -- generation ----------------------------------------------------------
    def _arrivals(self, rng: random.Random) -> List[float]:
        if self.kind == POISSON:
            t, out = 0.0, []
            for _ in range(self.num_requests):
                t += rng.expovariate(self.rate)
                out.append(t)
            return out
        # bursty MMPP: start in the burst state (deterministic), draw the
        # next state-switch time, advance gap-by-gap
        hi, lo = self.rate * self.burst_factor, self.rate / self.burst_factor
        state_rate = hi
        t = 0.0
        t_switch = rng.expovariate(1.0 / self.burst_dwell_s)
        out: List[float] = []
        while len(out) < self.num_requests:
            gap = rng.expovariate(state_rate)
            if t + gap >= t_switch:
                # memoryless: jump to the switch point and redraw at the
                # new rate — an exact MMPP simulation, not an approximation
                t = t_switch
                state_rate = lo if state_rate == hi else hi
                t_switch = t + rng.expovariate(1.0 / self.burst_dwell_s)
                continue
            t += gap
            out.append(t)
        return out

    def generate(self) -> List[Request]:
        """The deterministic request list for this spec (seeded)."""
        if self.kind == REPLAY:
            reqs = [Request(rid=i, arrival=float(a), prompt_len=int(p),
                            decode_len=max(1, int(d)))
                    for i, (a, p, d) in enumerate(self.requests)]
            return sorted(reqs, key=lambda r: (r.arrival, r.rid))
        rng = random.Random(self.seed)
        arrivals = self._arrivals(rng)
        out = []
        for i, t in enumerate(arrivals):
            prompt = _lognormal_int(rng, self.prompt_mean, self.prompt_cv,
                                    lo=1, hi=self.prompt_max)
            decode = _lognormal_int(rng, self.decode_mean, self.decode_cv,
                                    lo=1, hi=self.decode_max)
            out.append(Request(rid=i, arrival=t, prompt_len=prompt,
                               decode_len=decode))
        return out

    @property
    def offered_rate(self) -> float:
        """Mean offered arrival rate (requests/s)."""
        if self.kind != REPLAY:
            return self.rate
        rows = self.requests or []
        if len(rows) < 2:
            return 0.0
        span = max(r[0] for r in rows) - min(r[0] for r in rows)
        return (len(rows) - 1) / span if span > 0 else 0.0

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {
            "kind": self.kind, "rate": self.rate,
            "num_requests": self.num_requests, "seed": self.seed,
            "prompt_mean": self.prompt_mean, "prompt_cv": self.prompt_cv,
            "prompt_max": self.prompt_max,
            "decode_mean": self.decode_mean, "decode_cv": self.decode_cv,
            "decode_max": self.decode_max,
            "burst_factor": self.burst_factor,
            "burst_dwell_s": self.burst_dwell_s,
        }
        if self.requests is not None:
            d["requests"] = [list(r) for r in self.requests]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadSpec":
        return cls(**dict(d))


def workload_to_json(requests: Sequence[Request], **kw: Any) -> str:
    """Replayable JSON trace of a concrete request list."""
    return json.dumps({"schema": _SCHEMA,
                       "requests": [r.to_row() for r in requests]}, **kw)


def workload_from_json(text: str) -> WorkloadSpec:
    """Parse a request-trace JSON document into a replay WorkloadSpec."""
    doc = json.loads(text)
    if doc.get("schema", _SCHEMA) != _SCHEMA:
        raise ValueError(f"unknown workload schema {doc.get('schema')!r}")
    rows = doc.get("requests")
    if not isinstance(rows, list) or not rows:
        raise ValueError("workload trace needs a non-empty `requests` list")
    return WorkloadSpec(kind=REPLAY, requests=[list(r) for r in rows])
