"""Continuous batcher: iteration-level admission + KV-cache pressure.

The batcher is the serving policy half of ``repro_torch.serving.system`` — pure
bookkeeping, no event loop. The :class:`~.system.ServingSimulator` asks it
what the next engine iteration should do; it tracks the waiting queue, the
running batch, and KV-cache occupancy against a byte budget derived from
the same SRAM/DRAM :class:`~repro_torch.core.sram.StageMemory` accounting the
training simulator uses.

Two policies:

* ``"continuous"`` — Orca/vLLM-style iteration-level scheduling: waiting
  requests are admitted into the running batch between decode iterations
  (prefill-prioritizing), and requests retire individually the moment
  their last token is emitted.
* ``"static"`` — classic batch serving: a batch is formed only when the
  previous one has fully drained, so short requests wait for the longest
  request in their batch (the baseline the goodput benchmark rigs
  against).

KV pressure: every decode iteration grows each running request's cache by
one token. When occupancy exceeds the budget the batcher preempts
most-recently-admitted requests (LIFO, the vLLM recompute policy):
their cache is dropped, they re-queue at the *front* of the waiting
queue, and on re-admission the whole context (prompt + tokens generated
so far) is re-prefilled — recompute-on-resume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..configs.base import ArchConfig
from .workload import Request

__all__ = ["KVCacheModel", "ActiveRequest", "ContinuousBatcher"]

CONTINUOUS, STATIC = "continuous", "static"
_POLICIES = (CONTINUOUS, STATIC)


@dataclass(frozen=True)
class KVCacheModel:
    """Per-request decode-cache footprint of an architecture.

    ``per_token_bytes`` covers the attention KV cache (2 x n_kv x head_dim
    per layer per token, capped at ``window`` tokens for sliding-window
    attention); ``fixed_bytes`` the per-request constant state (Mamba2 SSD
    state + conv buffer for ssm/hymba blocks).
    """

    per_token_bytes: float
    fixed_bytes: float
    window: int = 0     # 0 = full attention (cache grows with context)

    @classmethod
    def from_arch(cls, arch: ArchConfig, precision_bytes: int = 2) -> "KVCacheModel":
        per_tok = 0.0
        fixed = 0.0
        if arch.has_attention:
            per_tok = 2.0 * arch.n_kv * arch.head_dim * precision_bytes \
                * arch.num_layers
        if arch.block in ("ssm", "hymba"):
            # SSD state (n_heads x headdim x d_state == d_inner x d_state)
            # plus the depthwise-conv ring buffer
            fixed = float(arch.num_layers * precision_bytes
                          * (arch.d_inner * arch.ssm_state
                             + arch.d_inner * arch.conv_width))
        return cls(per_token_bytes=per_tok, fixed_bytes=fixed,
                   window=arch.window)

    def request_bytes(self, context_len: int) -> float:
        """Cache bytes for one request holding ``context_len`` tokens."""
        tokens = min(context_len, self.window) if self.window else context_len
        return self.fixed_bytes + tokens * self.per_token_bytes


@dataclass
class ActiveRequest:
    """Mutable serving state of one request across its lifetime."""

    req: Request
    enqueued_at: float          # last (re-)queue time, for the QUEUE lane
    episode: int = 0            # bumped on every eviction/resume
    generated: int = 0          # output tokens emitted so far
    context: int = 0            # tokens resident in the KV cache
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    decode_started_at: Optional[float] = None   # this episode's decode start
    finished_at: Optional[float] = None
    preemptions: int = 0

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def resume_context(self) -> int:
        """Tokens to (re-)prefill on admission: the prompt plus whatever
        was already generated before an eviction dropped the cache."""
        return self.req.prompt_len + self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.req.decode_len


class ContinuousBatcher:
    """Admission / retirement / preemption policy over a KV byte budget.

    The simulator owns time; every method takes ``now`` and returns what
    changed so the caller can record trace lanes. Determinism: all
    ordering is by explicit FIFO/LIFO position — no hashing, no clocks.
    """

    def __init__(self, kv: KVCacheModel, kv_budget_bytes: float,
                 max_batch: int = 32, policy: str = CONTINUOUS):
        if policy not in _POLICIES:
            raise ValueError(f"unknown batching policy {policy!r}; "
                             f"known: {', '.join(_POLICIES)}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.kv = kv
        self.kv_budget_bytes = float(kv_budget_bytes)
        self.max_batch = int(max_batch)
        self.policy = policy
        self.waiting: List[ActiveRequest] = []      # FIFO; resumes at front
        self.running: List[ActiveRequest] = []      # admission order (LIFO evict)
        self.finished: List[ActiveRequest] = []
        self.rejected: List[ActiveRequest] = []
        self.preemptions = 0

    # -- state ----------------------------------------------------------------
    @property
    def kv_used_bytes(self) -> float:
        return sum(self.kv.request_bytes(a.context) for a in self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def num_outstanding(self) -> int:
        return len(self.waiting) + len(self.running)

    # -- arrivals --------------------------------------------------------------
    def add(self, req: Request, now: float) -> Optional[ActiveRequest]:
        """New arrival. Requests whose full context (prompt + all decode
        tokens) can never fit the budget alone are rejected up front —
        the deadlock guard that keeps eviction from thrashing forever."""
        act = ActiveRequest(req=req, enqueued_at=now)
        if self.kv.request_bytes(req.total_tokens) > self.kv_budget_bytes:
            act.finished_at = now
            self.rejected.append(act)
            return None
        self.waiting.append(act)
        return act

    # -- admission -------------------------------------------------------------
    def admit(self, now: float) -> List[ActiveRequest]:
        """Move waiting requests into the running batch (front-of-queue
        first). Continuous policy admits between any two iterations;
        static policy only forms a new batch once the previous one has
        fully drained. Admitted requests still need their prefill —
        the caller runs it and then calls :meth:`finish_prefill`."""
        if self.policy == STATIC and self.running:
            return []
        admitted: List[ActiveRequest] = []
        used = self.kv_used_bytes
        while (self.waiting and
               len(self.running) + len(admitted) < self.max_batch):
            cand = self.waiting[0]
            need = self.kv.request_bytes(cand.resume_context)
            if used + need > self.kv_budget_bytes:
                break           # head-of-line blocking keeps FIFO fairness
            self.waiting.pop(0)
            cand.admitted_at = now
            used += need
            admitted.append(cand)
        self.running.extend(admitted)
        return admitted

    def finish_prefill(self, admitted: List[ActiveRequest],
                       now: float) -> List[ActiveRequest]:
        """Prefill done: contexts become resident and each admitted
        request's first *new* token of this episode is out (for episode 0
        that is the request's first token — TTFT stops here). Requests
        whose last token that was (``decode_len`` reached, e.g. single-
        token completions or a resume that recomputed to the end) retire
        immediately and are returned."""
        retired: List[ActiveRequest] = []
        for act in admitted:
            act.context = act.resume_context + 1    # prefill emits one token
            act.generated += 1
            act.decode_started_at = now
            if act.first_token_at is None:
                act.first_token_at = now
            if act.done:
                act.finished_at = now
                act.context = 0
                self.running.remove(act)
                self.finished.append(act)
                retired.append(act)
        return retired

    # -- decode ----------------------------------------------------------------
    def decode_batch(self) -> List[ActiveRequest]:
        return list(self.running)

    def finish_decode(self, now: float) -> Tuple[List[ActiveRequest],
                                                 List[ActiveRequest]]:
        """One decode iteration done: every running request emitted one
        token and its cache grew by one. Returns ``(retired, evicted)``:
        requests that emitted their last token retire; then, if the grown
        occupancy exceeds the budget, most-recently-admitted requests are
        preempted (cache dropped, re-queued at the front, episode += 1)
        until the rest fit. The longest-running request is never evicted
        (the deadlock guard in :meth:`add` guarantees it fits alone)."""
        retired: List[ActiveRequest] = []
        for act in self.running:
            act.generated += 1
            act.context += 1
        still: List[ActiveRequest] = []
        for act in self.running:
            if act.done:
                act.finished_at = now
                act.context = 0
                retired.append(act)
                self.finished.append(act)
            else:
                still.append(act)
        self.running = still
        evicted: List[ActiveRequest] = []
        while len(self.running) > 1 and self.kv_used_bytes > self.kv_budget_bytes:
            victim = self.running.pop()             # LIFO: newest admission
            victim.context = 0                      # recompute-on-resume
            victim.episode += 1
            victim.preemptions += 1
            victim.admitted_at = None
            victim.enqueued_at = now
            self.preemptions += 1
            evicted.append(victim)
        # resumes go to the *front*, oldest-first, so preempted requests
        # are not starved by fresh arrivals
        for victim in reversed(evicted):
            self.waiting.insert(0, victim)
        return retired, evicted
