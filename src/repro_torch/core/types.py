"""Core scheduling types, engine-agnostic.

The scheduler (src/repro_torch/core) never touches model weights, KV blocks or
devices: it sees lightweight ``SchedTask`` views that the engine (or the
discrete-event simulator, or a test) constructs each step. This is what makes
the scheduler code byte-identical between the real JAX backend and the
simulated backend.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class TaskKind(enum.Enum):
    PREFILL = "prefill"
    DECODE = "decode"


@dataclasses.dataclass
class SchedTask:
    """Per-request view handed to the scheduler at the start of a step.

    Mirrors the inputs of the paper's Algorithm 1.
    """

    req_id: int
    arrival: float                # ArrivalTime_i (seconds)
    ttft_slo: float               # seconds
    tpot_slo: float               # seconds
    next_output_idx: int          # j of the next output token; 0 while prefilling
    new_tokens: int               # computable new tokens (remaining prefill, or 1)
    context: int                  # tokens already in the KV cache / SSM state
    kind: TaskKind
    prompt_len: int = 0           # total prompt tokens (for PAB accounting)
    # Effective attention context for the cost model. For sliding-window or
    # SSM layers the per-step KV traffic is bounded; configs set this so the
    # linear model charges what the hardware actually reads.
    effective_context: Optional[int] = None
    # Prompt tokens served from the prefix cache (DESIGN.md §10). They are
    # part of ``context`` (their KV is read every step) but were never
    # computed by this request: ``new_tokens`` already excludes them, so
    # batch formation / capacity / PAB charge prefill cost only for uncached
    # tokens — the *effective-token* accounting the cache subsystem adds.
    cached_context: int = 0
    # Owning tenant/client for per-tenant fair queuing (DESIGN.md §13). The
    # admission stage of the scheduler stack keys its virtual-token counters
    # on it; single-tenant traces all carry the default and every stack
    # behaves exactly as before.
    tenant: str = "default"
    # Seconds this task has been starved by the data plane (out-of-pool
    # deferrals, DESIGN.md §13); 0 for tasks that have never been deferred.
    # The engine fills it from its deferral registry so admission/formation
    # can age starving work ahead of fresh arrivals.
    deferred_age: float = 0.0

    @property
    def is_decode(self) -> bool:
        return self.kind is TaskKind.DECODE

    @property
    def is_prefill(self) -> bool:
        return self.kind is TaskKind.PREFILL

    def cost_context(self) -> int:
        return self.context if self.effective_context is None else self.effective_context


@dataclasses.dataclass(frozen=True)
class BatchItem:
    """One admitted task with the number of new tokens granted this step."""

    req_id: int
    n_tokens: int
    kind: TaskKind


@dataclasses.dataclass
class BatchPlan:
    """Output of a scheduler step: what to run and what we predicted."""

    items: list[BatchItem]
    predicted_time: float         # scheduler's own estimate of step time (s)
    time_budget: float            # init_time_budget used (s); inf if uncapped
    token_budget_used: int
    token_budget_total: int

    @property
    def total_new_tokens(self) -> int:
        return sum(it.n_tokens for it in self.items)

    def tokens_for(self, req_id: int) -> int:
        for it in self.items:
            if it.req_id == req_id:
                return it.n_tokens
        return 0

    @property
    def decode_items(self) -> list[BatchItem]:
        return [it for it in self.items if it.kind is TaskKind.DECODE]

    @property
    def prefill_items(self) -> list[BatchItem]:
        return [it for it in self.items if it.kind is TaskKind.PREFILL]
