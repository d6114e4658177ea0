"""Request lifecycle for the continuous-batching engine."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from ..core.types import SchedTask, TaskKind


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"       # partially prefilled (chunked)
    DECODE = "decode"
    FINISHED = "finished"
    REJECTED = "rejected"     # PAB admission control
    MIGRATED = "migrated"     # re-routed by the cluster LB (fault/overload)
    SHED = "shed"             # brownout overload shedding (DESIGN.md §16)


@dataclasses.dataclass
class Request:
    req_id: int
    arrival: float
    prompt_len: int
    max_new_tokens: int
    ttft_slo: float
    tpot_slo: float
    state: RequestState = RequestState.QUEUED
    prefilled: int = 0
    generated: int = 0
    # prompt tokens served by the prefix cache at admission (DESIGN.md §10);
    # counted into ``prefilled`` (their KV exists) but never computed here
    cached_context: int = 0
    output_times: list = dataclasses.field(default_factory=list)
    tokens: Optional[list] = None          # real-mode prompt token ids
    generated_tokens: list = dataclasses.field(default_factory=list)
    # effective attention window of the serving arch (cost-model context cap)
    window: Optional[int] = None
    # first time this request was part of a launched batch (DESIGN.md §12):
    # first_scheduled - arrival is the scheduling delay the metrics report
    first_scheduled: Optional[float] = None
    # Envelope anchor (DESIGN.md §9 note): the paper's token_ddl anchors at
    # arrival + ttft_slo, but its §5.1 TPOT metric measures from the ACTUAL
    # first-token time — a request served its first token early could then
    # be legally (per the formula) decoded slower than the measured SLO.
    # "first_token" re-anchors decode deadlines at min(arrival+ttft, t0):
    # strictly tighter, guarantees the paper's own evaluation metric.
    anchor: str = "first_token"    # "first_token" | "slo" (paper formula)
    # Owning tenant/client (DESIGN.md §13): keys the admission stage's
    # per-tenant virtual-token counters and the per-tenant metrics rollup.
    tenant: str = "default"
    # Times this request's KV was evicted by the preemption subsystem
    # (DESIGN.md §13); each eviction converts it back to a re-prefill of
    # its full known prefix.
    preemptions: int = 0
    # Output tokens already folded into ``prompt_len`` by an earlier requeue
    # (preemption / failure migration / snapshot restore) — a later requeue
    # must only fold the tokens generated since, never double-count.
    refolded: int = 0
    # Times this request was recovered after a fault (re-dispatched off a
    # dead rank, or its KV transfer retried) — the retry histogram in
    # ``metrics.summarize`` aggregates it (DESIGN.md §16).
    retries: int = 0

    @property
    def active(self) -> bool:
        return self.state in (RequestState.QUEUED, RequestState.PREFILL,
                              RequestState.DECODE)

    @property
    def context(self) -> int:
        # ``refolded`` output tokens live inside ``prefilled`` after a
        # requeue (preemption/migration/restore) — don't count them twice
        return self.prefilled + self.generated - self.refolded

    def to_sched_task(self) -> SchedTask:
        if self.state in (RequestState.QUEUED, RequestState.PREFILL):
            kind = TaskKind.PREFILL
            new_tokens = self.prompt_len - self.prefilled
            # a resumed request (preempted / migrated / restored) is
            # re-prefilling mid-stream: its next output token is the
            # (generated)-th, so its envelope deadline — and therefore its
            # slack — keeps aging like the decode it interrupted
            # (DESIGN.md §13)
            next_idx = self.generated
        else:
            kind = TaskKind.DECODE
            new_tokens = 1
            next_idx = self.generated
        ctx = self.context
        eff = min(ctx, self.window) if self.window else None
        arrival = self.arrival
        if self.anchor == "first_token" and self.output_times:
            arrival = min(arrival, self.output_times[0] - self.ttft_slo)
        return SchedTask(req_id=self.req_id, arrival=arrival,
                         ttft_slo=self.ttft_slo, tpot_slo=self.tpot_slo,
                         next_output_idx=next_idx, new_tokens=new_tokens,
                         context=ctx, kind=kind, prompt_len=self.prompt_len,
                         effective_context=eff,
                         cached_context=self.cached_context,
                         tenant=self.tenant)

    def speculative_copy(self) -> "Request":
        """Detached copy for the pipelined control plane (DESIGN.md §12).

        ``begin_step`` projects post-step state by advancing copies while the
        real objects stay pinned to committed state until ``complete_step``.
        Mutable progress fields get fresh lists; the (read-only) prompt token
        ids stay shared.
        """
        c = dataclasses.replace(self)
        c.output_times = list(self.output_times)
        c.generated_tokens = list(self.generated_tokens)
        return c

    def preempt_requeue(self) -> None:
        """Convert a preemption victim back to a prefill of its full known
        prefix (DESIGN.md §13).

        The evicted KV is recomputed on resume: prompt + already-generated
        tokens become the new prompt (real mode appends the generated ids so
        the re-prefill reproduces the exact context), ``generated`` and
        ``output_times`` are kept so SLO accounting stays end-to-end, and the
        cached split is reset — the engine re-matches the prefix cache after
        requeue, which is what lets a victim whose prompt pages were adopted
        by the radix tree resume by recomputing only the un-cached tail
        (the effective-token ``cached_context`` path, DESIGN.md §10).
        Idempotent across repeated evictions: only tokens generated since
        the last requeue are folded into the prompt.
        """
        fold = self.generated - self.refolded
        if fold > 0:
            if self.tokens is not None:
                self.tokens = list(self.tokens) \
                    + list(self.generated_tokens[-fold:])
            self.prompt_len += fold
            self.refolded = self.generated
        self.prefilled = 0
        self.cached_context = 0
        self.state = RequestState.PREFILL
        self.preemptions += 1

    def advance(self, n_tokens: int, finish_time: float) -> None:
        """Apply a step's granted tokens; emit output tokens at step end."""
        if self.state in (RequestState.QUEUED, RequestState.PREFILL):
            self.prefilled += n_tokens
            assert self.prefilled <= self.prompt_len
            if self.prefilled == self.prompt_len:
                # prefill completion emits the next output token: the first
                # for a fresh request, the (generated+1)-th for a resumed
                # one (preemption/migration/restore re-prefill their known
                # prefix and pick the stream back up — DESIGN.md §13)
                self.output_times.append(finish_time)
                self.generated += 1
                self.state = (RequestState.FINISHED
                              if self.generated >= self.max_new_tokens
                              else RequestState.DECODE)
            else:
                self.state = RequestState.PREFILL
        else:
            # n_tokens > 1 is a speculative round's accepted run (DESIGN.md
            # §18): all tokens of the round surface at the same step end, so
            # they share one emission timestamp (matches how a non-speculating
            # multi-step horizon stamps its per-step finish times at dt/H
            # granularity — the SLO accounting stays per-token).
            assert n_tokens >= 1
            self.generated += n_tokens
            self.output_times.extend([finish_time] * n_tokens)
            if self.generated >= self.max_new_tokens:
                self.state = RequestState.FINISHED
