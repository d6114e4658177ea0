"""Prefill Admission Budget (paper §3.4 + Appendix A).

PAB estimates how many *additional* prefill tokens a node can absorb within a
new request's TTFT SLO without violating any active request's envelope. It is
a worst-case relaxation: assume every decode is delayed until its slack is
exhausted, maximizing the window left for prefill.

    N_batches = (TTFT_slo - min_i slack_i) / TPOT_slo + 1          (step count)
    R_batches = N_batches * a                                       (fixed overheads)
    N_i       = max(0, (TTFT_slo - slack_i) / TPOT_slo)             (decode steps owed)
    R_tasks   = Σ_i N_i * (b + context_i * c)                       (decode compute)
    R_prefill = TTFT_slo - R_batches - R_tasks
    PAB       = R_prefill / (b + c) - Σ_{i∈prefill} remaining_prompt_i

The upper-level scheduler treats PAB as an additive token budget: it routes a
request to a node with PAB >= prompt_len, then decrements its local view
(eventual consistency; refreshed every engine step).
"""
from __future__ import annotations

from typing import Optional, Sequence

from . import slo
from .cost_model import LinearCostModel
from .types import SchedTask


def prefill_admission_budget(tasks: Sequence[SchedTask], now: float,
                             model: LinearCostModel, ttft_slo: float,
                             tpot_slo: float,
                             free_kv_tokens: Optional[int] = None) -> float:
    """Tokens of new prefill admissible within `ttft_slo` from `now`.

    ``free_kv_tokens`` (DESIGN.md §14) caps the time-derived budget by KV
    *capacity*: a prompt the node has no pages for would be admitted only
    to preempt or stall, so the budget is ``min(time budget, free KV
    tokens)``. Pass ``kv_page_budget(...) * page_size`` — quantized KV
    roughly doubles this cap at equal HBM. ``None`` keeps the paper's
    pure-time budget.
    """
    if model.b + model.c <= 0:
        return 0.0
    if tasks:
        min_slack = min(slo.slack(t, now) for t in tasks)
    else:
        min_slack = ttft_slo
    n_batches = max(0.0, (ttft_slo - min_slack) / tpot_slo) + 1.0
    r_batches = n_batches * model.a

    r_tasks = 0.0
    for t in tasks:
        s = slo.slack(t, now)
        n_i = max(0.0, (ttft_slo - s) / tpot_slo)
        r_tasks += n_i * (model.b + t.cost_context() * model.c)

    r_prefill = ttft_slo - r_batches - r_tasks
    t_prefill = r_prefill / (model.b + model.c)

    pending_prefill = sum(t.new_tokens for t in tasks if t.is_prefill)
    budget = t_prefill - pending_prefill
    if free_kv_tokens is not None:
        budget = min(budget, float(free_kv_tokens - pending_prefill))
    return budget


class PABAdmissionController:
    """Node-local admission control (FairBatching-PAB single-node variant).

    Rejects a new request when the node's current PAB cannot cover its
    prompt; the paper counts a rejection as an SLO violation for fairness of
    comparison, and in the cluster setting the upper-level scheduler would
    instead route the request elsewhere.
    """

    def __init__(self, ttft_slo: float, tpot_slo: float,
                 headroom: float = 1.0):
        self.ttft_slo = ttft_slo
        self.tpot_slo = tpot_slo
        self.headroom = headroom  # <1.0 admits more aggressively
        self.rejected = 0

    def admit(self, prompt_len: int, tasks: Sequence[SchedTask], now: float,
              model: LinearCostModel, ttft_slo: Optional[float] = None,
              tpot_slo: Optional[float] = None,
              cached_tokens: int = 0,
              free_kv_tokens: Optional[int] = None) -> bool:
        """Admit iff the budget covers the prompt. Heterogeneous SLO tiers
        pass the incoming request's own (ttft_slo, tpot_slo): the budget is
        computed against *its* deadline, not the node default.

        ``cached_tokens`` (DESIGN.md §10) is the prefix-cache hit for this
        prompt: those tokens cost no prefill compute, so the budget only has
        to cover the *effective* (uncached) prompt — cache hits raise
        admission capacity exactly as they raise serving capacity."""
        pab = prefill_admission_budget(
            tasks, now, model,
            self.ttft_slo if ttft_slo is None else ttft_slo,
            self.tpot_slo if tpot_slo is None else tpot_slo,
            free_kv_tokens=free_kv_tokens)
        ok = pab >= (prompt_len - cached_tokens) * self.headroom
        if not ok:
            self.rejected += 1
        return ok
