"""Batch formation — the formation stage of the scheduler stack
(DESIGN.md §13).

``form_batch`` is the paper's Algorithm 1 (§3.3); ``form_stall_free``
(Sarathi) and ``form_prefill_first`` (vLLM-vanilla) are the baseline
packers. All three are pure functions over ``SchedTask`` views —
``core.policy`` wraps them as composable ``FormationPolicy`` stages and
``core.schedulers`` preconfigures the named stacks.

Fair and dynamic batch formation — the paper's Algorithm 1 (§3.3).

Three groups, packed in reversed-priority order:

  1. ``group_ud`` — urgent decodes: slack < init_time_budget + min_tpot_slo.
     Skipping one would likely violate its envelope next step; they are
     admitted unconditionally (paper: "conservatively ensures that urgent
     decode tasks are always included"), which is also what makes the policy
     degrade gracefully to Sarathi under extreme load.
  2. ``group_p`` — prefills: TTFT-critical, arrival pattern unpredictable, so
     they outrank decodes that still have slack.
  3. ``group_nd`` — non-urgent decodes: admitted only into leftover capacity;
     deferring them converts their accumulated slack into prefill capacity —
     the fairness reclamation at the heart of the paper.

Each group is sorted by slack ascending. Prefills larger than the remaining
budget are *chunked* (chunked-prefill) to exactly fill it.

Prefix-cache interaction (DESIGN.md §10): tasks arrive with *effective*
token counts — ``SchedTask.new_tokens`` excludes any cache-served prefix
(``cached_context``) while ``cost_context()`` still includes it, so packing
charges compute only for uncached tokens but KV traffic for the full
context. No cache-specific logic lives here by design.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from . import capacity, slo
from .cost_model import LinearCostModel
from .types import BatchItem, BatchPlan, SchedTask, TaskKind


@dataclasses.dataclass
class FormationConfig:
    max_token_budget: int = 8192      # largest compiled step shape (CUDA-graph analogue)
    max_time_budget: float = math.inf # cap when no decode task bounds the step
    min_chunk: int = 16               # don't schedule prefill slivers below this
    force_urgent_decodes: bool = True # admit group_ud even past the budget
    # Execution-noise headroom: the envelope admits steps ending exactly AT a
    # deadline; a few % of jitter then lands tokens late and the max-TPOT
    # metric counts a single late token as a violated request. Packing uses
    # safety × budget (beyond-paper robustness knob, EXPERIMENTS.md).
    safety: float = 0.93


def classify(tasks: Sequence[SchedTask], now: float, time_budget: float,
             min_tpot: float) -> tuple[list[SchedTask], list[SchedTask], list[SchedTask]]:
    """Split tasks into (urgent decode, prefill, non-urgent decode), slack-sorted."""
    group_ud: list[SchedTask] = []
    group_p: list[SchedTask] = []
    group_nd: list[SchedTask] = []
    urgency_bound = time_budget + min_tpot
    for t in tasks:
        if t.is_decode and slo.slack(t, now) < urgency_bound:
            group_ud.append(t)
        elif t.is_prefill:
            group_p.append(t)
        else:
            group_nd.append(t)
    key = lambda t: slo.slack(t, now)
    group_ud.sort(key=key)
    group_p.sort(key=key)
    group_nd.sort(key=key)
    return group_ud, group_p, group_nd


def form_batch(tasks: Sequence[SchedTask], now: float, model: LinearCostModel,
               cfg: FormationConfig) -> BatchPlan:
    """Algorithm 1. Returns the batch plan for the next step."""
    if not tasks:
        return BatchPlan(items=[], predicted_time=0.0, time_budget=0.0,
                         token_budget_used=0, token_budget_total=cfg.max_token_budget)

    budget0 = capacity.init_time_budget(tasks, now, cfg.max_time_budget)
    min_tpot = capacity.min_tpot_slo(tasks)
    group_ud, group_p, group_nd = classify(tasks, now, budget0, min_tpot)

    time_budget = budget0 * cfg.safety - model.a
    token_budget = cfg.max_token_budget
    items: list[BatchItem] = []

    for group, is_ud in ((group_ud, True), (group_p, False), (group_nd, False)):
        for t in group:
            if token_budget <= 0 and not (is_ud and cfg.force_urgent_decodes):
                continue
            ctx = t.cost_context()
            time_cost = model.task_cost(t.new_tokens, ctx)
            if (time_cost <= time_budget and t.new_tokens <= token_budget) or \
                    (is_ud and cfg.force_urgent_decodes):
                items.append(BatchItem(t.req_id, t.new_tokens, t.kind))
                time_budget -= time_cost
                token_budget -= t.new_tokens
            elif token_budget > 0 and model.c * ctx <= time_budget and model.b > 0:
                # Partial admission: chunk the task to exactly fill the budget.
                fit = ((time_budget - model.c * ctx) / model.b
                       if math.isfinite(time_budget) else token_budget)
                cp = min(token_budget, int(fit))
                if t.is_decode or cp < min(cfg.min_chunk, t.new_tokens):
                    continue  # decodes are atomic; skip sliver chunks
                cp = min(cp, t.new_tokens)
                items.append(BatchItem(t.req_id, cp, t.kind))
                time_budget -= model.task_cost(cp, ctx)
                token_budget -= cp

    total_nt = sum(it.n_tokens for it in items)
    total_ctx = 0
    by_id = {t.req_id: t for t in tasks}
    for it in items:
        total_ctx += by_id[it.req_id].cost_context()
    predicted = model.step_time(total_nt, total_ctx)
    return BatchPlan(items=items, predicted_time=predicted, time_budget=budget0,
                     token_budget_used=cfg.max_token_budget - token_budget,
                     token_budget_total=cfg.max_token_budget)


def form_stall_free(tasks: Sequence[SchedTask], now: float,
                    model: LinearCostModel, token_budget: int) -> BatchPlan:
    """Sarathi stall-free packing (paper §2.3 baseline). Decode-prioritizing:

    1. every active decode task joins the batch (1 token each);
    2. leftover token budget is given to prefills, FCFS, chunked.
    """
    items: list[BatchItem] = []
    budget = token_budget
    total_ctx = 0
    for t in tasks:
        if t.is_decode:
            items.append(BatchItem(t.req_id, 1, t.kind))
            budget -= 1
            total_ctx += t.cost_context()
    for t in sorted((t for t in tasks if t.is_prefill), key=lambda t: t.arrival):
        if budget <= 0:
            break
        grant = min(budget, t.new_tokens)
        items.append(BatchItem(t.req_id, grant, t.kind))
        budget -= grant
        total_ctx += t.cost_context()
    nt = sum(it.n_tokens for it in items)
    return BatchPlan(items=items,
                     predicted_time=model.step_time(nt, total_ctx),
                     time_budget=math.inf,
                     token_budget_used=token_budget - budget,
                     token_budget_total=token_budget)


def form_prefill_first(tasks: Sequence[SchedTask], now: float,
                       model: LinearCostModel,
                       max_num_batched_tokens: int) -> BatchPlan:
    """vLLM-vanilla packing (§2.3 baseline): waiting prefills are scheduled
    first (whole prompts, FCFS) up to ``max_num_batched_tokens``; decodes run
    only when no prefill waits — a prompt burst delays decodes, reproducing
    vanilla's TBT/TPOT tail (Fig 6)."""
    items: list[BatchItem] = []
    budget = max_num_batched_tokens
    total_ctx = 0
    prefills = sorted((t for t in tasks if t.is_prefill), key=lambda t: t.arrival)
    for t in prefills:
        if budget <= 0:
            break
        grant = min(budget, t.new_tokens)
        items.append(BatchItem(t.req_id, grant, t.kind))
        budget -= grant
        total_ctx += t.cost_context()
    if not items:  # no waiting prefill: pure decode batch
        for t in tasks:
            if t.is_decode and budget > 0:
                items.append(BatchItem(t.req_id, 1, t.kind))
                budget -= 1
                total_ctx += t.cost_context()
    nt = sum(it.n_tokens for it in items)
    return BatchPlan(items=items,
                     predicted_time=model.step_time(nt, total_ctx),
                     time_budget=math.inf,
                     token_budget_used=max_num_batched_tokens - budget,
                     token_budget_total=max_num_batched_tokens)
