"""Adaptive batch-capacity determination (paper §3.2).

The batch's maximum execution time is bounded by the smallest deadline slack
among *decode* tasks (running longer than that would push some decode past
its envelope). Under decode bursts that bound can collapse toward zero, so
the paper floors it at the smallest TPOT SLO among active requests:

    init_time_budget = max(min_i slack_i, min_i tpot_slo_i)

Notes vs the paper:
  * §3.2 prose takes min slack over decode requests; Algorithm 1's pseudocode
    loops over all active requests. We follow the prose (decode-only min):
    a late prefill has negative slack, and shrinking the budget because
    prefill is late would starve the very task that needs a big batch. The
    divergence is flagged here and covered by a unit test.
  * With no active decode tasks there is no TPOT bound; capacity is limited
    only by the engine's largest compiled step (``max_time_budget``).

``commit_horizon`` extends the same slack arithmetic from one step to a
*run* of steps: how many consecutive decode steps can be committed as a
single device dispatch before any active envelope — or the TTFT of a
queued/predicted prefill — would be violated (DESIGN.md §12). It is the
paper-native answer to multi-step decode: naive N-step commitment re-creates
the decode-prioritizing unfairness of Fig 1, while slack-bounding it keeps
every envelope (and the PAB admission promise) intact.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from . import slo
from .cost_model import LinearCostModel, per_shard_model
from .types import SchedTask


def init_time_budget(tasks: Sequence[SchedTask], now: float,
                     max_time_budget: float = math.inf) -> float:
    decode_slacks = [slo.slack(t, now) for t in tasks if t.is_decode]
    tpots = [t.tpot_slo for t in tasks]
    if not decode_slacks:
        return max_time_budget
    budget = max(min(decode_slacks), min(tpots))
    return min(budget, max_time_budget)


def min_tpot_slo(tasks: Sequence[SchedTask]) -> float:
    if not tasks:
        return math.inf
    return min(t.tpot_slo for t in tasks)


def _pages_needed(contexts: Sequence[int], h: int, page_size: int) -> int:
    """New KV pages h committed decode tokens per task will allocate.

    Each task's last page has ``(-ctx) % page_size`` free slots; tokens past
    that tail open fresh pages.
    """
    need = 0
    for c in contexts:
        tail = (-c) % page_size
        if h > tail:
            need += -(-(h - tail) // page_size)
    return need


def commit_horizon(tasks: Sequence[SchedTask], now: float,
                   model: LinearCostModel, *, max_horizon: int,
                   ttft_slo: float, predicted_prefill_tokens: int = 0,
                   safety: float = 1.0, free_pages: Optional[int] = None,
                   page_size: int = 0, n_shards: int = 1,
                   speculate: int = 0, acceptance: float = 0.0,
                   draft_frac: float = 0.0) -> int:
    """Safe multi-step decode commitment depth (DESIGN.md §12).

    Returns the largest ``H <= max_horizon`` such that committing the
    current all-decode batch for H consecutive steps in ONE dispatch keeps
    every constraint that single-step FairBatching enforces per step:

    * **Envelopes** (paper §3.1): decode task *i*'s h-th committed token is
      emitted at ``now + sum_{k<=h} dt_k`` and must land inside its envelope,
      i.e. within ``slack_i(now) + (h-1)·tpot_slo_i`` — each task's OWN
      TPOT SLO, so heterogeneous tiers bound the horizon individually.
      Per-step times come from the calibrated linear model with contexts
      grown by one token per task per committed step (a pessimistic
      overestimate for sliding-window archs, which only shrinks H — never
      busts an envelope).
    * **Queued prefill TTFT**: any prefill task present in ``tasks`` means
      the scheduler owes it chunks *now* — committing past it would starve
      exactly the task FairBatching protects, so the horizon is 1.
    * **Predicted prefill TTFT** (PAB-style reserve, §3.4): while H steps
      run the engine is unresponsive; a prompt of ``predicted_prefill_tokens``
      arriving right after dispatch must still make its TTFT SLO:
      ``sum dt_k + prefill_time <= ttft_slo``. Zero disables the reserve.
    * **KV page budget** (DESIGN.md §14): with ``free_pages``/``page_size``
      given, the horizon stops before the committed tokens would allocate
      more pages than the pool has free — a multi-step dispatch cannot
      defer mid-run the way the single-step executor can, so committing
      past the pool would force mid-horizon preemption. Quantized KV
      (``kv_bytes_per_token``) funds more pages at equal HBM, so the same
      trace sustains deeper commitments. ``None`` disables the bound.

    ``safety`` mirrors ``FormationConfig.safety``: constraints are checked
    against ``safety × allowance`` to absorb execution jitter.

    ``n_shards`` prices steps with the per-shard cost model (DESIGN.md
    §17): under n-way tensor parallelism each committed step's marginal
    coefficients divide by n, so the same slack funds a deeper horizon.
    The KV page bound is deliberately NOT scaled — page IDs are global
    under TP (only the per-page head slice is shard-local), so the pool
    drains at the same page rate regardless of shard count.

    ``speculate`` = γ prices *speculative* committed rounds (DESIGN.md
    §18): each round drafts γ candidates and verifies γ+1 positions per
    sequence, so a round computes ``n·(γ+1) + ceil(n·γ·draft_frac)``
    token-equivalents (``draft_frac`` = draft-pass cost as a fraction of
    a target-pass token) while *emitting* an expected ``1 + acceptance·γ``
    tokens per sequence. The emission allowance each round earns grows at
    that expected rate, so the caller must pass a pessimistic
    ``acceptance`` (the engine uses an EWMA floored at its cold-start
    value): overstating acceptance is the only way a TPOT envelope can be
    busted, understating only shrinks H. The KV page bound is
    reservation-based — every round reserves γ+1 slots per sequence
    regardless of acceptance, so a cold-start acceptance collapse can
    never outrun the page pool. ``speculate=0`` is bitwise the
    non-speculative arithmetic above.
    """
    if max_horizon <= 1 or not tasks:
        return 1
    model = per_shard_model(model, n_shards)
    decodes = [t for t in tasks if t.is_decode]
    if len(decodes) != len(tasks):
        return 1                      # a queued prefill is owed service now
    n = len(decodes)
    contexts = [t.cost_context() for t in decodes]
    ctx0 = sum(contexts)
    slacks = [slo.slack(t, now) for t in decodes]
    tpots = [t.tpot_slo for t in decodes]
    gamma = max(int(speculate), 0)
    if gamma:
        # per-round token-equivalents, reserved KV slots, and pessimistic
        # context growth (every drafted slot counted, as if all accepted)
        emit_rate = 1.0 + max(min(acceptance, 1.0), 0.0) * gamma
        round_tokens = n * (gamma + 1) + math.ceil(n * gamma * draft_frac)
        slots = gamma + 1
    else:
        emit_rate = 1.0
        round_tokens = n
        slots = 1
    reserve = (model.step_time(predicted_prefill_tokens, 0)
               if predicted_prefill_tokens > 0 else 0.0)
    cum = 0.0
    h = 0
    while h < max_horizon:
        if (free_pages is not None and page_size > 0
                and _pages_needed(contexts, (h + 1) * slots,
                                  page_size) > free_pages):
            return max(h, 1)          # step h+1 would outrun the page pool
        # contexts grow by one token per decode per committed step
        # (γ+1 reserved slots per round under speculation — pessimistic)
        dt = model.step_time(round_tokens, ctx0 + h * n * slots)
        cum += dt
        for s, tp in zip(slacks, tpots):
            if cum > safety * (s + h * emit_rate * tp):
                return max(h, 1)      # h-th token would leave its envelope
        if reserve and cum + reserve > safety * ttft_slo:
            return max(h, 1)          # would bust a predicted prefill's TTFT
        h += 1
    return h
