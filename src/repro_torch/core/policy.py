"""Composable scheduler stack: admission → capacity → formation (DESIGN.md §13).

The monolithic schedulers of the original reproduction entangled three
decisions that production serving keeps separate:

  1. **Admission** — which of the node's runnable tasks are *eligible* this
     step. This is where inter-client arbitration lives: per-tenant virtual
     token counters (VTC, "Fairness in Serving Large Language Models",
     Sheng et al. 2024) can hold a flooding tenant's prefills back so an
     interactive tenant's deadline work is not crowded out. FCFS admission
     (the default) passes everything through — bit-identical to the
     pre-stack schedulers.
  2. **Capacity** — how large the step may be: the paper's adaptive
     slack-derived time budget (§3.2), its FB-TokenBudget / FB-FixBatch
     ablations, or an uncapped pass-through for baselines. PAB admission
     control and ``commit_horizon`` (§3.4 / §12) are the other residents of
     this layer; they already live in ``core.pab`` / ``core.capacity`` and
     the capacity stage shares their arithmetic.
  3. **Formation** — which eligible tasks enter the batch and with how many
     tokens: the paper's 3-group Algorithm 1, Sarathi's stall-free packing,
     or vLLM-vanilla's prefill-first FCFS (all in ``core.batch_formation``).

``SchedulerStack`` composes one policy per stage behind the same
``Scheduler`` protocol every engine/simulator/benchmark already consumes;
``core.schedulers`` preconfigures the named stacks ("fairbatching",
"sarathi", …) so existing entry points keep working unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence

from . import capacity
from .batch_formation import (FormationConfig, form_batch, form_prefill_first,
                              form_stall_free)
from .cost_model import LinearCostModel, RecursiveLeastSquares
from .types import BatchPlan, SchedTask, TaskKind


# ---------------------------------------------------------------------------
# the protocol every stack satisfies (what engines/sims/benchmarks consume)
# ---------------------------------------------------------------------------


class Scheduler(Protocol):
    name: str
    model: LinearCostModel

    def schedule(self, now: float, tasks: Sequence[SchedTask]) -> BatchPlan: ...

    def observe(self, total_new_tokens: int, total_context: int,
                measured_time: float) -> None: ...


# ---------------------------------------------------------------------------
# stage protocols
# ---------------------------------------------------------------------------


class AdmissionPolicy(Protocol):
    """Stage 1: choose the tasks eligible for this step (DESIGN.md §13)."""

    def filter(self, now: float,
               tasks: Sequence[SchedTask]) -> Sequence[SchedTask]: ...

    def on_schedule(self, plan: BatchPlan, tasks: Sequence[SchedTask],
                    now: float) -> None: ...

    def debt(self) -> dict: ...


class CapacityPolicy(Protocol):
    """Stage 2: derive the step's (cost model, budget) pair."""

    def shape(self, now: float, tasks: Sequence[SchedTask],
              model: LinearCostModel,
              n_obs: int) -> tuple[LinearCostModel, FormationConfig]: ...


class FormationPolicy(Protocol):
    """Stage 3: pack eligible tasks into a BatchPlan."""

    def form(self, tasks: Sequence[SchedTask], now: float,
             model: LinearCostModel, cfg: FormationConfig) -> BatchPlan: ...


# ---------------------------------------------------------------------------
# admission policies
# ---------------------------------------------------------------------------


class FCFSAdmission:
    """Pass-through admission: every runnable task is eligible every step.

    The pre-stack schedulers behaved exactly like this, so preconfigured
    stacks default to it and stay bit-identical to the monolithic code.
    """

    name = "fcfs"

    def filter(self, now: float,
               tasks: Sequence[SchedTask]) -> Sequence[SchedTask]:
        return tasks

    def on_schedule(self, plan: BatchPlan, tasks: Sequence[SchedTask],
                    now: float) -> None:
        pass

    def debt(self) -> dict:
        return {}


class VTCAdmission:
    """Per-tenant weighted virtual-token-counter fair queuing (DESIGN.md §13).

    Adapted from VTC ("Fairness in Serving Large Language Models", Sheng et
    al. 2024) to the continuous-batching step loop:

    * each tenant carries a virtual counter charged ``input_weight`` per
      granted prefill token and ``output_weight`` per granted decode token,
      divided by the tenant's ``weights`` share (default 1.0 — a tenant with
      weight 2 is charged half, i.e. owed twice the service);
    * decodes always pass — their KV is resident, and holding them back
      wastes pool pages without returning any compute;
    * a tenant's *prefills* are eligible only while its counter is within
      ``burst_tokens / weight`` of the lowest counter among tenants with
      waiting prefills, so a flooding tenant overdrafts its window and then
      queues behind everyone it out-spent;
    * counter lift: a tenant (re)appearing after idling is lifted to the
      current floor, so idle time never banks credit (VTC's no-gaming rule);
    * starvation override: a task the data plane has deferred (out of KV
      pool, ``deferred_age > 0``) is always eligible — admission fairness
      must not compound data-plane starvation (DESIGN.md §13).

    With a single tenant every prefill is within any window of itself, so
    the stage degenerates to FCFS exactly — the bit-identity the stack
    refactor promises.
    """

    name = "vtc"

    def __init__(self, weights: Optional[dict] = None,
                 input_weight: float = 1.0, output_weight: float = 2.0,
                 burst_tokens: int = 1024):
        self.weights = dict(weights or {})
        self.input_weight = input_weight
        self.output_weight = output_weight
        self.burst_tokens = burst_tokens
        self.counters: dict[str, float] = {}
        self._tenant_of: dict[int, str] = {}   # req_id -> tenant (for refund)
        self._last_present: set = set()        # tenants active last step
        # net counter charge per request (signed sum of every _charge),
        # so a brownout shed can return *exactly* what the request cost —
        # billing stays exact under shedding (DESIGN.md §16)
        self._net: dict[int, float] = {}

    def _w(self, tenant: str) -> float:
        return max(self.weights.get(tenant, 1.0), 1e-9)

    def filter(self, now: float,
               tasks: Sequence[SchedTask]) -> Sequence[SchedTask]:
        if len(self._tenant_of) > 8192:
            # the refund map is only needed while a request's plan can
            # still be refunded; every refund (deferral, rollback) fires
            # before the next filter call, so pruning to the live task set
            # here can never misattribute a later refund. (Pruning in
            # on_schedule would drop ids the admission filter held back.)
            live = {t.req_id for t in tasks}
            self._tenant_of = {r: t for r, t in self._tenant_of.items()
                               if r in live}
            self._net = {r: v for r, v in self._net.items() if r in live}
        present = {t.tenant for t in tasks}
        if len(present) <= 1 and not self.counters:
            self._last_present = present
            return tasks                      # single tenant: FCFS exactly
        # counter lift (VTC's no-gaming rule): no credit accrues while
        # idle. Applies to first-seen tenants AND tenants returning after
        # an idle gap — a stale low counter from minutes ago must not buy
        # absolute priority now. Tenants continuously present keep their
        # earned deficit.
        # the lift anchor is the floor among *continuously present* tenants
        # — a returner's own stale counter must not define the floor it is
        # lifted to. After a global idle gap relative counters persist
        # (everyone idled equally).
        anchored = [self.counters[t] for t in present
                    if t in self.counters and t in self._last_present]
        floor_known = min(anchored) if anchored else \
            min((self.counters[t] for t in present if t in self.counters),
                default=0.0)
        for t in present:
            if t not in self.counters:
                self.counters[t] = floor_known
            elif t not in self._last_present:
                self.counters[t] = max(self.counters[t], floor_known)
        self._last_present = present
        waiting = {t.tenant for t in tasks if t.is_prefill}
        if not waiting:
            return tasks
        floor = min(self.counters[t] for t in waiting)
        out = []
        for t in tasks:
            if t.is_decode or t.deferred_age > 0:
                out.append(t)                 # resident / starving: always in
            elif self.counters[t.tenant] <= floor + \
                    self.burst_tokens / self._w(t.tenant):
                out.append(t)
        return out

    def _charge(self, req_id: int, n_tokens: int, kind: TaskKind,
                sign: float) -> None:
        tenant = self._tenant_of.get(req_id, "default")
        rate = (self.input_weight if kind is TaskKind.PREFILL
                else self.output_weight)
        delta = sign * rate * n_tokens / self._w(tenant)
        self.counters[tenant] = self.counters.get(tenant, 0.0) + delta
        self._net[req_id] = self._net.get(req_id, 0.0) + delta

    def on_schedule(self, plan: BatchPlan, tasks: Sequence[SchedTask],
                    now: float) -> None:
        for t in tasks:
            self._tenant_of[t.req_id] = t.tenant
        for it in plan.items:
            self._charge(it.req_id, it.n_tokens, it.kind, 1.0)

    def refund(self, plan: BatchPlan, req_ids) -> None:
        """Reverse the ``on_schedule`` charge for grants that never ran —
        data-plane deferrals (out of KV pool) and pipelined rollbacks.
        Without this, a tenant starved of pages would be billed for the
        same chunk on every retry and the fairness machinery would punish
        the victim of deferral (DESIGN.md §13)."""
        for it in plan.items:
            if it.req_id in req_ids:
                self._charge(it.req_id, it.n_tokens, it.kind, -1.0)

    def charge_extra_decode(self, plan: BatchPlan, req_ids,
                            steps: int) -> None:
        """Bill the extra tokens a committed multi-step decode horizon
        emits beyond the plan's nominal 1-token grants (DESIGN.md §12/§13):
        ``on_schedule`` fires once per dispatch, but an H-step commitment
        serves H tokens per decode item. Negative ``steps`` reverses the
        top-up on rollback."""
        for it in plan.items:
            if it.req_id in req_ids and it.kind is TaskKind.DECODE:
                self._charge(it.req_id, steps, it.kind, 1.0)

    def charge_accepted_tokens(self, plan: BatchPlan, extras) -> None:
        """Bill a speculative dispatch's *accepted* tokens exactly
        (DESIGN.md §18): ``extras[req_id]`` is the token count the run
        emitted beyond the plan's nominal 1-token grant — only verified
        emissions, never rejected drafts (whose compute rides the measured
        step time, priced by ``commit_horizon``'s draft_frac term, not the
        fairness counters). Negative values reverse the top-up on rollback.
        Iterates in plan order, charging each request's whole extra as ONE
        delta — the same float ops as ``charge_extra_decode`` when every
        extra equals ``steps``, which is what keeps committed counters
        byte-equal to a never-speculating run at acceptance 0."""
        for it in plan.items:
            e = extras.get(it.req_id, 0)
            if e and it.kind is TaskKind.DECODE:
                self._charge(it.req_id, e, it.kind, 1.0)

    def refund_request(self, req_id: int) -> None:
        """Return a shed request's *entire* net charge (DESIGN.md §16).

        The brownout stage terminates deadline-infeasible work without
        service; whatever prefill chunks it was already billed for are
        reversed in one shot so the tenant's counter reads as if the
        request never ran — VTC billing stays exact modulo shed work.
        """
        delta = self._net.pop(req_id, 0.0)
        if delta:
            tenant = self._tenant_of.get(req_id, "default")
            self.counters[tenant] = self.counters.get(tenant, 0.0) - delta

    def debt(self) -> dict:
        """Per-tenant fairness debt: counter excess over the floor.

        0 for the least-served tenant; rides LB report ticks so
        ``CacheAwareLB`` can route around ranks where a tenant is already
        deep in overdraft (DESIGN.md §13). Anchored on *currently-present*
        tenants, like the lift in ``filter`` — a long-departed tenant's
        stale low counter must not pin the floor (and inflate every active
        tenant's reported debt) forever; departed tenants are omitted (a
        returner is lifted to the floor anyway, i.e. debt 0).
        """
        if not self.counters:
            return {}
        present = [t for t in self._last_present if t in self.counters]
        if not present:
            present = list(self.counters)
        floor = min(self.counters[t] for t in present)
        return {t: max(0.0, self.counters[t] - floor) for t in present}


# ---------------------------------------------------------------------------
# brownout / overload shedding (DESIGN.md §16)
# ---------------------------------------------------------------------------


class BrownoutPolicy:
    """Graceful-degradation overload shedding (DESIGN.md §16).

    Engaged/disengaged by the cluster's fleet-saturation signal (every
    routable rank's reported PAB under the floor; hysteresis on release).
    While engaged, ``victims`` returns never-served prefill tasks that
    can no longer make their TTFT deadline *even if served alone right
    now* — work that will burn tokens only to miss its SLO and crowd out
    requests that could still make theirs ("Optimal Scheduling Algorithms
    for LLM Inference": under overload, serving doomed work is strictly
    worse than shedding it). Requests that already emitted a token are
    never shed — cutting a live stream is worse UX than a slow finish.

    Victim selection is per-tenant fair: round-robin one victim per
    tenant, tenants ordered by VTC debt (deepest overdraft first), capped
    at ``max_shed_per_step``. The engine refunds each victim's admission
    charges (``refund_request``) so billing stays exact.
    """

    def __init__(self, grace: float = 0.0, max_shed_per_step: int = 2):
        self.grace = grace
        self.max_shed_per_step = max_shed_per_step
        self.engaged = False
        self.shed_count = 0

    def set_engaged(self, engaged: bool) -> None:
        self.engaged = engaged

    def victims(self, now: float, tasks: Sequence[SchedTask],
                model: LinearCostModel, debt: dict) -> list[int]:
        if not self.engaged:
            return []
        doomed = []
        for t in tasks:
            if not t.is_prefill or t.next_output_idx > 0:
                continue
            eta = now + model.step_time(t.new_tokens, t.cost_context())
            if eta > t.arrival + t.ttft_slo + self.grace:
                doomed.append(t)
        if not doomed:
            return []
        by_tenant: dict[str, list[SchedTask]] = {}
        for t in doomed:
            by_tenant.setdefault(t.tenant, []).append(t)
        for ts in by_tenant.values():
            # most-overdue first within a tenant (deterministic tiebreak)
            ts.sort(key=lambda t: (t.arrival + t.ttft_slo, t.req_id))
        queues = [by_tenant[t] for t in
                  sorted(by_tenant, key=lambda t: (-debt.get(t, 0.0), t))]
        out: list[int] = []
        while len(out) < self.max_shed_per_step:
            progressed = False
            for q in queues:
                if q and len(out) < self.max_shed_per_step:
                    out.append(q.pop(0).req_id)
                    progressed = True
            if not progressed:
                break
        self.shed_count += len(out)
        return out


# ---------------------------------------------------------------------------
# capacity policies (paper §3.2 and the Fig-7 ablation ladder)
# ---------------------------------------------------------------------------


class _ColdStart:
    """Shared cold-start handling: until the online calibration has seen
    ``warmup_obs`` steps, pack extra conservatively (safety is scaled by
    ``cold_start_safety``) — the offline model can't be trusted near
    deadlines on unprofiled hardware."""

    def __init__(self, base: Optional[FormationConfig] = None,
                 cold_start_safety: float = 0.7, warmup_obs: int = 32):
        self.base = base or FormationConfig()
        self.cold_start_safety = cold_start_safety
        self.warmup_obs = warmup_obs

    def apply(self, cfg: FormationConfig, n_obs: int) -> FormationConfig:
        if 0 <= n_obs < self.warmup_obs:
            return dataclasses.replace(
                cfg, safety=cfg.safety * self.cold_start_safety)
        return cfg


class AdaptiveTimeCapacity(_ColdStart):
    """FB-vanilla (paper §3.2): the adaptive time budget from decode slack
    is derived inside ``form_batch``; this stage only applies cold-start
    conservatism and passes the calibrated model through."""

    def shape(self, now: float, tasks: Sequence[SchedTask],
              model: LinearCostModel,
              n_obs: int) -> tuple[LinearCostModel, FormationConfig]:
        return model, self.apply(self.base, n_obs)


class TokenBudgetCapacity(_ColdStart):
    """FB-TokenBudget ablation: slack is converted to a *token* budget
    through the token-only model — context is ignored when sizing the
    batch, reproducing FB-TB's mis-estimation under long contexts (paper
    Fig 7 step 4)."""

    def shape(self, now: float, tasks: Sequence[SchedTask],
              model: LinearCostModel,
              n_obs: int) -> tuple[LinearCostModel, FormationConfig]:
        cfg = self.apply(self.base, n_obs)
        t_budget = capacity.init_time_budget(tasks, now, cfg.max_time_budget)
        tok = model.tokens_within(t_budget) if math.isfinite(t_budget) \
            else cfg.max_token_budget
        cfg = dataclasses.replace(
            cfg, max_token_budget=max(1, min(tok, cfg.max_token_budget)))
        return LinearCostModel(a=model.a, b=model.b, c=0.0), cfg


class FixedBatchCapacity(_ColdStart):
    """FB-FixBatch ablation: Sarathi-style fixed token budget; the time
    budget is pinned so only tokens bind and only the 3-group formation of
    §3.3 is active."""

    def __init__(self, token_budget: int = 512,
                 base: Optional[FormationConfig] = None,
                 cold_start_safety: float = 0.7, warmup_obs: int = 32):
        super().__init__(base, cold_start_safety, warmup_obs)
        self.token_budget = token_budget

    def shape(self, now: float, tasks: Sequence[SchedTask],
              model: LinearCostModel,
              n_obs: int) -> tuple[LinearCostModel, FormationConfig]:
        cfg = self.apply(self.base, n_obs)
        cfg = dataclasses.replace(cfg, max_token_budget=self.token_budget,
                                  max_time_budget=model.step_time(
                                      self.token_budget, 0))
        return model, cfg


class UncappedCapacity:
    """Baselines (Sarathi / vLLM-vanilla) bound their own token budgets in
    the formation stage; capacity passes the model through untouched."""

    def shape(self, now: float, tasks: Sequence[SchedTask],
              model: LinearCostModel,
              n_obs: int) -> tuple[LinearCostModel, FormationConfig]:
        return model, FormationConfig()


# ---------------------------------------------------------------------------
# formation policies (thin stage adapters over core.batch_formation)
# ---------------------------------------------------------------------------


class FairFormation:
    """Paper Algorithm 1 (§3.3): 3-group slack-sorted packing."""

    def form(self, tasks: Sequence[SchedTask], now: float,
             model: LinearCostModel, cfg: FormationConfig) -> BatchPlan:
        return form_batch(tasks, now, model, cfg)


@dataclasses.dataclass
class StallFreeFormation:
    """Sarathi: every decode in every batch, leftovers to chunked prefill."""

    token_budget: int = 512

    def form(self, tasks: Sequence[SchedTask], now: float,
             model: LinearCostModel, cfg: FormationConfig) -> BatchPlan:
        return form_stall_free(tasks, now, model, self.token_budget)


@dataclasses.dataclass
class PrefillFirstFormation:
    """vLLM-vanilla: whole prompts FCFS first, decodes fill the rest."""

    max_num_batched_tokens: int = 8192

    def form(self, tasks: Sequence[SchedTask], now: float,
             model: LinearCostModel, cfg: FormationConfig) -> BatchPlan:
        return form_prefill_first(tasks, now, model,
                                  self.max_num_batched_tokens)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


class SchedulerStack:
    """A scheduler assembled from one policy per stage (DESIGN.md §13).

    Implements the same ``Scheduler`` protocol the monolithic classes did
    (``schedule``/``observe``/``model``/``name``) plus shared online
    calibration (paper §3.2, 'continuously calibrated'), so engines, the
    event-driven sim, the cluster, and every benchmark can swap stacks
    freely — including mid-experiment reconfiguration of a single stage.
    """

    def __init__(self, name: str, model: LinearCostModel,
                 admission: Optional[AdmissionPolicy] = None,
                 capacity_policy: Optional[CapacityPolicy] = None,
                 formation: Optional[FormationPolicy] = None,
                 calibrate: bool = True):
        self.name = name
        self.model = model
        self.admission = admission or FCFSAdmission()
        self.capacity_policy = capacity_policy or UncappedCapacity()
        self.formation_policy = formation or FairFormation()
        # optional brownout stage (DESIGN.md §16); attached by
        # make_scheduler(brownout=True) or assigned directly
        self.brownout: Optional[BrownoutPolicy] = None
        self._rls: Optional[RecursiveLeastSquares] = None
        if calibrate:
            self._rls = RecursiveLeastSquares(theta0=(model.a, model.b,
                                                      model.c))

    @property
    def n_obs(self) -> int:
        """Calibration observations so far; -1 when calibration is off
        (cold-start conservatism only applies to calibrating stacks)."""
        return self._rls.n_obs if self._rls is not None else -1

    def observe(self, total_new_tokens: int, total_context: int,
                measured_time: float) -> None:
        if self._rls is None or total_new_tokens <= 0:
            return
        self._rls.update(total_new_tokens, total_context, measured_time)
        if self._rls.n_obs >= 32:          # warmup before trusting online fit
            self.model = self._rls.model()

    def schedule(self, now: float, tasks: Sequence[SchedTask]) -> BatchPlan:
        eligible = self.admission.filter(now, tasks)
        model, cfg = self.capacity_policy.shape(now, eligible, self.model,
                                                self.n_obs)
        plan = self.formation_policy.form(eligible, now, model, cfg)
        self.admission.on_schedule(plan, eligible, now)
        return plan

    def probe(self, now: float, tasks: Sequence[SchedTask]) -> BatchPlan:
        """Side-effect-free schedule preview: the plan ``schedule`` would
        form, without charging the admission stage. The engine's
        commit-horizon oracle (DESIGN.md §12) and the speculative-round sim
        oracle (§18) probe per internal step/round to ask what lock-step
        would form next; billing those probes would double-charge tenants
        for tokens the horizon/accepted-token top-ups already cover.
        Skips the admission filter — sound for the all-decode task sets the
        horizon probe passes (no shipped admission stage ever excludes a
        decode), but a custom decode-filtering admission policy would need
        a filtering probe."""
        model, cfg = self.capacity_policy.shape(now, tasks, self.model,
                                                self.n_obs)
        return self.formation_policy.form(tasks, now, model, cfg)

    def refund(self, plan: BatchPlan, req_ids) -> None:
        """Reverse admission charges for grants that never executed
        (deferred items, rolled-back speculative dispatches). No-op for
        admission stages without counters (FCFS)."""
        fn = getattr(self.admission, "refund", None)
        if fn is not None and req_ids:
            fn(plan, req_ids)

    def charge_extra_decode(self, plan: BatchPlan, req_ids,
                            steps: int) -> None:
        """Bill (or, with negative ``steps``, reverse) the extra decode
        tokens of a committed multi-step horizon. No-op for admission
        stages without counters (FCFS)."""
        fn = getattr(self.admission, "charge_extra_decode", None)
        if fn is not None and req_ids and steps:
            fn(plan, req_ids, steps)

    def charge_accepted_tokens(self, plan: BatchPlan, extras) -> None:
        """Bill (or, negative, reverse) the accepted tokens a speculative
        dispatch emitted beyond the nominal grants (DESIGN.md §18). No-op
        for admission stages without counters (FCFS)."""
        fn = getattr(self.admission, "charge_accepted_tokens", None)
        if fn is not None and extras:
            fn(plan, extras)

    def tenant_debt(self) -> dict:
        """Per-tenant fairness debt from the admission stage ({} for FCFS);
        rides the LB report ticks (DESIGN.md §13)."""
        return self.admission.debt()

    # ------------------------------------------------ brownout (§16)

    def set_brownout(self, engaged: bool) -> None:
        """Fleet-saturation broadcast from the cluster health tick."""
        if self.brownout is not None:
            self.brownout.set_engaged(engaged)

    def poll_shed(self, now: float, tasks: Sequence[SchedTask]) -> list[int]:
        """Req-ids the brownout stage wants terminated this step ([] when
        no brownout stage is attached or the fleet is not saturated)."""
        if self.brownout is None or not self.brownout.engaged:
            return []
        return self.brownout.victims(now, tasks, self.model,
                                     self.tenant_debt())

    def refund_request(self, req_id: int) -> None:
        """Return a shed request's entire net admission charge (exact
        VTC billing under shedding — no-op for FCFS admission)."""
        fn = getattr(self.admission, "refund_request", None)
        if fn is not None:
            fn(req_id)
