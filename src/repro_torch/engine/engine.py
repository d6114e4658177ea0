"""Continuous-batching inference engine with an async pipelined control plane.

The paper's control loop: each step, build SchedTask views of every active
request, ask the scheduler (FairBatching / Sarathi / vLLM-vanilla) for a
BatchPlan, execute it (simulated or real), advance request progress at step
end, and feed the measured step time back into the scheduler's online
cost-model calibration (§3.2).

Steps are split into two phases so the engine can be driven either lock-step
(``step()``/``run()``) or by the discrete-event simulator (DESIGN.md §8):
``begin_step()`` forms and launches a batch, returning the in-flight step;
``complete_step()`` applies its effects at the completion timestamp.

Beyond the lock-step loop the engine runs an *asynchronous pipelined control
plane* (DESIGN.md §12): with ``pipeline_depth >= 2``, ``begin_step`` may be
called while earlier steps are still in flight — batch N+1 is formed against
*projected* post-step state (speculative prefilled/generated advances,
predicted completions, reserved KV pages) so the host's scheduling work
overlaps device execution instead of landing on TBT. ``complete_step``
reconciles projections against actual outcomes and rolls back any queued
step whose speculation diverged. Orthogonally, ``commit_horizon`` steps of
pure decode can be committed as ONE dispatch (slack-bounded multi-step
decode, ``core.capacity.commit_horizon``); every internal step still gets
its own StepRecord/observation so SLO accounting stays bit-identical to
lock-step.

Cluster integration (§3.4): ``pab()`` exposes the Prefill Admission Budget;
``snapshot()/restore()`` round-trip the host-side engine state for fault
tolerance (KV is recomputed via prefix re-prefill on restore — DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from ..core import capacity, slo
from ..core.cost_model import LinearCostModel
from ..core.pab import PABAdmissionController, prefill_admission_budget
from ..core.schedulers import Scheduler
from ..core.types import BatchPlan, TaskKind
from .metrics import RequestMetrics, measure
from .request import Request, RequestState
from .spec_decode import AcceptanceEWMA


@dataclasses.dataclass
class EngineConfig:
    ttft_slo: float = 0.5
    tpot_slo: float = 0.05
    idle_step: float = 0.002        # clock hop when nothing is runnable
    max_steps: int = 2_000_000
    # -- async control plane (DESIGN.md §12) ---------------------------
    # max steps in flight at once; 1 = the classic synchronous engine,
    # >=2 = batch N+1 is formed against projected state while N runs
    pipeline_depth: int = 1
    # host-side cost of forming + dispatching one batch (seconds). The
    # sequential engine pays it as a bubble between steps; the pipelined
    # engine hides it under the previous step's device time.
    host_overhead: float = 0.0
    # max decode steps committed as ONE dispatch; the actual horizon is the
    # slack-bounded capacity.commit_horizon(), never this cap alone
    commit_horizon: int = 1
    # PAB-style reserve for the horizon guard: a prompt of this many tokens
    # arriving right after a multi-step dispatch must still make its TTFT
    # SLO. 0 disables the reserve (envelopes alone bound the horizon).
    predicted_prefill_tokens: int = 0
    # tensor-parallel degree the data plane runs at (DESIGN.md §17): the
    # horizon guard prices committed steps with the per-shard cost model
    # (marginal coefficients / cost_shards). 1 = single-device budgets.
    cost_shards: int = 1
    # -- speculative decode (DESIGN.md §18) ----------------------------
    # draft γ candidate tokens per sequence per committed round and verify
    # them in one target pass; 0 disables speculation. Real executors need
    # set_draft() installed; sim executors model acceptance stochastically.
    speculate: int = 0
    # draft-pass cost as a fraction of a target-pass token, for the horizon
    # guard's round pricing (self-speculative ≈ draft layers / total layers)
    spec_draft_frac: float = 0.15
    # cold-start acceptance the EWMA floors at; 0.0 = fully pessimistic
    # (speculative rounds earn no extra emission allowance until measured)
    spec_floor: float = 0.0
    # -- preemption & aged requeue (DESIGN.md §13) ---------------------
    # evict a running request's KV pages (refcount/COW-aware) to unblock
    # starving deferred work; the victim re-prefills its known prefix on
    # resume. False reproduces the defer-and-retry engine bit for bit.
    preemption: bool = False
    # deferral age (seconds) after which a deferred item counts as starving:
    # fresh prefills are held back so freed pages reach it, and (with
    # preemption on) a victim is evicted on the next completed step
    defer_age: float = 0.05


@dataclasses.dataclass
class StepRecord:
    t_start: float
    t_end: float
    new_tokens: int
    context: int
    n_prefill: int
    n_decode: int
    predicted: float


@dataclasses.dataclass(frozen=True)
class InternalStep:
    """One scheduler-step worth of work inside a dispatch (DESIGN.md §12).

    A single-step dispatch has exactly one; a committed decode horizon of H
    has H — each with its own duration, executed-token/context totals (for
    the §3.2 observation) and the tokens it emits.
    """
    dt: float
    new_tokens: int               # executed tokens (deferred items excluded)
    context: int                  # cost-context total at this internal step
    predicted: float
    emitted: dict                 # req_id -> output token id (real mode)


@dataclasses.dataclass
class InflightStep:
    """A launched-but-uncompleted dispatch (between begin and complete)."""
    plan: BatchPlan
    t_start: float
    t_form: float                 # host time the batch was formed
    internal: tuple               # tuple[InternalStep, ...]; len == horizon
    # req_ids the executor could not serve this dispatch (out of KV blocks):
    # their progress is NOT advanced, so the scheduler retries them
    deferred: frozenset = frozenset()
    # scheduler.observe already applied at begin time (async forming keeps
    # the calibration in lock-step order even before completion)
    observed: bool = False
    # speculative dispatch (DESIGN.md §18): req_id -> total tokens the run
    # emitted (accepted drafts + verified fallbacks). None = not speculative.
    # Internal steps then carry per-round token LISTS in ``emitted``.
    spec: Optional[dict] = None

    @property
    def horizon(self) -> int:
        return len(self.internal)

    @property
    def exec_time(self) -> float:
        return sum(s.dt for s in self.internal)

    @property
    def t_end(self) -> float:
        # accumulate exactly like the per-internal-step application loops
        # do (t += dt, left to right): the dispatch boundary must land on
        # the same float as the last internal step's finish time, or a
        # 1-ulp drift would break bit-parity with the lock-step engine
        t = self.t_start
        for s in self.internal:
            t += s.dt
        return t


class Engine:
    def __init__(self, scheduler: Scheduler, executor, cfg: EngineConfig,
                 admission: Optional[PABAdmissionController] = None,
                 rank: int = 0, prefix_cache=None):
        self.sched = scheduler
        self.executor = executor
        self.cfg = cfg
        self.admission = admission
        self.rank = rank
        # Optional repro_torch.cache.PrefixCache (DESIGN.md §10). Real executors
        # share their BlockAllocator with it; sim engines give it a virtual
        # allocator. None (or capacity 0) reproduces cache-less behaviour
        # bit for bit.
        self.prefix_cache = prefix_cache
        self.now = 0.0
        self.requests: dict[int, Request] = {}
        self.pending: list[Request] = []       # submitted, arrival in future
        self.active: list[int] = []
        self.done: list[RequestMetrics] = []
        self.steps: list[StepRecord] = []
        self.busy_time = 0.0
        # launched-but-uncompleted dispatches, oldest first (DESIGN.md §12);
        # depth 1 makes this the old single InflightStep slot
        self.inflight_q: list[InflightStep] = []
        self._stalled_steps = 0     # consecutive fully-deferred dispatches
        # control-plane accounting (DESIGN.md §12): device dispatches,
        # host-side form/dispatch time, speculation rollbacks
        self.n_dispatches = 0
        self.host_time = 0.0
        self.rollbacks = 0
        # earliest arrival the *driver* knows about that has not reached
        # ``pending`` yet (the event-driven replay routes arrivals at their
        # event time, so mid-commitment the engine would otherwise be blind
        # to them — lock-step submits everything upfront). Multi-step
        # commitment must stop at the next arrival exactly like lock-step
        # re-forming would, so the replay loop keeps this fresh (§12).
        self.arrival_hint: float = float("inf")
        # O(1) running aggregate for the LB report tick (DESIGN.md §12)
        self._delay_sum = 0.0
        self._delay_n = 0
        # deferral registry (DESIGN.md §13): req_id -> sim time of its first
        # un-served deferral. Entries age into starvation (>= cfg.defer_age)
        # which holds back fresh prefills and, with preemption on, evicts a
        # victim; cleared the moment the request executes or finishes.
        self.deferred_since: dict[int, float] = {}
        self.preemptions = 0
        self.defer_events = 0       # total item-deferrals observed (§13)
        self.sheds = 0              # brownout terminations (DESIGN.md §16)
        # pessimistic acceptance estimator the horizon guard prices
        # speculative rounds with (DESIGN.md §18)
        self._spec_ewma = AcceptanceEWMA(cfg.spec_floor)
        self.spec_rounds = 0        # speculative rounds committed
        self.spec_accepted = 0      # drafts accepted across all rounds
        self.spec_drafted = 0       # drafts proposed across all rounds

    @property
    def inflight(self) -> Optional[InflightStep]:
        """Oldest in-flight dispatch (None when the pipeline is empty)."""
        return self.inflight_q[0] if self.inflight_q else None

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.pending.append(req)
        self.pending.sort(key=lambda r: r.arrival)

    def _admit_arrivals(self) -> None:
        while self.pending and self.pending[0].arrival <= self.now:
            req = self.pending.pop(0)
            self.requests[req.req_id] = req
            if self.prefix_cache is not None and req.tokens:
                # split the prompt into cached + new *before* admission so
                # PAB charges only the effective (uncached) tokens
                cached = self.prefix_cache.begin_request(
                    req.req_id, req.tokens, self.now)
                if cached:
                    req.cached_context = cached
                    req.prefilled = cached
            if self.admission is not None:
                # admission sees *projected* load: with steps in flight the
                # committed Request state understates what the node owes
                tasks = self._projected_tasks()
                if not self.admission.admit(req.prompt_len, tasks, self.now,
                                            self.sched.model,
                                            ttft_slo=req.ttft_slo,
                                            tpot_slo=req.tpot_slo,
                                            cached_tokens=req.cached_context):
                    req.state = RequestState.REJECTED
                    if self.prefix_cache is not None and req.tokens:
                        self.prefix_cache.abort_request(req.req_id)
                    self._record_done(req)
                    continue
            self.active.append(req.req_id)

    def pab(self) -> float:
        tasks = [self.requests[i].to_sched_task() for i in self.active]
        return prefill_admission_budget(tasks, self.now, self.sched.model,
                                        self.cfg.ttft_slo, self.cfg.tpot_slo)

    @property
    def has_work(self) -> bool:
        return bool(self.active or self.pending or self.inflight_q)

    def host_stats(self) -> dict:
        """Control-plane counters for metrics / LB reports (DESIGN.md §12)."""
        return {"dispatches": self.n_dispatches,
                "host_overhead_s": self.host_time,
                "engine_steps": len(self.steps),
                "rollbacks": self.rollbacks,
                "preemptions": self.preemptions,
                "sheds": self.sheds}

    def tenant_debt(self) -> dict:
        """Per-tenant fairness debt from the scheduler stack's admission
        stage ({} for FCFS stacks); rides LB report ticks (DESIGN.md §13)."""
        fn = getattr(self.sched, "tenant_debt", None)
        return fn() if fn is not None else {}

    def sched_delay_mean(self) -> float:
        """Mean arrival→first-service delay over finished requests, O(1)."""
        return self._delay_sum / self._delay_n if self._delay_n else 0.0

    def _record_done(self, req: Request) -> None:
        m = measure(req)
        if m.sched_delay is not None:
            self._delay_sum += m.sched_delay
            self._delay_n += 1
        self.done.append(m)

    # ------------------------------------------------------------------
    # speculative projection (DESIGN.md §12): the state the world will be
    # in once every in-flight dispatch lands as launched
    # ------------------------------------------------------------------

    def _projected_requests(self) -> tuple[dict, list[int]]:
        """(requests-view, active-ids) with every in-flight dispatch applied.

        With an empty pipeline this is the committed state itself (no
        copies). Otherwise active requests are speculatively advanced by
        each in-flight plan's non-deferred grants — including predicted
        completions, which leave the projected active set.
        """
        if not self.inflight_q:
            return self.requests, list(self.active)
        proj = {rid: self.requests[rid].speculative_copy()
                for rid in self.active}
        active = list(self.active)
        for inf in self.inflight_q:
            t = inf.t_start
            for k, ist in enumerate(inf.internal):
                t += ist.dt
                for it in inf.plan.items:
                    if it.req_id in inf.deferred or it.req_id not in proj:
                        continue
                    if k > 0 and it.kind is TaskKind.PREFILL:
                        continue      # horizons >1 are pure decode
                    req = proj[it.req_id]
                    if req.state is RequestState.FINISHED:
                        continue
                    tok = ist.emitted.get(it.req_id)
                    if isinstance(tok, list):
                        # speculative round (§18): a per-round accepted run;
                        # an empty list is a capped round (no progress)
                        if tok:
                            req.generated_tokens.extend(
                                x for x in tok if x is not None)
                            req.advance(len(tok), t)
                    else:
                        if tok is not None:
                            req.generated_tokens.append(tok)
                        req.advance(it.n_tokens if k == 0 else 1, t)
                    if req.state is RequestState.FINISHED:
                        active.remove(it.req_id)   # predicted completion
        return proj, active

    def _projected_tasks(self) -> list:
        proj, active = self._projected_requests()
        return [proj[i].to_sched_task() for i in active]

    # ------------------------------------------------------------------
    # two-phase step: begin (form + launch) / complete (apply at t_end)
    # ------------------------------------------------------------------

    def begin_step(self, now: Optional[float] = None) -> Optional[InflightStep]:
        """Admit arrivals, form a batch, and launch it.

        Returns the in-flight dispatch (None if nothing is runnable). The
        caller owns the clock: effects apply when it calls
        ``complete_step()``. With an empty pipeline the launch happens at
        ``self.now + host_overhead``; with steps in flight (depth >= 2) the
        plan is formed against *projected* state and the launch lands
        back-to-back at the previous dispatch's completion — the host
        overhead is hidden under device time (DESIGN.md §12). The
        event-driven simulator schedules completion as a STEP_DONE event
        and forming as a STEP_FORM event; ``step()`` below stays lock-step.
        """
        depth = max(self.cfg.pipeline_depth, 1)
        assert len(self.inflight_q) < depth, "pipeline full"
        if now is not None:
            self.now = max(self.now, now)
        self._admit_arrivals()
        self._poll_brownout_sheds()
        proj, active_proj = self._projected_requests()
        if not active_proj:
            return None
        t_form = self.now
        t_launch = t_form + self.cfg.host_overhead
        if self.inflight_q:
            t_launch = max(t_launch, self.inflight_q[-1].t_end)
        tasks = self._stamp_deferred(
            [proj[i].to_sched_task() for i in active_proj], t_launch)
        plan = self.sched.schedule(t_launch, tasks)
        if not plan.items:
            return None

        gamma = self._spec_gamma(plan, active_proj)
        horizon = self._plan_horizon(plan, tasks, active_proj, proj, t_launch,
                                     gamma)
        spec_extras = None
        if gamma > 0 and hasattr(self.executor, "execute_multi"):
            internal, deferred, spec_extras = self._execute_spec(
                plan, proj, t_launch, horizon, gamma)
        elif gamma > 0:
            internal, deferred, spec_extras = self._run_spec_sim(
                plan, proj, t_launch, horizon, gamma)
        elif horizon > 1 and hasattr(self.executor, "execute_multi"):
            internal, deferred = self._execute_multi(plan, proj, t_launch,
                                                     horizon)
        elif horizon > 1:
            internal, deferred = self._run_horizon_sim(plan, proj, t_launch,
                                                       horizon)
        else:
            internal, deferred = self._execute_single(plan, proj, tasks,
                                                      t_launch)

        if deferred:
            # admission-stage credit for grants the data plane could not
            # place (DESIGN.md §13): the retry will re-charge them
            refund = getattr(self.sched, "refund", None)
            if refund is not None:
                refund(plan, deferred)
        if spec_extras is not None:
            # VTC bills ACCEPTED tokens exactly (DESIGN.md §18): top up each
            # request by its emissions beyond the plan's 1-token grant.
            # Rejected drafts bill nothing here — their compute rides the
            # measured step times the calibration observes.
            top_up = getattr(self.sched, "charge_accepted_tokens", None)
            if top_up is not None:
                top_up(plan, {rid: e - 1 for rid, e in spec_extras.items()
                              if rid not in deferred and e > 1})
        elif len(internal) > 1:
            # a committed horizon serves len(internal) tokens per decode
            # item but on_schedule billed only the plan's 1-token grants —
            # top up the admission counters (DESIGN.md §13)
            top_up = getattr(self.sched, "charge_extra_decode", None)
            if top_up is not None:
                top_up(plan, {it.req_id for it in plan.items
                              if it.req_id not in deferred},
                       len(internal) - 1)

        observed = ((horizon > 1 or gamma > 0)
                    and not hasattr(self.executor, "execute_multi"))
        if depth > 1 and not observed:
            # async forming: feed the calibration now so the next plan —
            # formed before this dispatch completes — sees the same model
            # state the lock-step engine would (DESIGN.md §12)
            for ist in internal:
                self.sched.observe(ist.new_tokens, ist.context, ist.dt)
            observed = True

        for it in plan.items:
            if it.req_id not in deferred:
                req = self.requests[it.req_id]
                if req.first_scheduled is None:
                    req.first_scheduled = t_launch
        self.n_dispatches += 1
        self.host_time += self.cfg.host_overhead
        inf = InflightStep(plan, t_launch, t_form, tuple(internal), deferred,
                           observed, spec=spec_extras)
        self.inflight_q.append(inf)
        return inf

    def _spec_gamma(self, plan: BatchPlan, active_proj) -> int:
        """γ for this plan: ``cfg.speculate`` when the batch is a pure
        all-active decode batch and the executor can speculate (a draft
        adapter installed, or the sim's stochastic acceptance model); 0
        otherwise — prefill-bearing and partial batches run the classic
        paths (DESIGN.md §18)."""
        g = self.cfg.speculate
        if g <= 0:
            return 0
        ids = {it.req_id for it in plan.items}
        if (any(it.kind is not TaskKind.DECODE for it in plan.items)
                or ids != set(active_proj)):
            return 0
        if hasattr(self.executor, "execute_multi"):
            return g if getattr(self.executor, "draft", None) is not None \
                else 0
        return g if hasattr(self.executor, "execute_spec") else 0

    def _stamp_deferred(self, tasks: list, now: float) -> list:
        """Age deferred tasks; hold back fresh prefills once one starves.

        The silent-starvation fix (DESIGN.md §13): a request the data plane
        deferred (out of KV pool) used to retry forever while every page
        another request freed was snapped up by fresh prefill arrivals. Each
        task now carries its ``deferred_age``, and once any deferral is older
        than ``cfg.defer_age`` the never-served prefills are withheld from
        the scheduler — freed pages reach the starving request first.
        Partially-served prefills stay eligible: they already pin pages, and
        pausing them would only delay the release the starver is waiting on.
        A preemption victim's re-prefill is also withheld while anyone
        starves: its slack-anchored arrival would otherwise outrank the very
        request it yielded its pages to, re-stealing them in a thrash loop.
        """
        if not self.deferred_since:
            return tasks
        starving = False
        for t in tasks:
            since = self.deferred_since.get(t.req_id)
            if since is not None:
                t.deferred_age = max(0.0, now - since)
                starving = starving or t.deferred_age >= self.cfg.defer_age
        if not starving:
            return tasks

        def held(t) -> bool:
            if not t.is_prefill or t.req_id in self.deferred_since:
                return False
            req = self.requests[t.req_id]
            return req.first_scheduled is None or req.preemptions > 0
        return [t for t in tasks if not held(t)]

    def _plan_horizon(self, plan: BatchPlan, tasks, active_proj, proj,
                      t_launch: float, gamma: int = 0) -> int:
        """Slack-bounded decode commitment depth for this plan (§12).

        With ``gamma > 0`` the returned depth counts speculative ROUNDS:
        ``commit_horizon`` prices each round at γ+1 verify tokens plus the
        draft fraction and grows the per-round emission allowance by the
        pessimistic EWMA acceptance estimate (§18) — a single round
        (depth 1) is still a speculative dispatch.
        """
        if self.cfg.commit_horizon <= 1 and gamma == 0:
            return 1
        ids = {it.req_id for it in plan.items}
        if (any(it.kind is not TaskKind.DECODE for it in plan.items)
                or ids != set(active_proj)):
            return 1      # only an all-active pure-decode batch repeats
        # real data plane: bound the commitment by the KV page pool too —
        # a multi-step dispatch cannot defer mid-run, so the horizon must
        # not outrun free pages (capacity at the quantized-KV page budget,
        # DESIGN.md §14)
        alloc = getattr(self.executor, "alloc", None)
        h = capacity.commit_horizon(
            tasks, t_launch, self.sched.model,
            max_horizon=max(self.cfg.commit_horizon, 1),
            ttft_slo=self.cfg.ttft_slo,
            predicted_prefill_tokens=self.cfg.predicted_prefill_tokens,
            free_pages=None if alloc is None else alloc.free_blocks,
            page_size=0 if alloc is None else alloc.block_size,
            n_shards=self.cfg.cost_shards,
            speculate=gamma,
            acceptance=self._spec_ewma.value if gamma else 0.0,
            draft_frac=self.cfg.spec_draft_frac if gamma else 0.0)
        # nobody may finish mid-horizon: a completion changes the batch.
        # (Speculative rounds emit >= 1 token each, so this also guarantees
        # a run at acceptance 0 never clamps — counter parity with the
        # never-speculating engine, §18; higher acceptance finishes are
        # capped in-loop by the executor's max_emit budget.)
        h = min(h, min(proj[i].max_new_tokens - proj[i].generated
                       for i in ids))
        if h > 1 and hasattr(self.executor, "execute_multi"):
            # real data plane: the dispatch is indivisible, so pre-trim at
            # the next known arrival using *predicted* step times (the sim
            # path trims exactly, step by step, inside _run_horizon_sim)
            nxt = min(self.pending[0].arrival if self.pending else
                      float("inf"), self.arrival_hint)
            if nxt < float("inf"):
                n = len(ids)
                slots = gamma + 1
                per_round = n * slots
                ctx0 = sum(t.cost_context() for t in tasks)
                cum, fit = 0.0, 0
                while fit < h:
                    cum += self.sched.model.step_time(
                        per_round, ctx0 + fit * per_round)
                    if t_launch + cum > nxt:
                        break
                    fit += 1
                h = min(h, max(fit, 1))
        return max(h, 1)

    def _execute_single(self, plan: BatchPlan, proj, tasks,
                        t_launch: float) -> tuple[list, frozenset]:
        exec_time, emitted = self.executor.execute(plan, proj, t_launch)
        deferred = frozenset(getattr(self.executor, "last_deferred", ()))
        task_of = {t.req_id: t for t in tasks}
        nt = sum(it.n_tokens for it in plan.items
                 if it.req_id not in deferred)
        ctx = sum(task_of[it.req_id].cost_context()
                  for it in plan.items if it.req_id not in deferred)
        return [InternalStep(exec_time, nt, ctx, plan.predicted_time,
                             dict(emitted))], deferred

    def _run_horizon_sim(self, plan: BatchPlan, proj, t_launch: float,
                         horizon: int) -> tuple[list, frozenset]:
        """Commit up to ``horizon`` decode steps against the sim executor.

        The sim is the oracle world model, so divergence is detectable at
        internal-step granularity: after each committed step the engine
        re-checks what lock-step would have done next (an arrival landing,
        or the scheduler re-forming a different batch) and truncates the
        horizon there. That is what pins the parity suite bit-for-bit: the
        committed run IS the lock-step run, minus the per-step host
        dispatches (``n_dispatches`` counts 1 for the whole run).
        """
        order = [it.req_id for it in plan.items]
        local = {rid: proj[rid].speculative_copy() for rid in order}
        internal: list[InternalStep] = []
        cur = plan
        t = t_launch
        for k in range(horizon):
            dt, emitted = self.executor.execute(cur, local, t)
            nt = cur.total_new_tokens
            ctx = sum(local[it.req_id].to_sched_task().cost_context()
                      for it in cur.items)
            internal.append(InternalStep(dt, nt, ctx, cur.predicted_time,
                                         dict(emitted)))
            self.sched.observe(nt, ctx, dt)
            t += dt
            for it in cur.items:
                tok = emitted.get(it.req_id)
                if tok is not None:
                    local[it.req_id].generated_tokens.append(tok)
                local[it.req_id].advance(1, t)
            if k == horizon - 1:
                break
            if ((self.pending and self.pending[0].arrival <= t)
                    or self.arrival_hint <= t):
                break                 # lock-step would admit it next step
            # side-effect-free preview: billing a probe would double-charge
            # the admission stage on top of charge_extra_decode (§13)
            probe = getattr(self.sched, "probe", self.sched.schedule)
            nxt = probe(t, [local[r].to_sched_task() for r in order])
            if ({it.req_id for it in nxt.items} != set(order)
                    or any(it.kind is not TaskKind.DECODE or it.n_tokens != 1
                           for it in nxt.items)):
                break                 # scheduler would re-form the batch
            cur = nxt
        return internal, frozenset()

    def _execute_multi(self, plan: BatchPlan, proj, t_launch: float,
                       horizon: int) -> tuple[list, frozenset]:
        """Real data plane: ONE device dispatch for the whole horizon."""
        steps, emitted_seq = self.executor.execute_multi(plan, proj,
                                                         t_launch, horizon)
        deferred = frozenset(getattr(self.executor, "last_deferred", ()))
        internal = [InternalStep(dt, nt, ctx, plan.predicted_time,
                                 {rid: toks[k]
                                  for rid, toks in emitted_seq.items()
                                  if k < len(toks)})
                    for k, (dt, nt, ctx) in enumerate(steps)]
        return internal, deferred

    def _execute_spec(self, plan: BatchPlan, proj, t_launch: float,
                      rounds: int, gamma: int) -> tuple[list, frozenset, dict]:
        """Real data plane: ONE device dispatch for ``rounds`` speculative
        draft/verify rounds (DESIGN.md §18). Returns (internal, deferred,
        extras) where extras maps req_id -> total emitted tokens."""
        steps, emitted_rounds = self.executor.execute_multi(
            plan, proj, t_launch, rounds, speculate=gamma)
        deferred = frozenset(getattr(self.executor, "last_deferred", ()))
        internal = [InternalStep(dt, nt, ctx, plan.predicted_time,
                                 emitted_rounds[k] if k < len(emitted_rounds)
                                 else {})
                    for k, (dt, nt, ctx) in enumerate(steps)]
        extras: dict[int, int] = {}
        for em in emitted_rounds:
            for rid, toks in em.items():
                extras[rid] = extras.get(rid, 0) + len(toks)
        acc = getattr(self.executor, "last_spec_accepted", 0)
        drf = getattr(self.executor, "last_spec_drafted", 0)
        self._spec_ewma.update(acc, drf)
        self.spec_rounds += len(steps)
        self.spec_accepted += acc
        self.spec_drafted += drf
        return internal, deferred, extras

    def _run_spec_sim(self, plan: BatchPlan, proj, t_launch: float,
                      rounds: int, gamma: int) -> tuple[list, frozenset, dict]:
        """Commit up to ``rounds`` speculative rounds against the sim
        executor's stochastic acceptance world model (DESIGN.md §18).

        Mirrors ``_run_horizon_sim``: after each round the engine re-checks
        what lock-step would do next (a completion, an arrival, the
        scheduler re-forming) and truncates there — that is what pins the
        pipelined engine's committed counters byte-equal to the lock-step
        oracle's. Emitted token ids are unknown in sim, so internal steps
        carry ``[None] × e`` placeholders (the counts are what the fairness
        accounting and SLO metrics consume).
        """
        order = [it.req_id for it in plan.items]
        local = {rid: proj[rid].speculative_copy() for rid in order}
        internal: list[InternalStep] = []
        extras = {rid: 0 for rid in order}
        accepted = drafted = 0
        cur = plan
        t = t_launch
        for k in range(rounds):
            dt, acc = self.executor.execute_spec(cur, local, t, gamma)
            nt = len(cur.items) * (gamma + 1)
            ctx = sum(local[it.req_id].to_sched_task().cost_context()
                      for it in cur.items)
            t += dt
            emitted: dict[int, list] = {}
            for it in cur.items:
                rid = it.req_id
                req = local[rid]
                e = min(acc[rid], req.max_new_tokens - req.generated)
                emitted[rid] = [None] * e
                extras[rid] += e
                drafted += gamma
                accepted += max(e - 1, 0)
                if e:
                    req.advance(e, t)
            internal.append(InternalStep(dt, nt, ctx, cur.predicted_time,
                                         emitted))
            self.sched.observe(nt, ctx, dt)
            if k == rounds - 1:
                break
            if any(local[rid].state is not RequestState.DECODE
                   for rid in order):
                break                 # a completion re-forms the batch
            if ((self.pending and self.pending[0].arrival <= t)
                    or self.arrival_hint <= t):
                break                 # lock-step would admit it next round
            # side-effect-free preview: billing a probe would double-charge
            # the admission stage on top of charge_accepted_tokens (§13/§18)
            probe = getattr(self.sched, "probe", self.sched.schedule)
            nxt = probe(t, [local[r].to_sched_task() for r in order])
            if ({it.req_id for it in nxt.items} != set(order)
                    or any(it.kind is not TaskKind.DECODE or it.n_tokens != 1
                           for it in nxt.items)):
                break                 # scheduler would re-form the batch
            cur = nxt
        self._spec_ewma.update(accepted, drafted)
        self.spec_rounds += len(internal)
        self.spec_accepted += accepted
        self.spec_drafted += drafted
        return internal, frozenset(), extras

    def complete_step(self) -> StepRecord:
        """Apply the oldest in-flight dispatch; advance the clock to its end.

        Returns the record of the dispatch's LAST internal step (every
        internal step still lands in ``self.steps`` individually, so step
        counts and SLO accounting match the lock-step engine exactly).
        """
        assert self.inflight_q, "no step in flight"
        inf = self.inflight_q.pop(0)
        plan = inf.plan
        executed = 0
        t = inf.t_start
        rec = None
        for k, ist in enumerate(inf.internal):
            t += ist.dt
            ran_p = ran_d = 0
            for it in plan.items:
                if it.req_id in inf.deferred:
                    continue          # executor deferred it (out of KV blocks)
                if k > 0 and it.kind is TaskKind.PREFILL:
                    continue
                req = self.requests[it.req_id]
                tok = ist.emitted.get(it.req_id)
                if isinstance(tok, list):
                    # speculative round (§18): all-decode by construction;
                    # an empty list is a capped round (no progress)
                    if tok:
                        req.generated_tokens.extend(
                            x for x in tok if x is not None)
                        req.advance(len(tok), t)
                        ran_d += 1
                    if req.state is RequestState.FINISHED:
                        self._finish(req)
                    continue
                if tok is not None:
                    req.generated_tokens.append(tok)
                was_prefill = req.state in (RequestState.QUEUED,
                                            RequestState.PREFILL)
                n = it.n_tokens if k == 0 else 1
                req.advance(n, t)
                if was_prefill:
                    ran_p += 1
                else:
                    ran_d += 1
                if self.prefix_cache is not None and req.tokens and was_prefill:
                    self.prefix_cache.on_prefill_progress(req.req_id, n)
                    if req.prefilled == req.prompt_len:
                        # prefill complete: publish the prompt's full-block
                        # pages so concurrent identical prefixes hit (§10)
                        self.prefix_cache.insert_request(req.req_id,
                                                         req.tokens, t)
                if req.state is RequestState.FINISHED:
                    self._finish(req)
            executed += ist.new_tokens
            if not inf.observed:
                self.sched.observe(ist.new_tokens, ist.context, ist.dt)
            rec = StepRecord(t - ist.dt, t, ist.new_tokens, ist.context,
                             ran_p, ran_d, ist.predicted)
            self.steps.append(rec)
        # deferral registry (DESIGN.md §13): a served item is no longer
        # starving; an unserved one starts (or keeps) aging from the first
        # dispatch that could not place it
        self.defer_events += len(inf.deferred)
        for it in plan.items:
            if it.req_id not in inf.deferred:
                self.deferred_since.pop(it.req_id, None)
            elif it.req_id in self.requests and self.requests[it.req_id].active:
                self.deferred_since.setdefault(it.req_id, inf.t_start)
        # fail loudly on a KV-pool deadlock: if every item keeps deferring,
        # no request can ever free pages and retrying forever is a silent
        # livelock (enable cfg.preemption to evict victims instead)
        self._stalled_steps = self._stalled_steps + 1 if executed == 0 else 0
        if self._stalled_steps >= 1000:
            raise RuntimeError(
                "KV pool deadlock: every batch item was deferred for "
                "1000 consecutive steps (pool too small for the working "
                "set; EngineConfig.preemption=True evicts victims instead)")
        self.busy_time += inf.exec_time
        self.now = max(self.now, inf.t_end)
        self._reconcile()
        if self.cfg.preemption and self.deferred_since:
            self._preempt_for_starving()
        return rec

    # ------------------------------------------------------------------
    # preemption (DESIGN.md §13): evict a victim's KV, recompute on resume
    # ------------------------------------------------------------------

    def _preempt_for_starving(self) -> None:
        """Evict victims until starving deferred work can be placed.

        Runs only against executors that expose their ``BlockAllocator``
        (``.alloc``); the sim executor never defers, so preemption never
        fires there. A request referenced by a still-queued speculative
        dispatch is never evicted (its rollback machinery assumes the table
        exists). Victim order is SLO-aware: the decode with the *most*
        envelope slack goes first — it has the most headroom to absorb a
        recompute — with reclaimable (exclusively-held, refcount-1) pages
        as tie-break so shared prefix-cache/COW pages are never counted as
        benefit. When every decode is itself starving (pool deadlock), the
        max-slack starver is evicted so the others can run — the loud
        1000-stall RuntimeError becomes a recompute instead.
        """
        alloc = getattr(self.executor, "alloc", None)
        if alloc is None:
            return
        starving = [rid for rid, since in self.deferred_since.items()
                    if self.now - since >= self.cfg.defer_age
                    and rid in self.requests and self.requests[rid].active]
        if not starving:
            return
        # pages the starvers need for their next grant: one token for a
        # decode, the remaining prompt for a prefill (pessimistic — the
        # scheduler may chunk it smaller, but undersizing would evict one
        # victim per step in a slow churn); +1 covers a pending COW copy
        # of a shared tail page
        need = 0
        for rid in starving:
            req = self.requests[rid]
            want = (1 if req.state is RequestState.DECODE
                    else max(1, req.prompt_len - req.prefilled))
            need += max(alloc.blocks_needed(rid, want), 1) + 1
        inflight_ids = {it.req_id for inf in self.inflight_q
                        for it in inf.plan.items}
        protect = set(starving) | inflight_ids

        def candidates(pool, decode_only):
            out = []
            for rid in pool:
                req = self.requests[rid]
                if decode_only and req.state is not RequestState.DECODE:
                    continue
                reclaimable = alloc.reclaimable_pages(rid)
                if reclaimable > 0:
                    out.append((slo.slack(req.to_sched_task(), self.now),
                                reclaimable, rid))
            out.sort(key=lambda c: (-c[0], -c[1]))
            return out

        # victim pools in preference order:
        #  1. non-starving decodes (classic preemption);
        #  2. non-starving holders in any state (a mid-prefill request's
        #     pages are as reclaimable as a decode's);
        #  3. when several starvers contend for a pool none of them fits,
        #     the max-slack starver itself yields to the others. A SOLE
        #     starver is never self-evicted — freeing its own pages cannot
        #     cover a larger re-grant, it would only churn until the
        #     1000-stall guard fires loudly.
        pools = [([r for r in self.active if r not in protect], True, None),
                 ([r for r in self.active
                   if r not in inflight_ids and r not in protect],
                  False, None)]
        if len(starving) > 1:
            pools.append(([r for r in starving if r not in inflight_ids],
                          False, 1))
        freed = 0
        for pool, decode_only, cap in pools:
            for _, _, rid in candidates(pool, decode_only)[:cap]:
                if freed >= need:
                    return
                freed += self._preempt(self.requests[rid])
            if freed >= need:
                return

    def _preempt(self, req: Request) -> int:
        """Evict one victim's pages and requeue it as a re-prefill of its
        full known prefix (DESIGN.md §13). Returns pages actually freed.

        Eviction is refcount/COW-aware — pages shared with the prefix cache
        or forked siblings survive for their other holders. After requeue
        the prefix cache is re-matched, so a victim whose prompt pages were
        adopted by the radix tree resumes by recomputing only the un-cached
        tail (the effective-token ``cached_context`` path, DESIGN.md §10).
        """
        rid = req.req_id
        self.preemptions += 1
        self.deferred_since.pop(rid, None)
        alloc = getattr(self.executor, "alloc", None)
        freed = alloc.evict_request(rid) if alloc is not None else 0
        if self.prefix_cache is not None:
            self.prefix_cache.end_request(rid)
        req.preempt_requeue()
        if self.prefix_cache is not None and req.tokens:
            cached = self.prefix_cache.begin_request(rid, req.tokens,
                                                     self.now)
            if cached:
                req.cached_context = cached
                req.prefilled = cached
        return freed

    # ------------------------------------------------------------------
    # reconciliation: queued speculative dispatches vs committed reality
    # ------------------------------------------------------------------

    def _reconcile(self) -> None:
        """Validate every still-queued dispatch against committed state.

        Projections are formed with the launched steps' deferred sets and
        emissions already known, so in the shipped executors they are exact;
        this is the safety net the async boundary demands (DESIGN.md §12).
        The first queued dispatch whose plan no longer matches reality —
        e.g. a grant exceeding the remaining prompt, or a request that
        finished — is rolled back together with everything formed after it
        (younger projections chain off it).
        """
        proj: dict[int, Request] = {}
        bad = None
        for i, inf in enumerate(self.inflight_q):
            for it in inf.plan.items:
                if it.req_id in inf.deferred:
                    continue
                req = proj.get(it.req_id)
                if req is None:
                    base = self.requests.get(it.req_id)
                    if base is None or not base.active:
                        bad = i
                        break
                    req = proj[it.req_id] = base.speculative_copy()
                if inf.spec is not None:
                    # speculative dispatch (§18): the grant is the run's
                    # actual emission count, applied at dispatch end
                    grant = inf.spec.get(it.req_id, 0)
                    if (req.state is not RequestState.DECODE
                            or req.generated + grant > req.max_new_tokens):
                        bad = i
                        break
                    if grant:
                        req.advance(grant, inf.t_end)
                    continue
                grant = (it.n_tokens if it.kind is TaskKind.PREFILL
                         else inf.horizon)
                if it.kind is TaskKind.PREFILL:
                    ok = (req.state in (RequestState.QUEUED,
                                        RequestState.PREFILL)
                          and req.prefilled + grant <= req.prompt_len)
                else:
                    ok = (req.state is RequestState.DECODE
                          and req.generated + grant <= req.max_new_tokens)
                if not ok:
                    bad = i
                    break
                for k in range(inf.horizon if it.kind is TaskKind.DECODE
                               else 1):
                    req.advance(it.n_tokens if k == 0 else 1, inf.t_end)
            if bad is not None:
                break
        if bad is None:
            return
        for inf in self.inflight_q[bad:]:
            self._rollback(inf)
        del self.inflight_q[bad:]

    def _rollback(self, inf: InflightStep) -> None:
        """Discard a mis-speculated queued dispatch (DESIGN.md §12).

        Effects were never applied (that happens at complete), so rollback
        is: drop the dispatch and return the KV pages its execution reserved
        — the stale K/V written there is unreachable (context lengths never
        covered it) and the pages are free to be rewritten.
        """
        self.rollbacks += 1
        refund = getattr(self.sched, "refund", None)
        if refund is not None:
            # the rolled-back plan's admission charges never ran
            ran = {it.req_id for it in inf.plan.items
                   if it.req_id not in inf.deferred}
            refund(inf.plan, ran)
            if inf.spec is not None:
                # reverse the accepted-token top-up exactly (§18)
                top_up = getattr(self.sched, "charge_accepted_tokens", None)
                if top_up is not None:
                    top_up(inf.plan, {rid: -(e - 1)
                                      for rid, e in inf.spec.items()
                                      if rid in ran and e > 1})
            else:
                top_up = getattr(self.sched, "charge_extra_decode", None)
                if top_up is not None and inf.horizon > 1:
                    top_up(inf.plan, ran, -(inf.horizon - 1))
        if hasattr(self.executor, "rollback_tokens"):
            for it in inf.plan.items:
                if it.req_id in inf.deferred:
                    continue
                if inf.spec is not None:
                    n = inf.spec.get(it.req_id, 0)
                else:
                    n = (it.n_tokens if it.kind is TaskKind.PREFILL
                         else inf.horizon)
                if n:
                    self.executor.rollback_tokens(it.req_id, n)

    def step(self) -> Optional[StepRecord]:
        """Lock-step driver: begin and complete one dispatch atomically."""
        if not self.active:
            if not self.pending:
                return None
            self.now = max(self.now, self.pending[0].arrival)
        if self.begin_step() is None:
            self.now += self.cfg.idle_step
            return None
        return self.complete_step()

    def _finish(self, req: Request) -> None:
        self.active.remove(req.req_id)
        self.deferred_since.pop(req.req_id, None)
        self._record_done(req)
        if self.prefix_cache is not None and req.tokens:
            # drops the request's page refs; cache-adopted pages stay live
            # until evicted (executor.release below is then a no-op)
            self.prefix_cache.end_request(req.req_id)
        if hasattr(self.executor, "release"):
            self.executor.release(req.req_id)

    # ------------------------------------------------------------------
    # brownout overload shedding (DESIGN.md §16)
    # ------------------------------------------------------------------

    def _poll_brownout_sheds(self) -> None:
        """While the cluster broadcasts fleet saturation, terminate the
        never-served prefills the brownout stage deems deadline-infeasible.
        Only requests not referenced by an in-flight dispatch are eligible
        — a launched batch's effects must land on live request objects."""
        bp = getattr(self.sched, "brownout", None)
        if bp is None or not bp.engaged or not self.active:
            return
        busy = {it.req_id for inf in self.inflight_q
                for it in inf.plan.items}
        tasks = [self.requests[i].to_sched_task() for i in self.active
                 if i not in busy]
        if not tasks:
            return
        for rid in self.sched.poll_shed(self.now, tasks):
            self._shed(self.requests[rid])

    def _shed(self, req: Request) -> None:
        """Terminal brownout shed: mirrors ``_finish`` (exactly-once
        terminal status, pages released, deferral registry cleared) plus
        the exact-billing admission refund."""
        req.state = RequestState.SHED
        self.sheds += 1
        self.active.remove(req.req_id)
        self.deferred_since.pop(req.req_id, None)
        self._record_done(req)
        refund = getattr(self.sched, "refund_request", None)
        if refund is not None:
            refund(req.req_id)
        if self.prefix_cache is not None and req.tokens:
            self.prefix_cache.end_request(req.req_id)
        if hasattr(self.executor, "release"):
            self.executor.release(req.req_id)

    def cache_stats(self) -> dict:
        """Prefix-cache counters for metrics/LB reports (zeros if disabled)."""
        if self.prefix_cache is None:
            return {"hit_rate": 0.0, "hit_tokens": 0, "lookup_tokens": 0,
                    "held_pages": 0}
        return self.prefix_cache.stats_dict()

    def run(self, until_idle: bool = True, max_steps: Optional[int] = None):
        limit = max_steps or self.cfg.max_steps
        n = 0
        while self.has_work and n < limit:
            self.step()
            n += 1
        return self.done

    # ------------------------------------------------------------------
    # fault tolerance: host-state snapshot (KV recomputed on restore)
    # ------------------------------------------------------------------

    def snapshot(self, drain: bool = False) -> str:
        """Serialize host-side engine state.

        A dispatch in flight holds effects that exist nowhere in the
        committed Request state — snapshotting past it would silently drop
        the launched batch on restore. ``drain=True`` completes the pipeline
        first; otherwise an in-flight step is a hard error (DESIGN.md §12).
        """
        if self.inflight_q:
            if not drain:
                raise RuntimeError(
                    f"snapshot with {len(self.inflight_q)} step(s) in "
                    "flight would drop their effects on restore; call "
                    "snapshot(drain=True) or complete the pipeline first")
            while self.inflight_q:
                self.complete_step()

        def ser(req: Request) -> dict:
            d = dataclasses.asdict(req)
            d["state"] = req.state.value
            return d
        return json.dumps({
            "now": self.now,
            "requests": [ser(r) for r in self.requests.values()],
            "pending": [ser(r) for r in self.pending],
            "active": self.active,
            "cost_model": [self.sched.model.a, self.sched.model.b,
                           self.sched.model.c],
        })

    def export_request(self, req_id: int) -> str:
        """Detach ONE request for live migration (DESIGN.md §15).

        Unlike ``snapshot()`` — which refuses (or drains) the whole
        pipeline — this only requires that *this request* is not referenced
        by an in-flight dispatch; the rest of the engine keeps running.
        Callers needing the KV must capture it BEFORE this call: the
        request's table is released here (shared prefix-cache pages survive
        for their other holders via the allocator refcounts). The returned
        blob feeds ``import_migrated`` on the destination.
        """
        req = self.requests[req_id]
        for inf in self.inflight_q:
            if any(it.req_id == req_id for it in inf.plan.items):
                raise RuntimeError(
                    f"request {req_id} is referenced by an in-flight "
                    "dispatch; export at its next step boundary")
        d = dataclasses.asdict(req)
        d["state"] = req.state.value
        if req_id in self.active:
            self.active.remove(req_id)
        self.deferred_since.pop(req_id, None)
        del self.requests[req_id]
        req.state = RequestState.MIGRATED
        if self.prefix_cache is not None and req.tokens:
            self.prefix_cache.end_request(req_id)
        if hasattr(self.executor, "release"):
            self.executor.release(req_id)
        return json.dumps(d)

    def import_migrated(self, blob: str,
                        now: Optional[float] = None) -> Request:
        """Adopt a migrated-in request (DESIGN.md §15).

        Deliberately bypasses ``_admit_arrivals``: a mid-decode request
        must not be re-split by ``prefix_cache.begin_request`` (which would
        reset its prefill progress) nor re-charged by PAB admission — the
        router already placed it. The caller installs the KV (page
        transfer) or calls ``requeue_migrated`` (recompute fallback).
        """
        r = json.loads(blob)
        st = RequestState(r.pop("state"))
        req = Request(**r)
        req.state = st
        if now is not None:
            self.now = max(self.now, now)
        self.requests[req.req_id] = req
        self.active.append(req.req_id)
        return req

    def requeue_migrated(self, req: Request) -> None:
        """Recompute-on-arrival fallback (DESIGN.md §15): no KV came over
        the wire, so the request re-prefills its full known prefix via the
        ``preempt_requeue``/``cached_context`` machinery (DESIGN.md §13) —
        the destination cache is re-matched so only the locally-uncached
        tail is recomputed."""
        req.preempt_requeue()
        if self.prefix_cache is not None and req.tokens:
            cached = self.prefix_cache.begin_request(req.req_id, req.tokens,
                                                     self.now)
            if cached:
                req.cached_context = cached
                req.prefilled = cached

    def restore(self, blob: str) -> None:
        d = json.loads(blob)
        self.now = d["now"]

        def de(r: dict) -> Request:
            r = dict(r)
            st = RequestState(r.pop("state"))
            req = Request(**r)
            req.state = st
            return req
        self.requests = {r["req_id"]: de(r) for r in d["requests"]}
        self.pending = [de(r) for r in d["pending"]]
        self.active = list(d["active"])
        a, b, c = d["cost_model"]
        self.sched.model = LinearCostModel(a=a, b=b, c=c)
        # KV cache is not checkpointed: in-flight requests re-prefill their
        # full known prefix (prompt + generated) — reset prefill progress.
        # Prefix-cache pages are gone with the KV, so the cached split is
        # reset too (a live cache on the restored engine may re-match), and
        # any per-request cache tables from a previous incarnation are
        # released so the re-prefill doesn't double-count allocator pages.
        if self.prefix_cache is not None:
            for rid in self.requests:
                self.prefix_cache.end_request(rid)
        for rid in self.active:
            req = self.requests[rid]
            if req.state in (RequestState.PREFILL, RequestState.DECODE):
                req.prefilled = 0
                req.cached_context = 0
                if req.state is RequestState.DECODE:
                    # re-prefill prompt+generated, then continue decoding
                    # (fold only tokens an earlier preemption requeue has
                    # not already folded into the prompt)
                    req.prompt_len += req.generated - req.refolded
                    req.refolded = req.generated
                    req.state = RequestState.PREFILL
