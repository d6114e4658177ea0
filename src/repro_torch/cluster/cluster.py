"""Data-parallel serving cluster: N engines + one upper-level scheduler.

Reproduces the paper's §5.5 setup (DP ranks, per-rank FairBatching/Sarathi/
vanilla scheduler, count-LB vs PAB-LB), plus the fault-tolerance and
elasticity behaviours designed for 1000+-node fleets (DESIGN.md §7):

  * node failure — rank marked dead on missed heartbeat; its queued/prefill
    requests are token-level re-dispatched (cheap, as the paper notes in
    §3.3); in-flight decodes are converted to re-prefill of their known
    prefix and re-routed;
  * stragglers — a slow rank's online-calibrated cost model inflates, its
    reported PAB shrinks, and the PAB-LB organically starves it;
  * elastic scale-out/in — ranks join/leave with only an LB-table update
    (serving DP holds no cross-rank state).

The LB sees engine state only through periodic reports + its own local
decrements — the eventual-consistency regime the paper designs PAB for.
Reports are emitted on timed LB_REPORT ticks (``report_interval``) of the
discrete-event clock, not after every step: between ticks the LB routes on
stale snapshots, as a production router polling engine metrics would.

``Cluster`` is the stateful container (engines, routing table, fail/join
mechanics); the global clock that interleaves the ranks lives in
``repro_torch.sim`` (DESIGN.md §8) and ``run()`` simply delegates to it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..cache import PrefixCache
from ..chaos.executor import ChaosExecutor
from ..chaos.health import HealthConfig, HealthMonitor
from ..core import slo
from ..core.batch_formation import FormationConfig
from ..core.cost_model import LinearCostModel
from ..core.pab import PABAdmissionController
from ..core.schedulers import make_scheduler
from ..data.traces import TraceRequest
from ..engine.engine import Engine, EngineConfig
from ..engine.executor import SimExecutor
from ..engine.metrics import RequestMetrics, measure, summarize
from ..engine.request import Request, RequestState
from .load_balancer import LoadBalancer


@dataclasses.dataclass
class ClusterConfig:
    n_ranks: int = 4
    scheduler: str = "fairbatching"
    ttft_slo: float = 0.5
    tpot_slo: float = 0.05
    admission: bool = False              # per-rank PAB admission control
    # true per-rank hardware (index → model); default homogeneous
    true_model: LinearCostModel = dataclasses.field(
        default_factory=lambda: LinearCostModel(a=0.003, b=190e-6, c=20e-9))
    straggler_ranks: dict = dataclasses.field(default_factory=dict)
    # {rank: slowdown_factor}
    est_model: LinearCostModel = dataclasses.field(
        default_factory=lambda: LinearCostModel(a=0.003, b=150e-6, c=10e-9))
    sched_kwargs: dict = dataclasses.field(default_factory=dict)
    # seconds between per-rank LB report ticks (staleness of the LB's view)
    report_interval: float = 0.05
    # per-rank radix prefix cache (DESIGN.md §10): capacity in KV pages of
    # ``prefix_block`` tokens; 0 disables caching (bit-identical to no cache)
    prefix_cache_pages: int = 0
    prefix_block: int = 128
    # async pipelined control plane (DESIGN.md §12): in-flight depth,
    # host-side form/dispatch cost, and the multi-step decode commitment
    # cap; defaults reproduce the synchronous engine bit for bit
    pipeline_depth: int = 1
    host_overhead: float = 0.0
    commit_horizon: int = 1
    predicted_prefill_tokens: int = 0
    # speculative decode (DESIGN.md §18): γ drafts per sequence per round on
    # all-decode batches; 0 disables (bit-identical to before). The sim data
    # plane models acceptance as a truncated geometric with per-draft rate
    # ``spec_acceptance`` and prices drafting at ``spec_draft_frac`` of a
    # same-shape target step; ``spec_floor`` seeds the capacity layer's
    # pessimistic acceptance estimator.
    speculate: int = 0
    spec_acceptance: float = 0.7
    spec_draft_frac: float = 0.15
    spec_floor: float = 0.0
    seed: int = 0
    # disaggregated prefill/decode serving (DESIGN.md §15): a
    # ``repro_torch.disagg.DisaggConfig`` splits the ranks into a prefill pool
    # and a decode pool with live KV-page migration between them; None
    # keeps every rank monolithic (bit-identical to before)
    disagg: Optional[object] = None
    # fault plane (DESIGN.md §16): a ``repro_torch.chaos.FaultPlan`` injects
    # seeded crashes/stragglers/link faults/report loss/page pressure;
    # None disables every injection (bit-identical to before)
    chaos: Optional[object] = None
    # failure-detection hysteresis constants (``repro_torch.chaos.HealthConfig``)
    health: Optional[HealthConfig] = None
    # brownout overload shedding (DESIGN.md §16): engage when every alive
    # rank's reported PAB falls below this floor, release once any rank
    # recovers to floor*headroom; 0 disables the stage entirely
    brownout_pab: float = 0.0
    brownout_headroom: float = 2.0
    # seconds between per-rank warm-rejoin snapshots (model coefficients +
    # prefix-cache content, captured on report ticks); 0 disables
    checkpoint_interval: float = 0.0


class Cluster:
    def __init__(self, cfg: ClusterConfig, lb: LoadBalancer):
        self.cfg = cfg
        self.lb = lb
        self.engines: dict[int, Engine] = {}
        self.done: list[RequestMetrics] = []
        self._rank_of: dict[int, int] = {}
        self._req_src: dict[int, TraceRequest] = {}
        self.failures: list[tuple[float, int]] = []      # (time, rank)
        self.joins: list[tuple[float, int]] = []
        self.now = 0.0
        # engine-incarnation counter: LB report tick chains are tagged with
        # it so a tick scheduled for a dead incarnation dies on pop
        self.epoch: dict[int, int] = {}
        # observability accumulators (DESIGN.md §15): routing-time LB
        # snapshot staleness and per-rank occupancy samples on report ticks
        self._staleness_sum = 0.0
        self._staleness_max = 0.0
        self._staleness_n = 0
        self._occ: dict[int, tuple[float, int]] = {}
        # fault plane (DESIGN.md §16). The HealthMonitor is the ONLY
        # component allowed to mark a rank dead at the LB: crashes park
        # their work here until detection re-dispatches it.
        self.health = HealthMonitor(lb, cfg.health or HealthConfig(),
                                    cfg.report_interval)
        self.crashed: dict[int, float] = {}     # currently-dead: rank → t
        self.crash_log: list[tuple[float, int]] = []    # append-only
        self._parked: dict[int, list[Request]] = {}     # rank → orphans
        self.fault_stats = {"crashes": 0, "fenced": 0, "parked": 0,
                            "redispatched": 0, "park_rejected": 0,
                            "warm_joins": 0}
        self.brownout_engaged = False
        self._brownout_epochs = 0
        self._checkpoints: dict[int, dict] = {}
        self._last_ckpt: dict[int, float] = {}
        # index into eng.steps at the last report tick (gray-failure ratio)
        self._step_mark: dict[int, int] = {}
        if cfg.disagg is not None:
            if cfg.pipeline_depth > 1:
                # with queued speculative dispatches a just-completed
                # prefill is already referenced by the next formed step, so
                # the handoff export could never find a safe boundary
                raise ValueError("disaggregation requires pipeline_depth=1 "
                                 "(handoff exports at step boundaries)")
            from ..disagg.pools import DisaggController
            self.disagg = DisaggController(self, cfg.disagg)
        else:
            self.disagg = None
        for r in range(cfg.n_ranks):
            self._make_engine(r)
            self.health.register(r, 0.0)

    # ------------------------------------------------------------------

    def _make_engine(self, rank: int) -> None:
        cfg = self.cfg
        slow = cfg.straggler_ranks.get(rank, 1.0)
        true = LinearCostModel(a=cfg.true_model.a,
                               b=cfg.true_model.b * slow,
                               c=cfg.true_model.c * slow)
        skw = dict(cfg.sched_kwargs)
        if cfg.brownout_pab > 0:
            # the brownout stage only acts while the cluster broadcasts
            # fleet saturation, so attaching it is free in the clear
            skw.setdefault("brownout", True)
        if (cfg.disagg is not None and rank < cfg.disagg.n_prefill
                and getattr(cfg.disagg, "prefill_chunk", 0) > 0
                and "formation" not in skw
                and cfg.scheduler in ("fairbatching", "fb-token-budget",
                                      "fb-fix-batch")):
            # prefill-pool rank: cap the decode-free step at a chunk size
            # that amortizes the launch cost without head-of-line blocking
            # the prompt queue behind a multi-second one-shot step
            skw["formation"] = FormationConfig(
                max_token_budget=cfg.disagg.prefill_chunk)
        sched = make_scheduler(cfg.scheduler,
                               LinearCostModel(cfg.est_model.a,
                                               cfg.est_model.b,
                                               cfg.est_model.c),
                               **skw)
        self.epoch[rank] = self.epoch.get(rank, 0) + 1
        adm = (PABAdmissionController(cfg.ttft_slo, cfg.tpot_slo)
               if cfg.admission else None)
        cache = (PrefixCache(cfg.prefix_cache_pages,
                             block_size=cfg.prefix_block)
                 if cfg.prefix_cache_pages > 0 else None)
        ecfg = EngineConfig(
            cfg.ttft_slo, cfg.tpot_slo,
            pipeline_depth=cfg.pipeline_depth,
            host_overhead=cfg.host_overhead,
            commit_horizon=cfg.commit_horizon,
            predicted_prefill_tokens=cfg.predicted_prefill_tokens,
            speculate=cfg.speculate,
            spec_draft_frac=cfg.spec_draft_frac,
            spec_floor=cfg.spec_floor)
        executor = SimExecutor(true, seed=cfg.seed * 131 + rank,
                               spec_acceptance=cfg.spec_acceptance,
                               spec_draft_frac=cfg.spec_draft_frac)
        if cfg.chaos is not None:
            # stragglers + transient page pressure injected at the
            # executor boundary (DESIGN.md §16) — the engine above is
            # oblivious, exactly like real hardware misbehaving
            executor = ChaosExecutor(executor, cfg.chaos, rank)
        self.engines[rank] = Engine(
            sched, executor, ecfg, admission=adm, rank=rank,
            prefix_cache=cache)
        self._step_mark[rank] = 0
        if self.brownout_engaged:
            fn = getattr(sched, "set_brownout", None)
            if fn is not None:
                fn(True)

    def _scheduled_state(self, t: float, rank: int) -> str:
        """Replay already-scheduled fail/join events with time <= ``t`` over
        the current topology: 'alive' | 'dead' | 'unknown'."""
        state = "alive" if rank in self.engines or rank in self.crashed \
            else "unknown"
        if rank in self.crashed:
            state = "dead"
        evs = sorted([(ft, 0, r) for ft, r in self.failures] +
                     [(jt, 1, r) for jt, r in self.joins])
        for et, kind, r in evs:
            if et > t or r != rank:
                continue
            state = "dead" if kind == 0 else "alive"
        return state

    def schedule_failure(self, t: float, rank: int) -> None:
        """Schedule a fail-stop crash of ``rank`` at time ``t``. Loudly
        rejects unknown ranks and ranks that will already be dead then —
        silent acceptance would desynchronize a replayed fault plan."""
        state = self._scheduled_state(t, rank)
        if state == "unknown":
            raise ValueError(f"schedule_failure: unknown rank {rank} "
                             f"(known: {sorted(self.engines)})")
        if state == "dead":
            raise ValueError(f"schedule_failure: rank {rank} is already "
                             f"dead at t={t:.3f}")
        self.failures.append((t, rank))
        self.failures.sort()

    def schedule_join(self, t: float, rank: int) -> None:
        """Schedule a (re)join of ``rank`` at time ``t``. A known rank must
        be dead then (rejoin); an unknown rank must be the next contiguous
        index (scale-out) — anything else is a config error."""
        state = self._scheduled_state(t, rank)
        if state == "alive":
            raise ValueError(f"schedule_join: rank {rank} is already "
                             f"alive at t={t:.3f}")
        if state == "unknown":
            nxt = max(list(self.engines) + list(self.crashed) +
                      [r for _, r in self.joins], default=-1) + 1
            if rank != nxt:
                raise ValueError(f"schedule_join: unknown rank {rank} is "
                                 f"not the next scale-out index ({nxt})")
        self.joins.append((t, rank))
        self.joins.sort()

    # ------------------------------------------------------------------

    def _report(self, rank: int) -> None:
        eng = self.engines[rank]
        waiting = sum(1 for i in eng.active
                      if eng.requests[i].state in (RequestState.QUEUED,
                                                   RequestState.PREFILL))
        running = len(eng.active) - waiting
        metrics = {"pab": eng.pab(), "waiting": waiting,
                   "running": running + len(eng.pending)}
        # min TPOT slack over active decodes — FairBatching's per-step load
        # estimate (capacity.init_time_budget's bound), surfaced so the
        # disagg router can spot a decode rank losing its envelope race
        # (DESIGN.md §15 shed trigger); inf when the rank holds no decodes
        dec = [slo.slack(eng.requests[i].to_sched_task(), eng.now)
               for i in eng.active
               if eng.requests[i].state is RequestState.DECODE]
        metrics["decode_slack"] = min(dec) if dec else math.inf
        # control-plane breakdown rides the report tick (DESIGN.md §12):
        # dispatch count + host-overhead seconds, and the mean scheduling
        # delay over finished requests — a router can spot a rank whose
        # control plane (not its FLOPs) is the bottleneck
        metrics.update(eng.host_stats())
        metrics["sched_delay_mean"] = eng.sched_delay_mean()
        debt = eng.tenant_debt()
        if debt:
            # per-tenant fairness debt from the VTC admission stage
            # (DESIGN.md §13): lets CacheAwareLB route a tenant's next
            # request away from ranks where it is already in overdraft
            metrics["tenant_debt"] = dict(debt)
        if eng.prefix_cache is not None:
            # cache summary rides the existing report tick (DESIGN.md §10):
            # token hit counters plus the prefix-hash digest CacheAwareLB
            # matches incoming prompts against
            st = eng.cache_stats()
            metrics["cache_hit_tokens"] = st["hit_tokens"]
            metrics["cache_hit_rate"] = st["hit_rate"]
            metrics["cache_prefixes"] = \
                tuple(eng.prefix_cache.prefix_hash_summary())
        # actual/predicted step-time ratio since the last tick — the
        # gray-failure signal (DESIGN.md §16): a straggling rank runs its
        # steps slower than its calibrated cost model predicted
        mark = self._step_mark.get(rank, 0)
        new_steps = eng.steps[mark:]
        self._step_mark[rank] = len(eng.steps)
        pred = sum(s.predicted for s in new_steps)
        if pred > 1e-12:
            metrics["step_ratio"] = \
                sum(s.t_end - s.t_start for s in new_steps) / pred
        self.lb.report(rank, metrics)
        if hasattr(self.lb, "note_report"):
            self.lb.note_report(rank, self.now)
        self.health.note_report(rank, self.now, metrics.get("step_ratio"))
        if self.cfg.checkpoint_interval > 0 and (
                self.now - self._last_ckpt.get(rank, 0.0)
                >= self.cfg.checkpoint_interval):
            self._checkpoint(rank)
        # per-rank occupancy sample (active + queued) for the pool-level
        # summary rollup (DESIGN.md §15)
        s, n = self._occ.get(rank, (0.0, 0))
        self._occ[rank] = (s + len(eng.active) + len(eng.pending), n + 1)

    def _route(self, tr: TraceRequest, req_id: int,
               arrival: float) -> Optional[int]:
        """Route one arrival; returns the chosen rank (None if rejected)."""
        # per-request SLO classes (heterogeneous traces) override defaults
        ttft = tr.ttft_slo if tr.ttft_slo is not None else self.cfg.ttft_slo
        tpot = tr.tpot_slo if tr.tpot_slo is not None else self.cfg.tpot_slo
        rank = self.lb.route(tr.prompt_len, tokens=tr.tokens,
                             tenant=tr.tenant)
        if rank is not None and hasattr(self.lb, "last_report"):
            # age of the snapshot this routing decision actually used —
            # the staleness the eventual-consistency regime (§3.4) costs
            t0 = self.lb.last_report.get(rank)
            if t0 is not None:
                age = max(0.0, arrival - t0)
                self._staleness_sum += age
                self._staleness_max = max(self._staleness_max, age)
                self._staleness_n += 1
        req = Request(req_id, arrival, tr.prompt_len, tr.output_len,
                      ttft, tpot,
                      tokens=list(tr.tokens) if tr.tokens else None,
                      tenant=tr.tenant)
        if rank is None:
            req.state = RequestState.REJECTED
            self.done.append(measure(req))
            return None
        self.lb.on_dispatch(rank, tr.prompt_len, tr.output_len,
                            tokens=tr.tokens)
        self._rank_of[req_id] = rank
        self._req_src[req_id] = tr
        if rank not in self.engines:
            # the router chose a crashed-but-undetected rank: the dispatch
            # is lost on the wire. Park the request; the HealthMonitor's
            # verdict re-dispatches it (DESIGN.md §16). No kick needed.
            self._parked.setdefault(rank, []).append(req)
            self.fault_stats["parked"] += 1
            return None
        self.engines[rank].submit(req)
        return rank

    # ------------------------------------------------------------------
    # failure path (DESIGN.md §16): crash → silence → detection → recovery
    # ------------------------------------------------------------------

    def _fail_rank(self, rank: int) -> None:
        """Fail-stop crash: the rank silently disappears.

        Nothing is re-routed here and the LB is NOT told — production
        routers have no crash oracle. The LB keeps dispatching to the dead
        rank (those arrivals park, in ``_route``) until the HealthMonitor
        declares it dead from missed report ticks, at which point
        ``_on_dead`` fences it and re-dispatches everything parked. The
        pre-§16 omniscient ``lb.set_alive(rank, False)`` call is gone.
        """
        eng = self.engines.pop(rank, None)
        if eng is None:
            return
        self.crashed[rank] = self.now
        self.crash_log.append((self.now, rank))
        self.fault_stats["crashes"] += 1
        parked = self._parked.setdefault(rank, [])
        for req in [eng.requests[i] for i in eng.active] + eng.pending:
            if req.active:
                parked.append(req)

    def _on_dead(self, rank: int, now: float) -> set[int]:
        """Detection verdict from the HealthMonitor: fence + re-dispatch.

        The ONLY caller of ``lb.set_alive(rank, False)`` on the failure
        path. Two cases: the rank truly crashed earlier (its work is
        already parked), or a false positive — a live rank whose reports
        were all lost past the hysteresis — which is fenced the same way:
        engine popped, work parked, everything re-dispatched. Requests are
        conserved either way; fencing a healthy rank only costs capacity.
        Returns the ranks that received re-dispatched work (callers kick
        them)."""
        eng = self.engines.pop(rank, None)
        if eng is not None:
            self.fault_stats["fenced"] += 1
            self.crashed[rank] = now
            self.crash_log.append((now, rank))
            parked = self._parked.setdefault(rank, [])
            for req in [eng.requests[i] for i in eng.active] + eng.pending:
                if req.active:
                    parked.append(req)
        self.lb.set_alive(rank, False)
        kicks: set[int] = set()
        for req in self._parked.pop(rank, []):
            nr = self._redispatch(req)
            if nr is not None:
                kicks.add(nr)
        return kicks

    def _redispatch(self, req: Request) -> Optional[int]:
        """Token-level re-dispatch of one recovered request (DESIGN.md §7):
        a decode resumes as a re-prefill of its known prefix elsewhere. The
        original prompt token ids are kept (generated ids are not
        re-derivable here), so the destination's prefix cache can still
        serve the prompt part of the re-prefill; prompt_len may therefore
        exceed len(tokens) for moved requests. Only tokens not already
        folded by an earlier preemption/migration requeue are added
        (``refolded`` guards double-counting). Returns the destination
        rank, or None (rejected, or parked on another undetected-dead
        rank)."""
        new_prompt = req.prompt_len + max(0, req.generated - req.refolded)
        src = self._req_src.get(req.req_id)
        toks = src.tokens if src is not None else None
        tr = TraceRequest(req.arrival, new_prompt,
                          max(1, req.max_new_tokens - req.generated),
                          tokens=toks)
        nr = self.lb.route(tr.prompt_len, tokens=toks, tenant=req.tenant)
        if nr is None:
            req.state = RequestState.REJECTED
            self.done.append(measure(req))
            self.fault_stats["park_rejected"] += 1
            return None
        self.lb.on_dispatch(nr, tr.prompt_len, tr.output_len, tokens=toks)
        moved = Request(req.req_id, req.arrival, tr.prompt_len,
                        req.max_new_tokens, req.ttft_slo, req.tpot_slo,
                        tokens=list(toks) if toks else None,
                        tenant=req.tenant)
        # keep already-emitted token times: SLO accounting is end-to-end
        moved.output_times = list(req.output_times)
        moved.generated = req.generated
        moved.refolded = req.generated   # prompt_len already holds them
        moved.retries = req.retries + 1
        if req.output_times:
            moved.state = RequestState.PREFILL
        self._rank_of[req.req_id] = nr
        self.fault_stats["redispatched"] += 1
        if nr not in self.engines:
            # destination itself is crashed-but-undetected: park there —
            # its own detection verdict will move the work once more
            self._parked.setdefault(nr, []).append(moved)
            self.fault_stats["parked"] += 1
            return None
        self.engines[nr].submit(moved)
        return nr

    def _health_tick(self, now: float) -> list[int]:
        """HEALTH event handler: silence-based failure detection, then the
        fleet-saturation brownout broadcast. Returns ranks that received
        re-dispatched work (the replay loop kicks them)."""
        self.now = max(self.now, now)
        kicks: set[int] = set()
        for rank in self.health.evaluate(now):
            kicks.update(self._on_dead(rank, now))
        self._update_brownout()
        return sorted(kicks)

    def _update_brownout(self) -> None:
        """Engage shedding when EVERY alive rank's reported PAB sits below
        the floor (the fleet cannot absorb its load); release with
        hysteresis once any rank recovers real headroom."""
        floor = self.cfg.brownout_pab
        if floor <= 0 or not hasattr(self.lb, "pab"):
            return
        pabs = [self.lb.pab[r] for r in range(self.lb.n_ranks)
                if self.lb.alive[r]]
        if not pabs:
            return
        if not self.brownout_engaged:
            if not all(p < floor for p in pabs):
                return
            self.brownout_engaged = True
            self._brownout_epochs += 1
        else:
            if not any(p >= floor * self.cfg.brownout_headroom
                       for p in pabs):
                return
            self.brownout_engaged = False
        for eng in self.engines.values():
            fn = getattr(eng.sched, "set_brownout", None)
            if fn is not None:
                fn(self.brownout_engaged)

    def _checkpoint(self, rank: int) -> None:
        """Warm-rejoin snapshot (DESIGN.md §16): calibrated cost-model
        coefficients + prefix-cache content. Deliberately NO request
        state — recovery re-dispatches live requests, and restoring them
        here too would double-complete."""
        eng = self.engines.get(rank)
        if eng is None:
            return
        self._last_ckpt[rank] = self.now
        ck: dict = {"t": self.now,
                    "model": (eng.sched.model.a, eng.sched.model.b,
                              eng.sched.model.c)}
        if eng.prefix_cache is not None and eng.prefix_cache.enabled:
            ck["cache"] = eng.prefix_cache.snapshot()
        self._checkpoints[rank] = ck

    def has_parked(self) -> bool:
        """Undelivered work waiting on a failure-detection verdict (keeps
        the replay loop's report/health chains alive)."""
        return any(self._parked.values())

    def crashed_since(self, rank: int, t: float) -> bool:
        """Did ``rank`` crash (or get fenced) at or after clock ``t``?
        Robust to rejoins: consults the append-only crash log."""
        return any(r == rank and tc >= t for tc, r in self.crash_log)

    def drain_retries(self) -> list:
        """KV-migration tickets rescheduled by retry/backoff ([] when
        monolithic); the replay loop pushes fresh KV_XFER events."""
        if self.disagg is None:
            return []
        return self.disagg.drain_retries()

    def _join_rank(self, rank: int) -> None:
        self._make_engine(rank)
        self.engines[rank].now = self.now
        if rank >= self.lb.n_ranks:
            self.lb.n_ranks = rank + 1
            self.lb.alive.append(True)
            if hasattr(self.lb, "pab"):
                self.lb.pab.append(math.inf)
            if hasattr(self.lb, "counts"):
                self.lb.counts.append(0.0)
            if hasattr(self.lb, "prefixes"):
                self.lb.prefixes.append(set())
            if hasattr(self.lb, "tenant_debt"):
                self.lb.tenant_debt.append({})
            if hasattr(self.lb, "decode_load"):
                self.lb.decode_load.append(0.0)
        else:
            # a REJOINING rank is a fresh incarnation: its caches and
            # counters died with the old engine, so every stale LB view
            # must reset to the new-rank defaults. A cold replica still
            # advertising its predecessor's prefix summary would attract
            # affinity routing it cannot serve until its first report tick
            # (the stale-summary regression in tests/test_cluster.py).
            self.lb.set_alive(rank, True)
            if hasattr(self.lb, "pab"):
                self.lb.pab[rank] = math.inf
            if hasattr(self.lb, "counts"):
                self.lb.counts[rank] = 0.0
            if hasattr(self.lb, "prefixes"):
                self.lb.prefixes[rank] = set()
            if hasattr(self.lb, "tenant_debt"):
                self.lb.tenant_debt[rank] = {}
            if hasattr(self.lb, "decode_load"):
                self.lb.decode_load[rank] = 0.0
            if hasattr(self.lb, "last_report"):
                self.lb.last_report.pop(rank, None)
        self.crashed.pop(rank, None)
        self.health.register(rank, self.now)
        ck = self._checkpoints.get(rank)
        if ck is not None:
            # warm rejoin (DESIGN.md §16): restore the dead incarnation's
            # calibrated cost model and re-seed the prefix cache from its
            # last snapshot — the replica starts useful, not cold
            eng = self.engines[rank]
            a, b, c = ck["model"]
            eng.sched.model = LinearCostModel(a=a, b=b, c=c)
            rls = getattr(eng.sched, "_rls", None)
            if rls is not None:
                eng.sched._rls = type(rls)(theta0=(a, b, c))
            if ck.get("cache") and eng.prefix_cache is not None:
                eng.prefix_cache.restore(ck["cache"], self.now)
            self.fault_stats["warm_joins"] += 1

    # ------------------------------------------------------------------
    # disaggregation hooks (DESIGN.md §15): the replay loop calls these at
    # step completions / report ticks and on KV_XFER_DONE events
    # ------------------------------------------------------------------

    def poll_migrations(self, rank: int, now: float,
                        tick: bool = False) -> list:
        """Migration tickets detached at this instant ([] when monolithic)."""
        if self.disagg is None:
            return []
        return self.disagg.poll(rank, now, tick=tick)

    def finish_migration(self, ticket, now: float) -> Optional[int]:
        """Land an arrived migration; returns the rank needing a kick."""
        return self.disagg.complete(ticket, now)

    # ------------------------------------------------------------------

    def run(self, trace: list[TraceRequest]) -> list[RequestMetrics]:
        """Event-driven replay on the shared global clock (DESIGN.md §8)."""
        from ..sim.replay import drive
        return drive(self, trace, report_interval=self.cfg.report_interval)

    def summary(self) -> dict:
        dur = max((e.now for e in self.engines.values()), default=self.now)
        # control-plane totals across live ranks (DESIGN.md §12)
        host: dict[str, float] = {}
        for e in self.engines.values():
            for k, v in e.host_stats().items():
                host[k] = host.get(k, 0) + v
        out = summarize(self.done, duration=max(dur, 1e-9), host=host)
        # engine-side cache counters (lookup-weighted, across live ranks) —
        # unlike the per-request view above these include evictions/inserts
        stats = [e.cache_stats() for e in self.engines.values()
                 if e.prefix_cache is not None]
        if stats:
            looked = sum(s["lookup_tokens"] for s in stats)
            out["engine_cache_hit_tokens"] = sum(s["hit_tokens"]
                                                 for s in stats)
            out["engine_cache_hit_rate"] = \
                out["engine_cache_hit_tokens"] / max(looked, 1)
        # LB snapshot staleness at routing time (DESIGN.md §15): how old
        # the chosen rank's report was when each request was routed
        if self._staleness_n:
            out["lb_staleness_mean"] = self._staleness_sum / self._staleness_n
            out["lb_staleness_max"] = self._staleness_max
        if self._occ:
            def occ_mean(ranks) -> float:
                vals = [s / n for r, (s, n) in self._occ.items()
                        if r in ranks and n]
                return sum(vals) / len(vals) if vals else 0.0
            out["occupancy_mean"] = occ_mean(set(self._occ))
            if self.disagg is not None:
                pf = set(self.disagg.prefill_ranks())
                out["prefill_pool_occupancy"] = occ_mean(pf)
                out["decode_pool_occupancy"] = occ_mean(set(self._occ) - pf)
        if self.disagg is not None:
            out["migrations"] = dict(self.disagg.counters)
            if self.disagg.retry_hist:
                out["migrations"]["retry_hist"] = \
                    dict(sorted(self.disagg.retry_hist.items()))
        # fault-plane rollup (DESIGN.md §16) — only materialized when a
        # fault actually happened, so fault-free summaries stay unchanged
        faults = {**self.fault_stats, **self.health.counters,
                  "brownout_epochs": self._brownout_epochs}
        if any(faults.values()):
            out["faults"] = faults
        return out
