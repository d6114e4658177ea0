"""Event-driven multi-replica trace replay (DESIGN.md §8).

``replay()`` is the single entry point every benchmark and example goes
through: it builds a cluster of engines, replays a trace against it on one
global discrete-event clock, and returns seeded, bit-reproducible metrics.

``drive()`` is the underlying loop, usable on a pre-built ``Cluster``. Ranks
interleave freely — one rank can finish three short decode steps while
another grinds through a long prefill chunk — instead of the lock-step
rounds the original ``Cluster.run`` used. The load balancer's view of each
engine is refreshed only on periodic LB_REPORT ticks (plus its own local
dispatch decrements), which models the eventual-consistency regime the
paper designs PAB for (§3.4): between ticks the LB routes on stale
snapshots, exactly like a production router polling engine metrics.

Event causality per instant is fixed by ``EventKind`` priority (events.py);
all randomness flows from the config seed, so two runs with the same seed
produce identical event sequences and identical summary metrics.

Engines with ``pipeline_depth >= 2`` additionally get STEP_FORM events
(DESIGN.md §12): the async control plane forms batch N+1 against projected
state ``host_overhead`` seconds before step N completes, so the host work
overlaps device time instead of opening a bubble between steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..engine.metrics import RequestMetrics
from .events import Event, EventKind, EventQueue

# Hard ceiling on processed events per drive() call — a livelock backstop,
# orders of magnitude above any realistic replay.
_MAX_EVENTS = 50_000_000


def drive(cluster, trace, *, report_interval: float = 0.05,
          step_hook: Optional[Callable] = None) -> list[RequestMetrics]:
    """Replay ``trace`` against ``cluster`` on a single global event clock.

    Consumes the cluster's scheduled ``failures``/``joins`` as timed events.
    ``step_hook(rank, engine, record)`` fires after every completed step —
    benchmarks use it to probe slack/fairness without re-running anything.
    """
    q = EventQueue()
    arrivals = sorted(tr.arrival for tr in trace)
    for tr in sorted(trace, key=lambda t: t.arrival):
        q.push(tr.arrival, EventKind.ARRIVAL, req=tr)
    for t, rank in cluster.failures:
        q.push(t, EventKind.RANK_FAIL, rank=rank)
    for t, rank in cluster.joins:
        q.push(t, EventKind.RANK_JOIN, rank=rank)
    cluster.failures, cluster.joins = [], []
    for rank in cluster.engines:
        q.push(report_interval, EventKind.LB_REPORT, rank=rank,
               epoch=cluster.epoch[rank])
    # ranks with a live LB_REPORT tick chain (the HEALTH sweep restarts a
    # chain that died while its rank still has work, DESIGN.md §16)
    chains = set(cluster.engines)
    # one global failure-detection sweep rides the same cadence; it lands
    # just after the coinciding report ticks (EventKind priority) so the
    # monitor always judges the freshest tick
    q.push(report_interval, EventKind.HEALTH)
    chaos = getattr(cluster.cfg, "chaos", None)

    def collect(eng) -> None:
        """Sweep newly-finished/rejected metrics off an engine.

        Rejections happen inside ``begin_step`` (admission control), finishes
        inside ``complete_step`` — this marker-based sweep catches both.
        """
        n = getattr(eng, "_done_collected", 0)
        if len(eng.done) > n:
            cluster.done.extend(eng.done[n:])
        eng._done_collected = len(eng.done)

    def kick(rank: int, now: float, form: bool = False) -> None:
        """If `rank` has pipeline capacity and runnable work, form+launch.

        With ``pipeline_depth >= 2`` a step may be formed while earlier ones
        are still in flight (projected-state forming, DESIGN.md §12) — but
        ONLY from its STEP_FORM event (``form=True``), which fires
        ``host_overhead`` before the completion it overlaps: the latest
        instant the host can start forming without opening a device bubble,
        and therefore the freshest arrival-queue snapshot it can legally
        use. Eager forming on arrival events would freeze the queue earlier
        than a late-binding host has to, diverging from lock-step for no
        latency win.
        """
        eng = cluster.engines.get(rank)
        if eng is None:
            return
        depth = max(eng.cfg.pipeline_depth, 1)
        if eng.inflight_q and (not form or len(eng.inflight_q) >= depth):
            return
        if not (eng.active or eng.pending):
            return
        pipelined = bool(eng.inflight_q)
        # next trace arrival not yet routed: multi-step commitment must
        # stop there exactly like lock-step re-forming would (DESIGN.md
        # §12). The hint is the GLOBAL next arrival — which rank it will
        # route to is unknowable before the LB sees it — so at n_ranks > 1
        # commitment is conservatively shorter than a per-rank oracle
        # would allow (never longer: parity and envelopes stay safe).
        eng.arrival_hint = (arrivals[next_id] if next_id < len(arrivals)
                            else float("inf"))
        inf = eng.begin_step(now)
        collect(eng)                          # admission may have rejected
        if inf is not None:
            q.push(inf.t_end, EventKind.STEP_DONE, rank=rank, step=inf)
            if depth > 1:
                q.push(max(inf.t_start, inf.t_end - eng.cfg.host_overhead),
                       EventKind.STEP_FORM, rank=rank, step=inf)
        elif eng.active and not pipelined:
            # admitted work but an empty plan: retry after an idle hop
            # (with steps in flight, their completions re-kick instead)
            q.push(eng.now + eng.cfg.idle_step, EventKind.RANK_WAKE, rank=rank)

    def push_migrations(tickets) -> None:
        """Schedule a detached migration's wire events (DESIGN.md §15).

        The request left the source synchronously at detach time (before
        the source could form another step with it); these events model
        only the link: launch when the per-source link frees, install on
        the destination at arrival.
        """
        for tk in tickets:
            q.push(tk.t_launch, EventKind.KV_XFER, ticket=tk)
            q.push(tk.t_arrive, EventKind.KV_XFER_DONE, ticket=tk)

    next_id = 0
    n_events = 0
    while q:
        ev = q.pop()
        n_events += 1
        if n_events > _MAX_EVENTS:
            raise RuntimeError("replay exceeded event budget (livelock?)")
        cluster.now = max(cluster.now, ev.time)

        if ev.kind is EventKind.ARRIVAL:
            rank = cluster._route(ev.req, next_id, ev.time)
            next_id += 1
            if rank is not None:
                kick(rank, ev.time)

        elif ev.kind is EventKind.STEP_DONE:
            eng = cluster.engines.get(ev.rank)
            if eng is None or eng.inflight is not ev.step:
                continue                      # rank died/rejoined mid-step
            n_steps = len(eng.steps)
            eng.complete_step()
            collect(eng)
            if step_hook is not None:
                # a committed multi-step dispatch lands H StepRecords at
                # once — the hook still fires once per scheduler step
                for rec in eng.steps[n_steps:]:
                    step_hook(ev.rank, eng, rec)
            # migrations detach HERE, before the kick can form a new step
            # that would pin the candidate: prefill→decode handoffs on
            # prefill ranks, report-triggered sheds on decode ranks (§15)
            push_migrations(cluster.poll_migrations(ev.rank, eng.now))
            kick(ev.rank, eng.now)

        elif ev.kind is EventKind.STEP_FORM:
            # the running step's host-overlap window opened: form the next
            # batch against projected state (DESIGN.md §12)
            eng = cluster.engines.get(ev.rank)
            if eng is None or all(s is not ev.step for s in eng.inflight_q):
                continue                      # rank died/rejoined mid-step
            kick(ev.rank, ev.time, form=True)

        elif ev.kind is EventKind.LB_REPORT:
            delayed = ev.payload.get("delayed", False)
            eng = cluster.engines.get(ev.rank)
            if eng is None or cluster.epoch[ev.rank] != ev.epoch:
                if not delayed:
                    chains.discard(ev.rank)
                continue                      # tick chain of a dead epoch
            # fault plane (DESIGN.md §16): a tick may be lost or delayed on
            # the wire. Either way the engine-side chain keeps running —
            # only the LB's view goes silent/stale, which is exactly what
            # the HealthMonitor's hysteresis must tolerate (or fence).
            disp = "ok"
            if chaos is not None and not delayed:
                disp = chaos.report_disposition(ev.rank, ev.time)
            if disp == "delay":
                q.push(ev.time + chaos.report_delay, EventKind.LB_REPORT,
                       rank=ev.rank, epoch=ev.epoch, delayed=True)
            if disp == "ok" or delayed:
                cluster._report(ev.rank)
            if delayed:
                continue                      # delayed copies never chain
            # let the tick chain die once no work can ever arrive again
            if (q.pending_work > 0 or cluster.has_parked()
                    or any(e.has_work for e in cluster.engines.values())):
                q.push(ev.time + report_interval, EventKind.LB_REPORT,
                       rank=ev.rank, epoch=ev.epoch)
            else:
                chains.discard(ev.rank)

        elif ev.kind is EventKind.HEALTH:
            # silence-based failure detection + brownout control (§16).
            # Unlike the pre-§16 loop there is NO omniscient kick here: only
            # ranks that actually received re-dispatched work are kicked.
            for r in cluster._health_tick(ev.time):
                kick(r, ev.time)
            for r, e in cluster.engines.items():
                if r not in chains and e.has_work:
                    # a rank whose report chain died while it holds work
                    # (e.g. it was just handed a fenced rank's requests
                    # after its own chain drained) — restart the chain
                    chains.add(r)
                    q.push(ev.time + report_interval, EventKind.LB_REPORT,
                           rank=r, epoch=cluster.epoch[r])
            if (q.pending_work > 0 or cluster.has_parked()
                    or any(e.has_work for e in cluster.engines.values())):
                q.push(ev.time + report_interval, EventKind.HEALTH)

        elif ev.kind is EventKind.RANK_FAIL:
            # fail-stop: the rank vanishes silently. No kick_all — nothing
            # was re-routed; recovery waits on the HealthMonitor (§16)
            cluster._fail_rank(ev.rank)

        elif ev.kind is EventKind.RANK_JOIN:
            cluster._join_rank(ev.rank)
            q.push(ev.time + report_interval, EventKind.LB_REPORT,
                   rank=ev.rank, epoch=cluster.epoch[ev.rank])
            chains.add(ev.rank)
            kick(ev.rank, ev.time)

        elif ev.kind is EventKind.KV_XFER:
            cluster.disagg.on_wire(ev.ticket, ev.time)

        elif ev.kind is EventKind.KV_XFER_DONE:
            rank = cluster.finish_migration(ev.ticket, ev.time)
            # transfers the fault plane disrupted come back rescheduled
            # with backoff (DESIGN.md §16) — push their fresh wire events
            push_migrations(cluster.drain_retries())
            if rank is not None:
                kick(rank, ev.time)

        elif ev.kind is EventKind.RANK_WAKE:
            kick(ev.rank, ev.time)

    return cluster.done


@dataclasses.dataclass
class ReplayResult:
    """Outcome of one ``replay()`` run."""
    metrics: list[RequestMetrics]
    summary: dict
    duration: float
    cluster: object                    # the driven Cluster (engines inspectable)

    @property
    def rank_dispatch(self) -> dict[int, int]:
        """Requests per *final* rank: a request re-routed after a failure
        counts only at the rank that ultimately served it."""
        counts: dict[int, int] = {}
        for rank in self.cluster._rank_of.values():
            counts[rank] = counts.get(rank, 0) + 1
        return counts


def replay(trace, scheduler: str = "fairbatching", n_ranks: int = 1,
           lb="pab", *, ttft_slo: float = 0.5, tpot_slo: float = 0.05,
           admission: bool = False, true_model=None, est_model=None,
           straggler_ranks: Optional[dict] = None, sched_kwargs:
           Optional[dict] = None, failures=(), joins=(),
           report_interval: float = 0.05, prefix_cache_pages: int = 0,
           prefix_block: int = 128, pipeline_depth: int = 1,
           host_overhead: float = 0.0, commit_horizon: int = 1,
           predicted_prefill_tokens: int = 0, speculate: int = 0,
           spec_acceptance: float = 0.7, spec_draft_frac: float = 0.15,
           spec_floor: float = 0.0, seed: int = 0,
           disagg=None, chaos=None, health=None, brownout_pab: float = 0.0,
           checkpoint_interval: float = 0.0,
           step_hook: Optional[Callable] = None) -> ReplayResult:
    """One-call event-driven cluster replay — the repo's canonical harness.

    ``lb`` is a name for ``make_lb`` ("pab" | "count" | "roundrobin" |
    "cache") or a pre-built LoadBalancer. ``failures``/``joins`` are
    (time, rank) pairs. ``prefix_cache_pages`` > 0 gives every rank a radix
    prefix cache of that many KV pages (DESIGN.md §10); traces must carry
    token ids (e.g. the multi-turn / shared-sysprompt scenarios) for it to
    hit. ``pipeline_depth >= 2`` arms the per-rank async pipelined control
    plane (batch N+1 formed against projected state while N runs) with a
    ``host_overhead``-second per-dispatch host cost; ``commit_horizon > 1``
    allows slack-bounded multi-step decode commitment (DESIGN.md §12) —
    with the defaults every engine is the classic synchronous one, bit for
    bit. ``speculate > 0`` arms γ-draft speculative decode rounds on
    all-decode batches (DESIGN.md §18) under the sim's stochastic
    acceptance model (``spec_acceptance`` per draft, drafting priced at
    ``spec_draft_frac`` of a target pass, ``spec_floor`` seeding the
    capacity layer's pessimistic estimator). ``disagg`` (a ``repro_torch.disagg.DisaggConfig``) splits the ranks into
    prefill/decode pools with live KV-page migration between them
    (DESIGN.md §15) — pair it with ``lb="disagg"`` for the two-stage
    router. ``chaos`` (a ``repro_torch.chaos.FaultPlan``) arms the seeded fault
    plane (DESIGN.md §16): its crashes/rejoins are scheduled through the
    guarded cluster methods and every other fault is consulted at use
    time; ``health`` overrides the detection hysteresis constants;
    ``brownout_pab`` > 0 arms fleet-saturation shedding and
    ``checkpoint_interval`` > 0 arms warm-rejoin snapshots. All
    stochasticity (executor jitter, GC pauses, fault draws) derives from
    the seeds: same arguments → identical summary metrics, bit for bit.
    """
    from ..cluster.cluster import Cluster, ClusterConfig
    from ..cluster.load_balancer import make_lb

    kw = {}
    if true_model is not None:
        kw["true_model"] = true_model
    if est_model is not None:
        kw["est_model"] = est_model
    cfg = ClusterConfig(n_ranks=n_ranks, scheduler=scheduler,
                        ttft_slo=ttft_slo, tpot_slo=tpot_slo,
                        admission=admission,
                        straggler_ranks=dict(straggler_ranks or {}),
                        sched_kwargs=dict(sched_kwargs or {}),
                        report_interval=report_interval,
                        prefix_cache_pages=prefix_cache_pages,
                        prefix_block=prefix_block,
                        pipeline_depth=pipeline_depth,
                        host_overhead=host_overhead,
                        commit_horizon=commit_horizon,
                        predicted_prefill_tokens=predicted_prefill_tokens,
                        speculate=speculate, spec_acceptance=spec_acceptance,
                        spec_draft_frac=spec_draft_frac, spec_floor=spec_floor,
                        seed=seed, disagg=disagg, chaos=chaos, health=health,
                        brownout_pab=brownout_pab,
                        checkpoint_interval=checkpoint_interval, **kw)
    # the cache-affinity LB must hash prompts at the engines' page size or
    # its prefix estimates never match the reported summaries
    lb_kw = {}
    if lb in ("cache", "cache-lb"):
        lb_kw = {"block_size": prefix_block}
    elif lb in ("disagg", "disagg-lb"):
        lb_kw = {"block_size": prefix_block}
        if disagg is not None:
            lb_kw["n_prefill"] = disagg.n_prefill
            if disagg.shed_pab > 0:
                lb_kw["shed_pab"] = disagg.shed_pab
            if disagg.shed_slack > 0:
                lb_kw["shed_slack"] = disagg.shed_slack
    cluster = Cluster(cfg, lb if not isinstance(lb, str)
                      else make_lb(lb, n_ranks, **lb_kw))
    for t, rank in failures:
        cluster.schedule_failure(t, rank)
    for t, rank in joins:
        cluster.schedule_join(t, rank)
    if chaos is not None:
        # fail-stop crashes/rejoins from the fault plan go through the
        # guarded schedulers (S1): a malformed plan fails loudly here.
        # Chronological interleave matters — a rank may crash, rejoin,
        # and crash again, and the guard validates against the schedule
        # registered so far.
        fault_events = [(t, 1, r) for t, r in chaos.crashes] + \
                       [(t, 0, r) for t, r in chaos.rejoins]
        for t, is_crash, rank in sorted(fault_events):
            if is_crash:
                cluster.schedule_failure(t, rank)
            else:
                cluster.schedule_join(t, rank)
    metrics = drive(cluster, trace, report_interval=report_interval,
                    step_hook=step_hook)
    duration = max([e.now for e in cluster.engines.values()] + [cluster.now])
    return ReplayResult(metrics, cluster.summary(), duration, cluster)
