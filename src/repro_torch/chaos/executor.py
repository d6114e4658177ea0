"""Fault-injecting executor wrapper (DESIGN.md §16).

Sits between the engine and its data-plane executor and applies the
:class:`~repro_torch.chaos.plan.FaultPlan`'s per-rank windows:

* **straggler windows** — the inner executor's step time is multiplied
  by the plan's slowdown factor, exactly like a contended/thermally
  throttled accelerator. The scheduler's *predicted* time is untouched,
  so the reported actual/predicted step ratio spikes and the
  HealthMonitor's gray-failure demotion sees it.
* **pressure windows** — transient page-pool pressure: a deterministic
  fraction of the step's prefill items is deferred out-of-pool (surfaced
  via ``last_deferred``, the same contract the real paged executor
  uses), which exercises the engine's deferral registry, starvation
  aging, and VTC refund paths. At least one item always executes so
  forward progress is preserved.

The inner executor stays reachable as ``_inner`` (the migration data
plane unwraps through that attribute) and every attribute this wrapper
doesn't own delegates, so capability probes (``execute_multi``,
``alloc``, ``release``…) answer for the wrapped executor.
"""
from __future__ import annotations

import dataclasses

from ..core.types import TaskKind
from .plan import FaultPlan, u01, _qt


class ChaosExecutor:
    """Wrap ``inner`` with the fault windows of ``plan`` for ``rank``."""

    def __init__(self, inner, plan: FaultPlan, rank: int):
        self._inner = inner
        self._plan = plan
        self._rank = rank
        self.last_deferred: tuple = ()
        # engines capability-probe multi-step commitment with hasattr, so
        # only expose it when the wrapped executor actually supports it
        if hasattr(inner, "execute_multi"):
            self.execute_multi = self._execute_multi

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _execute_multi(self, plan, requests, now, horizon):
        steps, emitted = self._inner.execute_multi(plan, requests, now,
                                                   horizon)
        self.last_deferred = tuple(getattr(self._inner, "last_deferred", ()))
        f = self._plan.straggle_factor(self._rank, now)
        if f != 1.0:
            steps = [(dt * f, nt, ctx) for dt, nt, ctx in steps]
        return steps, emitted

    def execute(self, plan, requests, now):
        self.last_deferred = ()
        run = plan
        frac = self._plan.pressure_frac(self._rank, now)
        if frac > 0.0 and plan.items:
            keep, deferred = [], []
            for it in plan.items:
                if it.kind is TaskKind.PREFILL and u01(
                        self._plan.seed, "pressure-defer", self._rank,
                        it.req_id, _qt(now)) < frac:
                    deferred.append(it)
                else:
                    keep.append(it)
            if not keep and deferred:
                keep.append(deferred.pop(0))
            if deferred:
                self.last_deferred = tuple(it.req_id for it in deferred)
                run = dataclasses.replace(plan, items=keep)
        inner_dt, emitted = self._inner.execute(run, requests, now)
        # chain to the inner executor's own deferrals (the real paged
        # executor can defer for genuine pool exhaustion on top of ours)
        inner_def = getattr(self._inner, "last_deferred", ())
        if inner_def:
            self.last_deferred = tuple(self.last_deferred) + tuple(inner_def)
        return inner_dt * self._plan.straggle_factor(self._rank, now), emitted
