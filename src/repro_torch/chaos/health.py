"""Failure detection from missed LB report ticks (DESIGN.md §16).

The load balancer is the only component with a fleet-wide view, and the
only signal it gets from a rank is the periodic report tick. The
:class:`HealthMonitor` turns tick silence into a two-stage verdict with
hysteresis:

* silent for ``suspect_after`` intervals → **suspect**: the rank is
  demoted in routing (``LoadBalancer.suspect``) but keeps its work;
* silent for ``dead_after`` intervals → **dead**: the cluster fences
  the rank (``Cluster._on_dead`` — the *only* remaining caller of
  ``lb.set_alive(rank, False)``) and re-dispatches its parked work.

Gray failures (stragglers) never go silent, so the monitor also tracks
an EWMA of each rank's reported actual/predicted step-time ratio and
demotes ranks running ``demote_ratio``× slower than their scheduler
model predicts, re-promoting below ``promote_ratio`` (hysteresis gap).
Online calibration converging on the slow rank naturally re-promotes it
once the slowdown is priced in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detection thresholds, all in units of report intervals (times) or
    actual/predicted step-time ratios (dimensionless)."""

    suspect_after: float = 3.0    # silent intervals -> routing demotion
    dead_after: float = 6.0       # silent intervals -> fence + re-dispatch
    demote_ratio: float = 2.5     # EWMA step ratio -> gray-failure demotion
    promote_ratio: float = 1.5    # EWMA step ratio -> re-promotion
    ewma_alpha: float = 0.4


class HealthMonitor:
    """Tick-silence and step-ratio health verdicts for every live rank."""

    def __init__(self, lb, cfg: Optional[HealthConfig] = None,
                 interval: float = 0.05):
        self.lb = lb
        self.cfg = cfg or HealthConfig()
        self.interval = max(interval, 1e-9)
        self.last_seen: dict[int, float] = {}
        self.ratio: dict[int, float] = {}
        self.counters = {"detections": 0, "suspects": 0,
                         "demotions": 0, "promotions": 0}

    def register(self, rank: int, now: float) -> None:
        """Start watching ``rank`` (fresh grace period from ``now``)."""
        self.last_seen[rank] = now
        self.ratio.pop(rank, None)

    def deregister(self, rank: int) -> None:
        self.last_seen.pop(rank, None)
        self.ratio.pop(rank, None)
        self.lb.suspect.discard(rank)

    def note_report(self, rank: int, now: float,
                    step_ratio: Optional[float] = None) -> None:
        """A report tick from ``rank`` arrived; fold in its step ratio."""
        if rank not in self.last_seen:
            return
        self.last_seen[rank] = now
        if step_ratio is not None:
            a = self.cfg.ewma_alpha
            prev = self.ratio.get(rank)
            r = step_ratio if prev is None else (1 - a) * prev + a * step_ratio
            self.ratio[rank] = r
            if r > self.cfg.demote_ratio and rank not in self.lb.suspect:
                self.lb.suspect.add(rank)
                self.counters["demotions"] += 1
                return
        # the rank reported and does not look slow: clear any demotion
        # (covers both a straggle window ending and a drop storm ending)
        if rank in self.lb.suspect and \
                self.ratio.get(rank, 1.0) < self.cfg.promote_ratio:
            self.lb.suspect.discard(rank)
            self.counters["promotions"] += 1

    def evaluate(self, now: float) -> list[int]:
        """Periodic sweep: demote silent ranks, return newly-dead ones.

        Dead ranks are deregistered here; the caller fences them.
        """
        dead = []
        for rank, seen in sorted(self.last_seen.items()):
            silent = (now - seen) / self.interval
            if silent >= self.cfg.dead_after:
                dead.append(rank)
            elif silent >= self.cfg.suspect_after and \
                    rank not in self.lb.suspect:
                self.lb.suspect.add(rank)
                self.counters["suspects"] += 1
        for rank in dead:
            self.counters["detections"] += 1
            self.deregister(rank)
        return dead
