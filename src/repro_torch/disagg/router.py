"""Two-stage fairness-aware router for disaggregated pools (DESIGN.md §15).

``DisaggRouter`` conforms to the ``LoadBalancer`` protocol so the cluster
and replay harness drive it like any other LB, but its two decisions run
against disjoint rank pools:

* **stage 1 (prefill placement)** — ``route()`` restricts the inherited
  ``CacheAwareLB`` scoring (cache affinity × prefix-hash summaries, minus
  per-tenant VTC debt, against PAB load) to the alive prefill pool: the
  prefill-side locality-vs-fairness trade of *Locality-aware Fair
  Scheduling in LLM Serving*. If the whole prefill pool is dead it degrades
  to any alive rank rather than rejecting.
* **stage 2 (decode placement)** — ``route_decode()`` places a migrating
  decode on the decode rank with the least reported decode load
  (waiting-weighted occupancy from report ticks) breaking ties by the
  migrating tenant's VTC debt — the decode-side placement signal of
  *Fairness in Serving Large Language Models*. ``note_migration`` bumps the
  local view so a burst of handoffs spreads before the next tick.

``should_shed`` is the migration trigger FairBatching's load estimate
provides: a decode rank whose reported PAB (the budget left before decode
deadlines are violated) falls below ``shed_pab`` must shed, provided some
other decode rank has comfortably more headroom (hysteresis against
ping-pong).
"""
from __future__ import annotations

import math
from typing import Optional

from ..cluster.load_balancer import CacheAwareLB


class DisaggRouter(CacheAwareLB):
    name = "disagg"

    def __init__(self, n_ranks: int, n_prefill: int = 1,
                 affinity_weight: float = 1.0, block_size: int = 128,
                 max_local_hashes: int = 8192, fairness_weight: float = 0.5,
                 waiting_weight: float = 2.0, shed_pab: float = 0.0,
                 shed_slack: float = 0.0, shed_headroom: float = 4.0):
        super().__init__(n_ranks, affinity_weight=affinity_weight,
                         block_size=block_size,
                         max_local_hashes=max_local_hashes,
                         fairness_weight=fairness_weight)
        if not 1 <= n_prefill < max(n_ranks, 2):
            raise ValueError(f"n_prefill={n_prefill} must leave both pools "
                             f"non-empty at n_ranks={n_ranks}")
        self.n_prefill = n_prefill
        self.ww = waiting_weight
        self.decode_load = [0.0] * n_ranks
        self.decode_slack = [math.inf] * n_ranks
        self.shed_pab = shed_pab
        self.shed_slack = shed_slack
        self.shed_headroom = shed_headroom

    # ------------------------------------------------------------------

    def _pool(self, prefill: bool) -> list[int]:
        lo, hi = (0, self.n_prefill) if prefill \
            else (self.n_prefill, self.n_ranks)
        up = [r for r in range(lo, hi)
              if r < len(self.alive) and self.alive[r]]
        # health demotions (DESIGN.md §16) apply per pool: avoid suspect
        # ranks unless the whole pool is suspect
        if self.suspect:
            ok = [r for r in up if r not in self.suspect]
            if ok:
                return ok
        return up

    def route(self, prompt_len: int, tokens=None,
              tenant: str = "default") -> Optional[int]:
        # stage 1: prefills land in the prefill pool (any alive rank only
        # when the whole pool is down — degraded beats rejected)
        return self._route_among(self._pool(True) or self._ranks(),
                                 prompt_len, tokens, tenant)

    def route_decode(self, tenant: str = "default",
                     exclude: Optional[int] = None) -> Optional[int]:
        """Stage 2: pick the decode rank for a migrating request."""
        ranks = [r for r in self._pool(False) if r != exclude] \
            or self._pool(False)
        if not ranks:
            return None
        return min(ranks, key=lambda r: (self.decode_load[r],
                                         self.tenant_debt[r].get(tenant,
                                                                 0.0), r))

    def note_migration(self, rank: int) -> None:
        """Local-view bump at migration launch (eventual consistency: the
        next report tick overwrites it)."""
        if rank < len(self.decode_load):
            self.decode_load[rank] += 1.0

    def report(self, rank: int, metrics: dict) -> None:
        super().report(rank, metrics)
        self.decode_load[rank] = (self.ww * metrics.get("waiting", 0)
                                  + metrics.get("running", 0))
        self.decode_slack[rank] = metrics.get("decode_slack", math.inf)

    # ------------------------------------------------------------------

    def should_shed(self, rank: int) -> Optional[int]:
        """Decode rank over budget? Return the migration target (None = no).

        Two distress triggers, each with its own floor (0 disables):

        * ``shed_pab`` — the rank's reported admission budget (tokens);
        * ``shed_slack`` — the rank's reported min decode slack (seconds),
          FairBatching's per-step load estimate surfaced on report ticks.

        A shed fires when a floor is crossed AND some other decode rank
        reports at least ``shed_headroom ×`` that floor — without the gap
        two equally-loaded ranks would trade the same request back and
        forth every tick.

        When the *entire* decode pool is under the triggering floor, no
        amount of intra-pool shuffling restores slack; the excess decode
        spills to the prefill rank with the most budget instead. A prefill
        rank hosting spilled decodes degrades to monolithic behaviour (its
        chunks shrink to the decode envelope) — the right trade while the
        decode pool is saturated — and recovers once the burst drains."""
        if (rank < self.n_prefill or rank >= len(self.alive)
                or not self.alive[rank]):
            return None
        pab_hot = 0 < self.shed_pab and self.pab[rank] < self.shed_pab
        slack_hot = (0 < self.shed_slack
                     and self.decode_slack[rank] < self.shed_slack)
        if not (pab_hot or slack_hot):
            return None

        def viable(r: int) -> bool:
            ok = True
            if pab_hot:
                v = self.pab[r]
                ok &= (v is math.inf
                       or v >= self.shed_headroom * self.shed_pab)
            if slack_hot:
                v = self.decode_slack[r]
                ok &= (v is math.inf
                       or v >= self.shed_headroom * self.shed_slack)
            return ok

        def under_floor(r: int) -> bool:
            return ((pab_hot and self.pab[r] < self.shed_pab)
                    or (slack_hot
                        and self.decode_slack[r] < self.shed_slack))

        others = [r for r in self._pool(False) if r != rank]
        key = ((lambda r: (self.decode_slack[r], self.pab[r], -r))
               if slack_hot else (lambda r: (self.pab[r], -r)))
        cands = [r for r in others if viable(r)]
        if cands:
            return max(cands, key=key)
        if others and not all(under_floor(r) for r in others):
            return None        # pool not uniformly over budget: hysteresis
        # whole decode pool under the floor → spill toward the prefill pool
        pre = [r for r in self._pool(True) if viable(r)]
        if not pre:
            return None
        return max(pre, key=key)
