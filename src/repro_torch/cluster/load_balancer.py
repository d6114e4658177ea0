"""Upper-level (cluster) schedulers — paper §3.4.

The LB's decision model mirrors production constraints: it sees only
periodically-reported metrics plus its own local decrements (eventual
consistency; no strong sync with engines).

* ``RequestCountLB`` — vLLM's native DPLB: waiting + running request count.
* ``PABLB`` — FairBatching's Prefill Admission Budget: route to a node whose
  budget covers the incoming prompt; decrement the local view on dispatch.
  Doubles as the straggler/fault signal (DESIGN.md §7): dead or slow ranks
  report shrinking PAB and organically stop receiving work.
* ``CacheAwareLB`` — cache-affinity routing (DESIGN.md §10): ranks report
  compact prefix-hash summaries of their radix caches alongside PAB; routing
  estimates each rank's longest-prefix hit for the incoming prompt and
  trades that affinity against PAB load — the locality-vs-fairness tension
  of *Locality-aware Fair Scheduling in LLM Serving*.

``route``/``on_dispatch`` optionally receive the request's prompt token ids;
balancers that don't exploit content locality ignore them.

Under the event-driven replay (DESIGN.md §8) ``report()`` fires on timed
LB_REPORT ticks, so between ticks every decision runs on a stale snapshot;
``_Base`` records the snapshot age (``last_report``) for diagnostics.
``make_lb`` is the name→instance factory benchmarks and ``repro_torch.sim.replay``
use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol

from ..cache.radix import block_hashes


class LoadBalancer(Protocol):
    name: str

    def route(self, prompt_len: int, tokens=None,
              tenant: str = "default") -> Optional[int]: ...
    def report(self, rank: int, metrics: dict) -> None: ...
    def on_dispatch(self, rank: int, prompt_len: int, output_len_hint: int,
                    tokens=None) -> None: ...
    def set_alive(self, rank: int, alive: bool) -> None: ...


class _Base:
    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks
        self.alive = [True] * n_ranks
        # ranks the HealthMonitor (DESIGN.md §16) has demoted — silent past
        # the suspect threshold or gray-failing (straggling). Still alive
        # and still holding their work, but routing avoids them while any
        # non-suspect rank is available.
        self.suspect: set[int] = set()
        # wall-clock (sim time) of the last report per rank; None = never.
        # Routing never reads this — it quantifies snapshot staleness.
        self.last_report: dict[int, float] = {}

    def set_alive(self, rank: int, alive: bool) -> None:
        self.alive[rank] = alive
        self.suspect.discard(rank)

    def note_report(self, rank: int, now: Optional[float]) -> None:
        if now is not None:
            self.last_report[rank] = now

    def _ranks(self):
        up = [r for r in range(self.n_ranks) if self.alive[r]]
        if self.suspect:
            ok = [r for r in up if r not in self.suspect]
            if ok:
                return ok
        return up


class RoundRobinLB(_Base):
    name = "round-robin"

    def __init__(self, n_ranks: int):
        super().__init__(n_ranks)
        self._i = 0

    def route(self, prompt_len: int, tokens=None,
              tenant: str = "default") -> Optional[int]:
        ranks = self._ranks()
        if not ranks:
            return None
        self._i += 1
        return ranks[self._i % len(ranks)]

    def report(self, rank, metrics):
        pass

    def on_dispatch(self, rank, prompt_len, output_len_hint, tokens=None):
        pass


class RequestCountLB(_Base):
    """vLLM DPLB: linear combination of waiting + running counts."""
    name = "vllm-lb"

    def __init__(self, n_ranks: int, waiting_weight: float = 2.0):
        super().__init__(n_ranks)
        self.counts = [0.0] * n_ranks
        self.ww = waiting_weight

    def route(self, prompt_len: int, tokens=None,
              tenant: str = "default") -> Optional[int]:
        ranks = self._ranks()
        if not ranks:
            return None
        return min(ranks, key=lambda r: self.counts[r])

    def report(self, rank: int, metrics: dict) -> None:
        self.counts[rank] = (self.ww * metrics.get("waiting", 0)
                             + metrics.get("running", 0))

    def on_dispatch(self, rank, prompt_len, output_len_hint, tokens=None):
        self.counts[rank] += self.ww


class PABLB(_Base):
    """Prefill-Admission-Budget LB (the paper's contribution C5)."""
    name = "pab-lb"

    def __init__(self, n_ranks: int):
        super().__init__(n_ranks)
        self.pab = [math.inf] * n_ranks

    def route(self, prompt_len: int, tokens=None,
              tenant: str = "default") -> Optional[int]:
        ranks = self._ranks()
        if not ranks:
            return None
        # most-loaded-that-fits packs bursts tightly; fall back to max PAB
        fitting = [r for r in ranks if self.pab[r] >= prompt_len]
        if fitting:
            return max(fitting, key=lambda r: self.pab[r])
        return max(ranks, key=lambda r: self.pab[r])

    def report(self, rank: int, metrics: dict) -> None:
        self.pab[rank] = metrics.get("pab", 0.0)

    def on_dispatch(self, rank: int, prompt_len: int, output_len_hint: int,
                    tokens=None) -> None:
        # local-view decrement until the next engine report (paper §3.4)
        if self.pab[rank] is not math.inf:
            self.pab[rank] -= prompt_len


class CacheAwareLB(_Base):
    """Cache-affinity routing over stale per-rank cache summaries
    (DESIGN.md §10).

    Each LB_REPORT tick carries, besides ``pab``, a bounded set of
    cumulative prefix-block hashes of the rank's radix cache
    (``PrefixCache.prefix_hash_summary``). Routing hashes the incoming
    prompt's blocks and estimates each rank's hit as the longest leading run
    of hashes present in its summary; the estimated *uncached* remainder is
    what must fit the rank's PAB.

    The affinity/fairness trade: among ranks whose budget covers the
    uncached tokens, pick the best (affinity_weight·est_hit, PAB) — with
    ``affinity_weight=0`` this degenerates to ``PABLB``. When no rank fits,
    affinity is abandoned and the request goes to max-PAB (fairness wins
    under overload). ``on_dispatch`` adds the dispatched prompt's hashes to
    the local view so a burst of identical prefixes sticks to one rank even
    before its next report tick.

    Per-tenant fairness debt (DESIGN.md §13): ranks running a VTC admission
    stage report ``tenant_debt`` — each tenant's virtual-token overdraft —
    on the same ticks. Routing subtracts ``fairness_weight ×`` the incoming
    tenant's debt at each rank from its affinity score, steering a tenant
    whose counters are deep in overdraft somewhere its work won't be held
    at admission (the locality-vs-fairness trade of *Locality-aware Fair
    Scheduling in LLM Serving*, now with both currencies explicit).
    """
    name = "cache-lb"

    def __init__(self, n_ranks: int, affinity_weight: float = 1.0,
                 block_size: int = 128, max_local_hashes: int = 8192,
                 fairness_weight: float = 0.5):
        super().__init__(n_ranks)
        self.pab = [math.inf] * n_ranks
        self.prefixes: list[set[int]] = [set() for _ in range(n_ranks)]
        self.affinity_weight = affinity_weight
        self.block_size = block_size
        self.max_local_hashes = max_local_hashes
        self.fairness_weight = fairness_weight
        self.tenant_debt: list[dict] = [{} for _ in range(n_ranks)]

    def _est_hit(self, rank: int, hashes: list[int]) -> int:
        n = 0
        known = self.prefixes[rank]
        for h in hashes:
            if h not in known:
                break
            n += 1
        return n * self.block_size

    def route(self, prompt_len: int, tokens=None,
              tenant: str = "default") -> Optional[int]:
        return self._route_among(self._ranks(), prompt_len, tokens, tenant)

    def _route_among(self, ranks: list, prompt_len: int, tokens,
                     tenant: str) -> Optional[int]:
        """The affinity/PAB/debt scoring over an explicit candidate set —
        ``DisaggRouter`` restricts it to the prefill pool (DESIGN.md §15)."""
        if not ranks:
            return None
        hashes = block_hashes(tokens, self.block_size) if tokens else []
        hit = {r: self._est_hit(r, hashes) for r in ranks}
        debt = {r: self.tenant_debt[r].get(tenant, 0.0) for r in ranks}
        fitting = [r for r in ranks if self.pab[r] >= prompt_len - hit[r]]
        if fitting:
            return max(fitting,
                       key=lambda r: (self.affinity_weight * hit[r]
                                      - self.fairness_weight * debt[r],
                                      self.pab[r]))
        return max(ranks, key=lambda r: self.pab[r])

    def report(self, rank: int, metrics: dict) -> None:
        self.pab[rank] = metrics.get("pab", 0.0)
        if "cache_prefixes" in metrics:
            self.prefixes[rank] = set(metrics["cache_prefixes"])
        if "tenant_debt" in metrics:
            self.tenant_debt[rank] = dict(metrics["tenant_debt"])

    def on_dispatch(self, rank: int, prompt_len: int, output_len_hint: int,
                    tokens=None) -> None:
        hashes = block_hashes(tokens, self.block_size) if tokens else []
        if self.pab[rank] is not math.inf:
            self.pab[rank] -= prompt_len - self._est_hit(rank, hashes)
        if len(self.prefixes[rank]) < self.max_local_hashes:
            self.prefixes[rank].update(hashes)


def make_lb(name: str, n_ranks: int, **kw) -> LoadBalancer:
    """Factory used by ``repro_torch.sim.replay`` and benchmark CLIs.

    Names: ``pab`` (paper C5), ``count`` (vLLM DPLB), ``roundrobin``,
    ``cache`` (cache-affinity + PAB, DESIGN.md §10), ``disagg`` (two-stage
    prefill/decode router, DESIGN.md §15).
    The LB classes' ``.name`` attributes ("pab-lb", "vllm-lb", "round-robin",
    "cache-lb", "disagg") are also accepted. Unknown names raise a
    ``ValueError`` listing the valid ones.
    """
    # late import: repro_torch.disagg.router subclasses CacheAwareLB from this
    # module, so a top-level import here would be circular
    from ..disagg.router import DisaggRouter
    aliases = {
        "pab": PABLB, "pab-lb": PABLB,
        "count": RequestCountLB, "vllm-lb": RequestCountLB,
        "roundrobin": RoundRobinLB, "round-robin": RoundRobinLB,
        "cache": CacheAwareLB, "cache-lb": CacheAwareLB,
        "disagg": DisaggRouter, "disagg-lb": DisaggRouter,
    }
    try:
        return aliases[name](n_ranks, **kw)
    except KeyError:
        raise ValueError(f"unknown load balancer: {name!r} "
                         f"(choose from {sorted(set(aliases))})") from None
