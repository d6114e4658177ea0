"""Prefill/decode pool split and the migration control loop (DESIGN.md §15).

``DisaggController`` partitions a ``Cluster``'s ranks into a prefill pool
(ranks ``[0, n_prefill)``) and a decode pool (the rest) and drives two
migration flows on the replay's event clock:

* **handoff** — polled at every prefill-rank step completion: each active
  request that just finished prefill (state DECODE, not referenced by an
  in-flight dispatch) is detached synchronously and shipped to a decode
  rank. The KV_XFER/KV_XFER_DONE events model only the wire — per-source
  transfers serialize on a single link (``t_launch`` waits for the link),
  and the request is absent from both ranks while in flight (the migration
  stall the bench measures against recompute).
* **shed** — polled at decode-rank step completions, triggered by report
  state: when FairBatching's load estimate (the rank's PAB as of its last
  report tick) says a decode rank can no longer absorb bursts, its
  max-slack decode migrates to the decode rank with the most budget
  (``DisaggRouter.should_shed``), restoring slack. When the whole decode
  pool is under the floor the victim *spills* into the prefill pool
  instead (counted separately; ``_handoffs`` pins it there so it is not
  bounced straight back). The detach waits for the step boundary —
  mid-step every decode is pinned by the in-flight plan.

Transfer-vs-recompute is decided per request (``DisaggConfig.mode``):
"kv" ships pages, "recompute" ships token ids and re-prefills on arrival,
"auto" compares the modeled wire time against the estimated recompute time
of the destination-uncached prefix (``migration.breakeven_tokens`` is the
closed form).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import slo
from ..core.cost_model import LinkModel, kv_bytes_per_token
from ..engine.metrics import measure
from ..engine.request import RequestState
from . import migration
from .migration import MigrationTicket


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    """Per-token KV footprint of the modeled serving hardware — the sim has
    no tensors, so migration byte counts come from this (defaults match the
    benchmarks' qwen3-14b profile: 40 layers × 8 KV heads × 128 dims)."""
    n_layers: int = 40
    n_kv_heads: int = 8
    head_dim: int = 128
    kv_dtype: str = "bf16"

    def bytes_per_token(self) -> int:
        return kv_bytes_per_token(self.n_layers, self.n_kv_heads,
                                  self.head_dim, self.kv_dtype)


@dataclasses.dataclass
class DisaggConfig:
    n_prefill: int = 1
    mode: str = "kv"               # "kv" | "recompute" | "auto"
    link: LinkModel = dataclasses.field(default_factory=LinkModel)
    geometry: KVGeometry = dataclasses.field(default_factory=KVGeometry)
    # decode-pool shedding (0 disables): a decode rank reporting PAB below
    # ``shed_pab`` tokens — or min decode slack below ``shed_slack``
    # seconds — migrates bursting decodes out; see DisaggRouter
    shed_pab: float = 0.0
    shed_slack: float = 0.0
    max_shed_per_tick: int = 1
    # chunk cap for prefill-pool ranks (0 = engine default). Decode-free
    # ranks would otherwise run whole prompts as one uncapped step: at
    # ~512 tokens the per-step launch cost is already amortized to <3%,
    # while a multi-second one-shot step would head-of-line block every
    # prompt queued behind it.
    prefill_chunk: int = 512
    # bytes shipped by a recompute-mode migration (token ids + header)
    metadata_bytes: int = 256


class DisaggController:
    """Cluster-side migration driver; owns counters and per-source links."""

    def __init__(self, cluster, cfg: DisaggConfig):
        if not 1 <= cfg.n_prefill < cluster.cfg.n_ranks:
            raise ValueError(
                f"n_prefill={cfg.n_prefill} must leave both pools non-empty "
                f"at n_ranks={cluster.cfg.n_ranks}")
        if cfg.mode not in ("kv", "recompute", "auto"):
            raise ValueError(f"unknown migration mode: {cfg.mode!r} "
                             "(choose from ['auto', 'kv', 'recompute'])")
        self.cluster = cluster
        self.cfg = cfg
        self.link_free_at: dict[int, float] = {}   # src rank → busy-until
        self.in_flight = 0
        self._rr = 0                               # fallback round-robin
        self.counters = {"launched": 0, "completed": 0, "kv": 0,
                         "recompute": 0, "shed": 0, "spill": 0,
                         "rejected": 0, "bytes": 0, "ref_tokens": 0,
                         "moved_tokens": 0, "peak_in_flight": 0,
                         "xfer_failures": 0, "xfer_retries": 0,
                         "xfer_gave_up": 0, "dead_source": 0}
        # req ids shed *into* the prefill pool (decode pool saturated);
        # _handoffs must not immediately ship them back out
        self.spilled: set[int] = set()
        # disrupted transfers rescheduled with backoff (DESIGN.md §16);
        # the replay loop drains this after every KV_XFER_DONE
        self.retry_queue: list[MigrationTicket] = []
        self.retry_hist: dict[str, int] = {}   # attempts → completions

    # ------------------------------------------------------------------

    def prefill_ranks(self) -> list[int]:
        return list(range(self.cfg.n_prefill))

    def is_prefill_rank(self, rank: int) -> bool:
        return rank < self.cfg.n_prefill

    def _alive_decode_ranks(self) -> list[int]:
        lb = self.cluster.lb
        return [r for r in self.cluster.engines
                if not self.is_prefill_rank(r)
                and r < len(lb.alive) and lb.alive[r]]

    def _pick_decode(self, tenant: str,
                     exclude: Optional[int] = None) -> Optional[int]:
        lb = self.cluster.lb
        fn = getattr(lb, "route_decode", None)
        if fn is not None:
            return fn(tenant=tenant, exclude=exclude)
        ranks = [r for r in self._alive_decode_ranks() if r != exclude]
        if not ranks:
            return None
        self._rr += 1
        return ranks[self._rr % len(ranks)]

    # ------------------------------------------------------------------
    # poll: called by the replay loop at step completions (handoffs) and
    # on decode-rank report ticks (shed checks)
    # ------------------------------------------------------------------

    def poll(self, rank: int, now: float, tick: bool = False) -> list:
        # both flows detach at step boundaries (tick=False): a report tick
        # usually lands mid-step, when every decode is referenced by the
        # in-flight plan and nothing is exportable. The *trigger* for a
        # shed is still the last report tick's state (should_shed reads
        # the LB's reported PAB) — only the detach waits for the boundary.
        eng = self.cluster.engines.get(rank)
        if eng is None or tick:
            return []
        if self.is_prefill_rank(rank):
            return self._handoffs(rank, eng, now)
        return self._sheds(rank, eng, now)

    def _inflight_ids(self, eng) -> set:
        return {it.req_id for inf in eng.inflight_q for it in inf.plan.items}

    def _handoffs(self, rank: int, eng, now: float) -> list:
        busy = self._inflight_ids(eng)
        out = []
        for rid in list(eng.active):
            req = eng.requests[rid]
            if req.state is not RequestState.DECODE or rid in busy \
                    or rid in self.spilled:
                continue
            dst = self._pick_decode(req.tenant)
            if dst is None:
                continue           # no decode pool alive: serve locally
            out.append(self._launch(eng, req, rank, dst, now, "handoff"))
        return out

    def _sheds(self, rank: int, eng, now: float) -> list:
        should = getattr(self.cluster.lb, "should_shed", None)
        if should is None or (self.cfg.shed_pab <= 0
                              and self.cfg.shed_slack <= 0):
            return []
        out = []
        for _ in range(self.cfg.max_shed_per_tick):
            dst = should(rank)
            if dst is None:
                break
            busy = self._inflight_ids(eng)
            cands = [eng.requests[rid] for rid in eng.active
                     if eng.requests[rid].state is RequestState.DECODE
                     and rid not in busy]
            if not cands:
                break
            victim = max(cands,
                         key=lambda r: (slo.slack(r.to_sched_task(), now),
                                        -r.req_id))
            out.append(self._launch(eng, victim, rank, dst, now, "shed"))
            self.counters["shed"] += 1
            if self.is_prefill_rank(dst):
                self.counters["spill"] += 1
                self.spilled.add(victim.req_id)
        return out

    # ------------------------------------------------------------------

    def _launch(self, eng, req, src: int, dst: int, now: float,
                reason: str) -> MigrationTicket:
        """Detach ``req`` from ``eng`` and build its wire-timed ticket."""
        cfg, link = self.cfg, self.cfg.link
        alloc = getattr(migration._data_plane(eng.executor), "alloc", None)
        n = (alloc.lens.get(req.req_id, 0) if alloc is not None
             and req.req_id in alloc.lens else max(req.context - 1, 1))
        dst_eng = self.cluster.engines.get(dst)
        ref = 0
        if dst_eng is not None and req.tokens:
            ref = len(migration.cached_prefix_pages(dst_eng, req.tokens, n,
                                                    now)) \
                * self.cluster.cfg.prefix_block
        mode = cfg.mode
        bpt = cfg.geometry.bytes_per_token()
        if mode == "auto":
            uncached = n - ref
            t_xfer = link.transfer_time(uncached * bpt)
            t_rec = self.cluster.cfg.est_model.step_time(
                max(uncached, 1), n)
            mode = "kv" if t_xfer <= t_rec else "recompute"
        n_bytes = ((n - ref) * bpt + cfg.metadata_bytes if mode == "kv"
                   else cfg.metadata_bytes
                   + 8 * (len(req.tokens) if req.tokens else 0))
        blob, payload = migration.migrate_out(eng, req.req_id)
        if mode == "recompute":
            payload = None
        t_launch = max(now, self.link_free_at.get(src, 0.0))
        chaos = getattr(self.cluster.cfg, "chaos", None)
        if chaos is not None:
            # a partitioned link delays the launch past its down-window
            t_launch = chaos.link_clear_time(src, t_launch)
        t_arrive = t_launch + link.transfer_time(n_bytes)
        self.link_free_at[src] = t_arrive
        self.counters["launched"] += 1
        self.counters["bytes"] += n_bytes
        self.counters["ref_tokens"] += ref
        self.counters["moved_tokens"] += n - ref if mode == "kv" else 0
        note = getattr(self.cluster.lb, "note_migration", None)
        if note is not None:
            note(dst)
        return MigrationTicket(
            req_id=req.req_id, src=src, dst=dst, mode=mode, reason=reason,
            t_detach=now, t_launch=t_launch, t_arrive=t_arrive, n_tokens=n,
            ref_tokens=ref, n_bytes=n_bytes, blob=blob, kv=payload,
            tenant=req.tenant)

    # ------------------------------------------------------------------
    # event handlers (replay loop)
    # ------------------------------------------------------------------

    def on_wire(self, ticket: MigrationTicket, now: float) -> None:
        self.in_flight += 1
        self.counters["peak_in_flight"] = max(
            self.counters["peak_in_flight"], self.in_flight)

    def drain_retries(self) -> list:
        """Tickets rescheduled with backoff since the last drain; the
        replay loop pushes their fresh KV_XFER/KV_XFER_DONE events."""
        out, self.retry_queue = self.retry_queue, []
        return out

    def complete(self, ticket: MigrationTicket,
                 now: float) -> Optional[int]:
        """Land an arrived migration; returns the rank to kick (None if
        the request could not be placed anywhere, or the transfer was
        disrupted and went back on the wire with backoff)."""
        self.in_flight = max(0, self.in_flight - 1)
        cl = self.cluster
        chaos = getattr(cl.cfg, "chaos", None)
        if ticket.mode == "kv" and cl.crashed_since(ticket.src,
                                                    ticket.t_detach):
            # the source died after detach with the payload still (partly)
            # on the wire: its pages are void. The host blob's token ids
            # ride the reliable control channel — recompute on arrival.
            self.counters["dead_source"] += 1
            ticket.mode = "recompute"
            ticket.kv = None
        elif (ticket.mode == "kv" and chaos is not None
                and chaos.transfer_disrupted(ticket.src, ticket.t_launch,
                                             ticket.t_arrive,
                                             ticket.req_id,
                                             ticket.attempt)):
            self.counters["xfer_failures"] += 1
            if ticket.attempt < chaos.max_retries \
                    and ticket.src in cl.engines:
                # retry with seeded exponential backoff (DESIGN.md §16):
                # mutate the ticket's wire times and re-serialize on the
                # source link; the replay loop re-pushes its events
                ticket.attempt += 1
                self.counters["xfer_retries"] += 1
                t_launch = max(now + chaos.backoff(ticket.req_id,
                                                   ticket.attempt),
                               self.link_free_at.get(ticket.src, 0.0))
                t_launch = chaos.link_clear_time(ticket.src, t_launch)
                ticket.t_launch = t_launch
                ticket.t_arrive = t_launch + self.cfg.link.transfer_time(
                    ticket.n_bytes)
                self.link_free_at[ticket.src] = ticket.t_arrive
                self.retry_queue.append(ticket)
                return None
            # retry budget exhausted (or the source just died): guaranteed
            # termination via the recompute fallback on the control channel
            self.counters["xfer_gave_up"] += 1
            ticket.mode = "recompute"
            ticket.kv = None
        if ticket.dst not in cl.engines:
            # destination died while the payload was in flight: the pages
            # it carried are useless there — recompute on any survivor
            alt = self._pick_decode(ticket.tenant, exclude=ticket.dst)
            if alt is None:
                alive = [r for r in cl.engines
                         if r < len(cl.lb.alive) and cl.lb.alive[r]]
                alt = alive[0] if alive else None
            if alt is None:
                import json
                d = json.loads(ticket.blob)
                d.pop("state", None)
                from ..engine.request import Request
                req = Request(**d)
                req.state = RequestState.REJECTED
                cl.done.append(measure(req))
                self.counters["rejected"] += 1
                return None
            ticket.dst = alt
            ticket.mode = "recompute"
            ticket.kv = None
        req, mode, _ = migration.install(cl.engines[ticket.dst], ticket, now)
        req.retries += ticket.attempt     # surface xfer retries in metrics
        cl._rank_of[req.req_id] = ticket.dst
        self.counters["completed"] += 1
        self.counters[mode] += 1
        if ticket.attempt:
            self.retry_hist[str(ticket.attempt)] = \
                self.retry_hist.get(str(ticket.attempt), 0) + 1
        return ticket.dst
