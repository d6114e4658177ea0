"""Seeded fault plans for chaos-hardened serving (DESIGN.md §16).

A :class:`FaultPlan` is a *pure description* of every fault a run will
experience: fail-stop crashes (+ rejoins), straggler slowdown windows,
transient page-pool pressure windows, flaky/partitioned KV-transfer
links, dropped/delayed LB report ticks, and per-attempt KV-transfer
failures. Two design rules make chaos runs deterministic and resumable:

* **No hidden RNG streams.** Every probabilistic decision is a pure
  function of ``(seed, stable key)`` through a keyed blake2b hash
  (:func:`u01`), so the outcome never depends on event interleaving,
  module import order, or how many other random draws happened first.
  Two same-seed runs are byte-identical; a resumed run re-derives the
  exact same faults.
* **Faults are consulted at use time, not injected as events.** Only
  crashes/rejoins become replay events (through the guarded
  ``Cluster.schedule_failure`` / ``schedule_join``); windows and rates
  are looked up by the component they affect (executor, link, report
  handler) against the replay clock.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence, Tuple


def u01(seed: int, *key) -> float:
    """Deterministic uniform [0, 1) draw from a stable keyed hash.

    Unlike an RNG stream, the value for a given ``(seed, key)`` never
    depends on how many other draws were made before it — the property
    that keeps chaos runs replayable and resumable.
    """
    h = hashlib.blake2b(repr((seed,) + key).encode("utf-8"),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


def _qt(t: float) -> int:
    """Quantize a clock value for hashing (stable across float noise)."""
    return int(round(t * 1e6))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Everything that will go wrong in one run, derived from one seed.

    ``crashes``/``rejoins`` are ``(t, rank)`` schedules; the window
    tuples are ``(t0, t1, rank, value)`` (value = slowdown factor for
    straggles, deferred fraction for pressures) and ``(t0, t1, src)``
    for link partitions. Rates are per-decision probabilities.
    """

    seed: int = 0
    crashes: Tuple[Tuple[float, int], ...] = ()
    rejoins: Tuple[Tuple[float, int], ...] = ()
    straggles: Tuple[Tuple[float, float, int, float], ...] = ()
    pressures: Tuple[Tuple[float, float, int, float], ...] = ()
    link_down: Tuple[Tuple[float, float, int], ...] = ()
    report_drop_rate: float = 0.0
    report_delay_rate: float = 0.0
    report_delay: float = 0.1
    xfer_fail_rate: float = 0.0
    max_retries: int = 4
    backoff_base: float = 0.02

    # ------------------------------------------------------------- queries
    def straggle_factor(self, rank: int, t: float) -> float:
        """Step-time multiplier for ``rank`` at clock ``t`` (1.0 = none)."""
        f = 1.0
        for t0, t1, r, fac in self.straggles:
            if r == rank and t0 <= t < t1:
                f *= fac
        return f

    def pressure_frac(self, rank: int, t: float) -> float:
        """Fraction of prefill work to defer under page-pool pressure."""
        frac = 0.0
        for t0, t1, r, fr in self.pressures:
            if r == rank and t0 <= t < t1:
                frac = max(frac, fr)
        return frac

    def link_clear_time(self, src: int, t: float) -> float:
        """Earliest clock >= ``t`` at which ``src``'s link is up."""
        moved = True
        while moved:
            moved = False
            for t0, t1, r in self.link_down:
                if r == src and t0 <= t < t1:
                    t = t1
                    moved = True
        return t

    def transfer_disrupted(self, src: int, t0: float, t1: float,
                           req_id: int, attempt: int) -> bool:
        """Did the KV transfer of ``req_id`` (attempt #``attempt``) on
        ``src``'s link, airborne over ``[t0, t1)``, fail?"""
        for w0, w1, r in self.link_down:
            if r == src and w0 < t1 and t0 < w1:
                return True
        if self.xfer_fail_rate <= 0.0:
            return False
        return u01(self.seed, "xfer", src, req_id, attempt) \
            < self.xfer_fail_rate

    def backoff(self, req_id: int, attempt: int) -> float:
        """Jittered exponential backoff before retry #``attempt + 1``."""
        jitter = 1.0 + 0.5 * u01(self.seed, "backoff", req_id, attempt)
        return self.backoff_base * (2.0 ** attempt) * jitter

    def report_disposition(self, rank: int, t: float) -> str:
        """Fate of the LB report tick of ``rank`` at ``t``:
        ``"ok"`` | ``"drop"`` | ``"delay"``."""
        if self.report_drop_rate <= 0.0 and self.report_delay_rate <= 0.0:
            return "ok"
        u = u01(self.seed, "report", rank, _qt(t))
        if u < self.report_drop_rate:
            return "drop"
        if u < self.report_drop_rate + self.report_delay_rate:
            return "delay"
        return "ok"

    # ---------------------------------------------------------- generation
    @classmethod
    def generate(cls, seed: int, duration: float, n_ranks: int, *,
                 crash_rate: float = 0.0,
                 rejoin_delay: float | None = None,
                 straggler_rate: float = 0.0,
                 straggle_factor: float = 3.0,
                 straggle_len: float | None = None,
                 pressure_rate: float = 0.0,
                 pressure_frac: float = 0.5,
                 pressure_len: float | None = None,
                 link_flap_rate: float = 0.0,
                 link_down_len: float | None = None,
                 report_drop_rate: float = 0.0,
                 report_delay_rate: float = 0.0,
                 report_delay: float = 0.1,
                 xfer_fail_rate: float = 0.0,
                 max_retries: int = 4,
                 backoff_base: float = 0.02,
                 protect: Sequence[int] = ()) -> "FaultPlan":
        """Draw a fault schedule for a ``duration``-second, ``n_ranks``
        run. Rates are expected events per second (``crash_rate=2/dur``
        ⇒ ~2 crashes). Crash times land in the first ~75% of the run so
        detection + rejoin fit the horizon; the generator tracks the
        projected alive set and never kills the last rank (or a rank in
        ``protect`` — e.g. a lone prefill pool)."""
        rejoin_delay = duration * 0.2 if rejoin_delay is None else rejoin_delay
        straggle_len = duration * 0.25 if straggle_len is None else straggle_len
        pressure_len = duration * 0.15 if pressure_len is None else pressure_len
        link_down_len = duration * 0.1 if link_down_len is None else link_down_len

        n_crashes = int(round(crash_rate * duration))
        events = sorted(
            (0.05 * duration + 0.7 * duration * u01(seed, "crash-t", i), i)
            for i in range(n_crashes))
        alive = set(range(n_ranks))
        pend: list[tuple[float, int]] = []
        crashes: list[tuple[float, int]] = []
        rejoins: list[tuple[float, int]] = []
        for t, i in events:
            pend.sort()
            while pend and pend[0][0] <= t:
                alive.add(pend.pop(0)[1])
            elig = sorted(alive - set(protect))
            if len(alive) < 2 or not elig:
                continue
            rank = elig[int(u01(seed, "crash-r", i) * len(elig)) % len(elig)]
            alive.discard(rank)
            crashes.append((round(t, 6), rank))
            tr = round(t + rejoin_delay, 6)
            if tr < duration:
                rejoins.append((tr, rank))
                pend.append((tr, rank))

        def windows(kind: str, rate: float, length: float, value):
            out = []
            for i in range(int(round(rate * duration))):
                t0 = 0.05 * duration + 0.7 * duration * u01(seed, kind, i, "t")
                rank = int(u01(seed, kind, i, "r") * n_ranks) % n_ranks
                if value is None:
                    out.append((round(t0, 6), round(t0 + length, 6), rank))
                else:
                    out.append((round(t0, 6), round(t0 + length, 6), rank,
                                value))
            return tuple(sorted(out))

        return cls(
            seed=seed,
            crashes=tuple(crashes),
            rejoins=tuple(sorted(rejoins)),
            straggles=windows("straggle", straggler_rate, straggle_len,
                              straggle_factor),
            pressures=windows("pressure", pressure_rate, pressure_len,
                              pressure_frac),
            link_down=windows("link", link_flap_rate, link_down_len, None),
            report_drop_rate=report_drop_rate,
            report_delay_rate=report_delay_rate,
            report_delay=report_delay,
            xfer_fail_rate=xfer_fail_rate,
            max_retries=max_retries,
            backoff_base=backoff_base,
        )
