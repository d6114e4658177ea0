"""Discrete-event core: a global clock shared by every replica (DESIGN.md §8).

Events carry a (time, priority, seq) key so that pops are fully deterministic:
ties on the timestamp are broken first by kind priority, then by insertion
order. Priority encodes the causal conventions of the replay loop:

  * membership changes (fail/join) apply before anything else at an instant,
    so a coinciding arrival is routed against the updated alive-set;
  * pipelined batch forming (STEP_FORM, DESIGN.md §12) precedes the step
    completion it overlaps: with zero host overhead the two coincide at
    t_end, and forming first is what forces the projection machinery to
    reproduce the post-completion state bit-for-bit (the parity suite's
    whole point);
  * a rank's step completion lands before arrivals at the same instant, so
    freed capacity and finished requests are visible to routing;
  * KV migration launches/arrivals (DESIGN.md §15) land after step
    completions — a transfer can only be cut at a step boundary, and its
    freed source pages / installed destination pages must be visible to the
    report ticks and arrivals that share the instant — but before those
    report ticks and arrivals;
  * LB report ticks land after step completions (a report observes the state
    the engine just committed) but before arrivals (a coinciding arrival is
    routed on the freshest snapshot the LB could legally have);
  * health-monitor sweeps (DESIGN.md §16) land right after the report ticks
    they judge — the monitor sees the freshest tick at the same instant —
    but before arrivals, so a coinciding arrival is routed against the
    post-detection alive-set;
  * wake-ups (idle-rank retry hops) sort last — they are pure fallbacks.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Any, Optional


class EventKind(enum.IntEnum):
    """Replay event kinds; the integer value is the same-timestamp priority."""
    RANK_FAIL = 0
    RANK_JOIN = 1
    STEP_FORM = 2     # pipelined control plane forms the next batch (§12)
    STEP_DONE = 3
    KV_XFER = 4       # migration payload hits the wire (DESIGN.md §15)
    KV_XFER_DONE = 5  # migration payload lands; install on the target
    LB_REPORT = 6
    HEALTH = 7        # failure-detection sweep + brownout control (§16)
    ARRIVAL = 8
    RANK_WAKE = 9


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    kind: EventKind
    seq: int
    payload: dict

    def __getattr__(self, name: str) -> Any:
        try:
            return self.payload[name]
        except KeyError as e:
            raise AttributeError(name) from e


class EventQueue:
    """Min-heap of events keyed on (time, kind-priority, insertion seq).

    ``pending_work`` counts queued events that can still generate work
    (everything except LB_REPORT/HEALTH ticks and RANK_WAKE fallbacks) — the replay
    loop uses it to decide when the self-perpetuating report ticks should be
    allowed to die out.
    """

    _SELF_PERPETUATING = (EventKind.LB_REPORT, EventKind.HEALTH,
                          EventKind.RANK_WAKE)

    def __init__(self):
        self._heap: list[tuple[float, int, int, Event]] = []
        self._seq = itertools.count()
        self.pending_work = 0

    def push(self, time: float, kind: EventKind, **payload) -> Event:
        ev = Event(time, kind, next(self._seq), payload)
        heapq.heappush(self._heap, (ev.time, int(ev.kind), ev.seq, ev))
        if kind not in self._SELF_PERPETUATING:
            self.pending_work += 1
        return ev

    def pop(self) -> Event:
        _, _, _, ev = heapq.heappop(self._heap)
        if ev.kind not in self._SELF_PERPETUATING:
            self.pending_work -= 1
        return ev

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
