"""Speculative-decode support the engine needs (DESIGN.md §18).

Only ``AcceptanceEWMA`` so far: the engine's horizon guard prices
speculative rounds with it. The draft adapters and the speculative round
body are a later slice of the port.

``AcceptanceEWMA`` is the capacity layer's pessimistic acceptance estimator:
cold start sits at the floor, measured collapses are adopted *immediately*
(min with the raw rate), improvements smooth in — overstating acceptance is
the only way ``commit_horizon`` could bust a TPOT envelope, so the estimator
is one-sided by design.
"""
from __future__ import annotations

from typing import Optional


class AcceptanceEWMA:
    """Pessimistic one-sided EWMA of the per-draft acceptance rate.

    ``value`` is what ``commit_horizon`` prices emission with; it must never
    run ahead of reality, so updates are asymmetric: a measured rate BELOW
    the current estimate replaces it outright (``min``), a rate above it
    only pulls the estimate up at ``alpha`` speed. ``floor`` is the
    cold-start value (0.0 = fully pessimistic: speculative rounds earn no
    extra emission allowance until measured).
    """

    def __init__(self, floor: float = 0.0, alpha: float = 0.3):
        self.floor = floor
        self.alpha = alpha
        self._v: Optional[float] = None

    @property
    def value(self) -> float:
        return self.floor if self._v is None else max(self.floor, self._v)

    def update(self, accepted: int, drafted: int) -> None:
        if drafted <= 0:
            return
        m = accepted / drafted
        prev = m if self._v is None else self._v
        self._v = min(m, self.alpha * m + (1.0 - self.alpha) * prev)
