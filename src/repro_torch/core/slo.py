"""Envelope-line SLO tracking (paper §3.1).

For SLO targets (TTFT, TPOT), any output-time series that satisfies them lies
inside an envelope whose outermost boundary is

    token_ddl(i, j) = arrival_i + ttft_slo + tpot_slo * j

The deadline of a *request* is the deadline of its next output token, and the
slack is how far that deadline lies in the future. Unlike TBT, this metric is
monotone: emitting any token earlier can only improve compliance — which is
the property that makes slack a fair currency between prefill and decode.
"""
from __future__ import annotations

from .types import SchedTask


def token_deadline(arrival: float, ttft_slo: float, tpot_slo: float, j: int) -> float:
    """Deadline of the j-th output token (j=0 is the first token)."""
    return arrival + ttft_slo + tpot_slo * j


def request_deadline(task: SchedTask) -> float:
    return token_deadline(task.arrival, task.ttft_slo, task.tpot_slo, task.next_output_idx)


def slack(task: SchedTask, now: float) -> float:
    """Seconds until the next output token violates its envelope deadline.

    Positive slack = the request is ahead of its SLO; negative = already late.
    """
    return request_deadline(task) - now


def attainment(output_times: list[float], arrival: float, ttft_slo: float,
               tpot_slo: float) -> tuple[bool, bool]:
    """(ttft_ok, tpot_ok) for a finished request.

    TPOT uses the paper's evaluation definition: the max running TPOT over all
    output tokens j>=1, i.e. worst-case average generation rate.
    """
    if not output_times:
        return False, False
    ttft = output_times[0] - arrival
    ttft_ok = ttft <= ttft_slo
    tpot_ok = True
    for j in range(1, len(output_times)):
        tpot_j = (output_times[j] - output_times[0]) / j
        if tpot_j > tpot_slo:
            tpot_ok = False
            break
    return ttft_ok, tpot_ok
