"""SLO metrics (paper §2.2 / §5.1 evaluation definitions)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .request import Request, RequestState


@dataclasses.dataclass
class RequestMetrics:
    req_id: int
    arrival: float
    ttft: Optional[float]
    tpot_max: Optional[float]      # max running TPOT (worst-case gen rate)
    ttft_ok: bool
    tpot_ok: bool
    rejected: bool = False
    prompt_len: int = 0
    cached_tokens: int = 0         # prompt tokens served by the prefix cache
    # arrival -> first inclusion in a launched batch (DESIGN.md §12): the
    # control-plane wait a pipelined scheduler is supposed to hide
    sched_delay: Optional[float] = None
    # owning tenant (DESIGN.md §13) for the per-tenant fairness rollup
    tenant: str = "default"
    # KV evictions this request absorbed (preemption subsystem, §13)
    preemptions: int = 0
    # brownout overload shedding (DESIGN.md §16): terminated without
    # service because it could no longer make its deadline fleet-wide
    shed: bool = False
    # fault recoveries (re-dispatch off a dead rank / KV-transfer retries)
    retries: int = 0

    @property
    def slo_ok(self) -> bool:
        return (self.ttft_ok and self.tpot_ok and not self.rejected
                and not self.shed)


def measure(req: Request) -> RequestMetrics:
    if req.state is RequestState.REJECTED:
        return RequestMetrics(req.req_id, req.arrival, None, None, False,
                              False, rejected=True,
                              prompt_len=req.prompt_len,
                              cached_tokens=req.cached_context,
                              tenant=req.tenant, retries=req.retries)
    if req.state is RequestState.SHED:
        return RequestMetrics(req.req_id, req.arrival, None, None, False,
                              False, shed=True,
                              prompt_len=req.prompt_len,
                              cached_tokens=req.cached_context,
                              tenant=req.tenant, retries=req.retries)
    ot = req.output_times
    ttft = (ot[0] - req.arrival) if ot else None
    tpot_max = None
    if len(ot) > 1:
        tpot_max = max((ot[j] - ot[0]) / j for j in range(1, len(ot)))
    ttft_ok = ttft is not None and ttft <= req.ttft_slo
    tpot_ok = tpot_max is None or tpot_max <= req.tpot_slo
    delay = (req.first_scheduled - req.arrival
             if req.first_scheduled is not None else None)
    return RequestMetrics(req.req_id, req.arrival, ttft, tpot_max,
                          ttft_ok, tpot_ok, prompt_len=req.prompt_len,
                          cached_tokens=req.cached_context,
                          sched_delay=delay, tenant=req.tenant,
                          preemptions=req.preemptions, retries=req.retries)


def summarize(metrics: list[RequestMetrics], duration: float,
              host: Optional[dict] = None) -> dict:
    """Aggregate per-request metrics; ``host`` optionally merges the
    engine-level control-plane counters (``Engine.host_stats``:
    dispatches / host-overhead seconds / steps / rollbacks — DESIGN.md §12)
    into the summary so benchmarks see one dict."""
    n = len(metrics)
    ok = sum(m.slo_ok for m in metrics)
    ttfts = np.array([m.ttft for m in metrics if m.ttft is not None])
    tpots = np.array([m.tpot_max for m in metrics if m.tpot_max is not None])
    delays = np.array([m.sched_delay for m in metrics
                       if m.sched_delay is not None])

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else float("nan")
    out = {
        "n_requests": n,
        "slo_attainment": ok / max(n, 1),
        "violation_rate": 1.0 - ok / max(n, 1),
        "effective_rps": ok / max(duration, 1e-9),
        "rps": n / max(duration, 1e-9),
        "ttft_p50": pct(ttfts, 50), "ttft_p95": pct(ttfts, 95),
        "ttft_p99": pct(ttfts, 99),
        "tpot_p50": pct(tpots, 50), "tpot_p95": pct(tpots, 95),
        "tpot_p99": pct(tpots, 99),
        "rejected": sum(m.rejected for m in metrics),
        # prefix-cache reuse (DESIGN.md §10): token hit rate over all prompts
        "cache_hit_tokens": int(sum(m.cached_tokens for m in metrics)),
        "cache_hit_rate": (sum(m.cached_tokens for m in metrics)
                           / max(sum(m.prompt_len for m in metrics), 1)),
        # control-plane wait before first service (DESIGN.md §12)
        "sched_delay_p50": pct(delays, 50),
        "sched_delay_p99": pct(delays, 99),
        "sched_delay_mean": float(np.mean(delays)) if len(delays) else
                            float("nan"),
    }
    # terminal request status (DESIGN.md §16): every request ends exactly
    # once as completed | rejected | shed — the three always sum to n
    out["shed"] = sum(m.shed for m in metrics)
    out["completed"] = n - out["rejected"] - out["shed"]
    out["retried"] = sum(1 for m in metrics if m.retries > 0)
    retry_hist: dict[str, int] = {}
    for m in metrics:
        if m.retries > 0:
            retry_hist[str(m.retries)] = retry_hist.get(str(m.retries), 0) + 1
    if retry_hist:
        out["retry_hist"] = dict(sorted(retry_hist.items()))
    tenants = sorted({m.tenant for m in metrics})
    if len(tenants) > 1:
        # per-tenant fairness rollup (DESIGN.md §13): only materialized for
        # multi-tenant traces so single-tenant summaries stay unchanged
        out["per_tenant"] = {t: _tenant_summary(
            [m for m in metrics if m.tenant == t]) for t in tenants}
    if host is not None:
        out.update(host)
    return out


def _tenant_summary(ms: list[RequestMetrics]) -> dict:
    """TTFT/TPOT percentiles + attainment for one tenant's requests."""
    ttfts = np.array([m.ttft for m in ms if m.ttft is not None])
    tpots = np.array([m.tpot_max for m in ms if m.tpot_max is not None])

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else float("nan")
    return {
        "n_requests": len(ms),
        "slo_attainment": sum(m.slo_ok for m in ms) / max(len(ms), 1),
        "ttft_p50": pct(ttfts, 50), "ttft_p99": pct(ttfts, 99),
        "tpot_p50": pct(tpots, 50), "tpot_p99": pct(tpots, 99),
        "rejected": sum(m.rejected for m in ms),
        "preemptions": sum(m.preemptions for m in ms),
        "shed": sum(m.shed for m in ms),
    }
