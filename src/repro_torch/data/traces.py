"""Synthetic production traces matching the paper's §5.1 workloads.

The paper evaluates on BurstGPT, the Qwen-Bailian anonymous trace, and the
Azure LLM inference trace 2024, characterized by Table 2 (prompt/output
length avg & p90, SLOs) and Figure 4 (bursty arrivals). The raw traces are
not redistributable, so we generate statistically matched synthetics:

  * lengths — lognormal fitted to (avg, p90) exactly (closed form);
  * arrivals — Markov-modulated Poisson (on/off bursts): the paper's Figure
    1/2 unfairness phenomenon only appears when prefill demand alternates
    between idle and burst, so the burst factor is first-class here.

Replaying at scaling factor `rps` rescales arrival rate, like the paper's
load sweep.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    arrival: float
    prompt_len: int
    output_len: int
    # Per-request SLO class (heterogeneous-tier scenarios); None inherits
    # the engine/cluster default.
    ttft_slo: float | None = None
    tpot_slo: float | None = None
    # Prompt token ids for content-locality scenarios (multi-turn,
    # shared-sysprompt): the prefix cache (DESIGN.md §10) and CacheAwareLB
    # match on them. None = lengths-only trace (cache never hits).
    # Invariant when present: len(tokens) == prompt_len.
    tokens: tuple[int, ...] | None = None
    # Owning tenant/client (DESIGN.md §13): keys the scheduler stack's
    # per-tenant VTC counters and the per-tenant metrics rollup. The
    # default collapses every request into one tenant — fairness between
    # tenants then never binds, preserving pre-tenant behaviour.
    tenant: str = "default"


@dataclasses.dataclass(frozen=True)
class TraceProfile:
    name: str
    prompt_avg: float
    prompt_p90: float
    output_avg: float
    output_p90: float
    ttft_slo: float
    tpot_slo: float
    burst_factor: float = 4.0   # burst rate / mean rate
    burst_frac: float = 0.25    # fraction of time in burst state


# Paper Table 2 lengths/SLOs; burstiness tuned so that sub-peak loads are
# feasible and bursts create transient (not unbounded) prefill queues —
# the regime of the paper's Figures 1/4/5.
TRACE_PROFILES = {
    "burstgpt": TraceProfile("burstgpt", 688, 1599, 237, 470, 0.5, 0.05,
                             burst_factor=2.5, burst_frac=0.2),
    "qwentrace": TraceProfile("qwentrace", 892, 1776, 377, 742, 0.5, 0.05,
                              burst_factor=2.0, burst_frac=0.3),
    "azuretrace": TraceProfile("azuretrace", 1604, 3561, 114, 392, 2.0, 0.05,
                               burst_factor=1.8, burst_frac=0.35),
}


def _lognormal_params(avg: float, p90: float) -> tuple[float, float]:
    """mu, sigma with E[X]=avg and P90[X]=p90 (z90 = 1.2816)."""
    z = 1.281551565545
    ratio = math.log(p90 / avg)
    disc = z * z - 2.0 * ratio
    sigma = z - math.sqrt(max(disc, 0.0)) if disc > 0 else z
    mu = math.log(avg) - sigma * sigma / 2.0
    return mu, sigma


def make_trace(profile: str | TraceProfile, *, rps: float, duration: float,
               seed: int = 0, min_len: int = 4) -> list[TraceRequest]:
    p = TRACE_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    # Markov-modulated Poisson: two states (calm, burst) with mean rate rps.
    rate_burst = p.burst_factor * rps
    rate_calm = max((1 - p.burst_frac * p.burst_factor) / (1 - p.burst_frac),
                    0.05) * rps
    mean_sojourn = {True: 1.5, False: 4.0}   # seconds in burst / calm
    reqs = []
    t, burst = 0.0, False
    state_end = rng.exponential(mean_sojourn[burst])
    mu_p, sg_p = _lognormal_params(p.prompt_avg, p.prompt_p90)
    mu_o, sg_o = _lognormal_params(p.output_avg, p.output_p90)
    while t < duration:
        rate = rate_burst if burst else rate_calm
        dt = rng.exponential(1.0 / max(rate, 1e-9))
        if t + dt > state_end:
            t = state_end
            burst = not burst
            state_end = t + rng.exponential(mean_sojourn[burst])
            continue
        t += dt
        plen = max(min_len, int(rng.lognormal(mu_p, sg_p)))
        olen = max(2, int(rng.lognormal(mu_o, sg_o)))
        reqs.append(TraceRequest(t, plen, olen))
    return reqs


def scale_trace(reqs: list[TraceRequest], factor: float) -> list[TraceRequest]:
    """Speed up arrivals by `factor` (paper's load-scaling replay)."""
    return [dataclasses.replace(r, arrival=r.arrival / factor) for r in reqs]


# ---------------------------------------------------------------------------
# scenario generators beyond the paper's MMPP traces — used by the
# event-driven replay harness (DESIGN.md §8) to stress coordination paths
# the Table-2 profiles don't reach
# ---------------------------------------------------------------------------


def _sample_lengths(rng, p: TraceProfile, n: int,
                    min_len: int = 4) -> list[tuple[int, int]]:
    mu_p, sg_p = _lognormal_params(p.prompt_avg, p.prompt_p90)
    mu_o, sg_o = _lognormal_params(p.output_avg, p.output_p90)
    return [(max(min_len, int(rng.lognormal(mu_p, sg_p))),
             max(2, int(rng.lognormal(mu_o, sg_o)))) for _ in range(n)]


def make_gamma_trace(profile: str | TraceProfile = "qwentrace", *,
                     rps: float, duration: float, seed: int = 0,
                     cv: float = 2.5) -> list[TraceRequest]:
    """Bursty Gamma-renewal arrivals (squared-CV clumping).

    Inter-arrival gaps are Gamma with shape k = 1/cv² and mean 1/rps, so
    ``cv`` > 1 produces heavy clumps followed by long silences — a harsher
    burst shape than the two-state MMPP of ``make_trace`` because bursts have
    no characteristic sojourn time. cv = 1 degenerates to Poisson.
    """
    p = TRACE_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (max(rps, 1e-9) * shape)       # mean gap = 1/rps
    reqs, t = [], 0.0
    while True:
        t += rng.gamma(shape, scale)
        if t >= duration:
            break
        (plen, olen), = _sample_lengths(rng, p, 1)
        reqs.append(TraceRequest(t, plen, olen))
    return reqs


# (name, ttft_slo, tpot_slo, mix weight): interactive chat, standard API
# traffic, and latency-tolerant batch/agent jobs sharing one fleet.
SLO_CLASSES = (
    ("interactive", 0.3, 0.03, 0.3),
    ("standard", 0.5, 0.05, 0.5),
    ("relaxed", 2.0, 0.15, 0.2),
)


def make_slo_class_trace(profile: str | TraceProfile = "qwentrace", *,
                         rps: float, duration: float, seed: int = 0,
                         classes=SLO_CLASSES) -> list[TraceRequest]:
    """Heterogeneous SLO tiers multiplexed onto one Poisson arrival stream.

    Each request is tagged with its class's (ttft_slo, tpot_slo); schedulers
    see them through ``SchedTask`` and must honor the tightest active tier
    (the per-request floor in §3.2's capacity rule). Exercises envelope
    tracking with non-uniform deadlines, which the paper's evaluation holds
    constant.
    """
    p = TRACE_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    weights = np.array([c[3] for c in classes], dtype=float)
    weights /= weights.sum()
    reqs, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / max(rps, 1e-9))
        if t >= duration:
            break
        _, ttft, tpot, _ = classes[int(rng.choice(len(classes), p=weights))]
        (plen, olen), = _sample_lengths(rng, p, 1)
        reqs.append(TraceRequest(t, plen, olen, ttft_slo=ttft, tpot_slo=tpot))
    return reqs


def make_longcontext_trace(profile: str | TraceProfile = "qwentrace", *,
                           rps: float, duration: float, seed: int = 0,
                           long_frac: float = 0.15, long_avg: float = 12_000,
                           long_p90: float = 28_000) -> list[TraceRequest]:
    """Long-context-heavy mixture: a base profile plus a heavy tail of
    document-scale prompts (RAG / code-repo workloads).

    A ``long_frac`` fraction of requests draws its prompt from a second
    lognormal with ~10–30k-token prompts, stressing exactly the regime where
    FB-TokenBudget's context-blind sizing mis-estimates (paper Fig 7) and
    where a single admitted prefill can consume a whole PAB.
    """
    p = TRACE_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    mu_l, sg_l = _lognormal_params(long_avg, long_p90)
    reqs, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / max(rps, 1e-9))
        if t >= duration:
            break
        (plen, olen), = _sample_lengths(rng, p, 1)
        if rng.random() < long_frac:
            plen = max(plen, int(rng.lognormal(mu_l, sg_l)))
        reqs.append(TraceRequest(t, plen, olen))
    return reqs


_VOCAB = 50_000   # synthetic token-id space for content-bearing scenarios


def _rand_tokens(rng, n: int) -> tuple[int, ...]:
    return tuple(int(t) for t in rng.integers(1, _VOCAB, size=n))


def make_multiturn_trace(profile: str | TraceProfile = "qwentrace", *,
                         rps: float, duration: float, seed: int = 0,
                         max_turns: int = 6, think_mean: float = 6.0,
                         user_frac: float = 0.25) -> list[TraceRequest]:
    """Multi-turn conversations resubmitting their growing history.

    Each conversation opens with a fresh prompt; every later turn's prompt is
    the full previous history (prior prompt + a synthesized assistant
    response) plus a new user message — the canonical prefix-cache workload:
    turn k+1 re-prefills everything turn k computed unless a radix cache
    (DESIGN.md §10) serves the shared history. Turn gaps are exponential
    "think times", so the trace stays open-loop and seeded-deterministic.
    Conversation starts arrive Poisson at a rate chosen so total request
    rate ≈ ``rps`` given the mean turn count.
    """
    p = TRACE_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    mu_o, sg_o = _lognormal_params(p.output_avg, p.output_p90)
    avg_turns = (1 + max_turns) / 2
    conv_rate = max(rps / avg_turns, 1e-9)
    reqs, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / conv_rate)
        if t >= duration:
            break
        n_turns = int(rng.integers(1, max_turns + 1))
        (first_len, _), = _sample_lengths(rng, p, 1)
        history = _rand_tokens(rng, first_len)
        arr = t
        for turn in range(n_turns):
            if arr >= duration:
                break
            olen = max(2, int(rng.lognormal(mu_o, sg_o)))
            reqs.append(TraceRequest(arr, len(history), olen,
                                     tokens=history))
            # next turn resubmits history + synthesized response + new user
            # message (response ids are synthetic stand-ins: the sim engine
            # does not generate real tokens, but the *resubmitted* ids are
            # identical across turns, which is all prefix matching needs)
            user_len = max(4, int(user_frac * first_len))
            history = history + _rand_tokens(rng, olen) \
                + _rand_tokens(rng, user_len)
            arr += rng.exponential(think_mean)
    reqs.sort(key=lambda r: r.arrival)
    return reqs


def make_shared_sysprompt_trace(profile: str | TraceProfile = "qwentrace", *,
                                rps: float, duration: float, seed: int = 0,
                                n_sysprompts: int = 24, zipf_a: float = 1.1,
                                sys_len: int = 512) -> list[TraceRequest]:
    """Zipf-distributed pool of shared system prompts + unique user suffixes.

    Production API traffic is dominated by a small set of hot system prompts
    (agents, RAG templates); each request here draws one of ``n_sysprompts``
    fixed ``sys_len``-token prefixes with Zipf(``zipf_a``) popularity and
    appends a fresh user message. Under a radix prefix cache every request
    after the first per sysprompt prefills only its suffix — the scenario
    behind the cache-affinity-vs-fairness routing trade (DESIGN.md §10).
    """
    p = TRACE_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    pool = [_rand_tokens(rng, sys_len) for _ in range(n_sysprompts)]
    weights = 1.0 / np.arange(1, n_sysprompts + 1) ** zipf_a
    weights /= weights.sum()
    reqs, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / max(rps, 1e-9))
        if t >= duration:
            break
        sysp = pool[int(rng.choice(n_sysprompts, p=weights))]
        (plen, olen), = _sample_lengths(rng, p, 1)
        user = _rand_tokens(rng, max(4, plen - sys_len))
        tokens = sysp + user
        reqs.append(TraceRequest(t, len(tokens), olen, tokens=tokens))
    return reqs


def make_multitenant_adversarial_trace(
        profile: str | TraceProfile = "qwentrace", *, rps: float,
        duration: float, seed: int = 0, n_interactive: int = 3,
        flood_factor: float = 6.0, flood_prompt_scale: float = 4.0,
        interactive_ttft: float = 0.5,
        interactive_tpot: float = 0.05) -> list[TraceRequest]:
    """One flooding batch tenant vs. several interactive tenants
    (DESIGN.md §13) — the workload per-tenant VTC admission exists for.

    ``n_interactive`` tenants ("user0".."userN") submit short interactive
    prompts as independent Poisson streams that together carry ``rps``.
    Tenant "flood" additionally fires ``flood_factor`` × one interactive
    tenant's rate with prompts ``flood_prompt_scale`` × longer — the
    prompt-burst pattern that crowds interactive prefills out of an FCFS
    batch queue. Per-tenant fairness should keep the interactive tenants'
    TTFT near their isolated-run baseline; FCFS lets the flood win (the
    acceptance bound asserted in tests/test_policy.py).
    """
    p = TRACE_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    reqs: list[TraceRequest] = []
    per_tenant_rps = rps / max(n_interactive, 1)
    for i in range(n_interactive):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / max(per_tenant_rps, 1e-9))
            if t >= duration:
                break
            (plen, olen), = _sample_lengths(rng, p, 1)
            reqs.append(TraceRequest(t, plen, olen,
                                     ttft_slo=interactive_ttft,
                                     tpot_slo=interactive_tpot,
                                     tenant=f"user{i}"))
    t = 0.0
    flood_rps = flood_factor * per_tenant_rps
    while True:
        t += rng.exponential(1.0 / max(flood_rps, 1e-9))
        if t >= duration:
            break
        # batch-job shape: long prompts, terse outputs — the prefill-bound
        # pattern that crowds an FCFS batch queue (decode residency is
        # deliberately small; running decodes are never gated by admission)
        (plen, olen), = _sample_lengths(rng, p, 1)
        reqs.append(TraceRequest(t, int(plen * flood_prompt_scale),
                                 max(2, olen // 8), tenant="flood"))
    reqs.sort(key=lambda r: r.arrival)
    return reqs


# scenario registry: name -> generator(rps=..., duration=..., seed=...).
# `make_trace` partials cover the paper's Table-2 MMPP workloads; the rest
# are the beyond-paper stress scenarios above.
SCENARIOS = {
    **{name: (lambda name: (lambda **kw: make_trace(name, **kw)))(name)
       for name in TRACE_PROFILES},
    "bursty-gamma": make_gamma_trace,
    "slo-classes": make_slo_class_trace,
    "long-context": make_longcontext_trace,
    "multi-turn": make_multiturn_trace,
    "shared-sysprompt": make_shared_sysprompt_trace,
    "multi-tenant-adversarial": make_multitenant_adversarial_trace,
}


def make_scenario(name: str, *, rps: float, duration: float,
                  seed: int = 0, **kw) -> list[TraceRequest]:
    """Generate a named scenario (see ``SCENARIOS``) — the CLI entry point."""
    try:
        gen = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(choose from {sorted(SCENARIOS)})") from None
    return gen(rps=rps, duration=duration, seed=seed, **kw)
