"""Step-level schedulers as preconfigured policy stacks (DESIGN.md §13).

Every named scheduler is a ``core.policy.SchedulerStack`` — an
admission → capacity → formation pipeline — preconfigured to reproduce its
paper's behaviour. All stacks implement ``schedule(now, tasks) -> BatchPlan``
over the same ``SchedTask`` views, so engines/simulators/benchmarks swap
them freely, and any stack can additionally take a per-tenant VTC admission
stage (``vtc=True`` in ``make_scheduler``) without touching its capacity or
formation behaviour.

Systems reproduced:
  * ``VLLMVanillaScheduler``   — prefill-prioritizing FCFS with a large
    max-BS (vLLM default / v1 FIFO behaviour).
  * ``SarathiScheduler``       — stall-free batching: every active decode is
    in every batch; remaining *token* budget goes to chunked prefills.
  * ``FairBatchingScheduler``  — the paper. Variants for the Fig-7 ablation
    ladder are flags: FB-FixBatch (``budget_mode="fixed"``), FB-TokenBudget
    (``budget_mode="token"``), FB-vanilla (``budget_mode="time"``).

With FCFS admission (the default) each stack is bit-identical to the
pre-stack monolithic scheduler it replaced — pinned by
tests/test_policy.py.
"""
from __future__ import annotations

from typing import Optional

from .batch_formation import FormationConfig
from .cost_model import LinearCostModel
from .policy import (AdaptiveTimeCapacity, AdmissionPolicy, BrownoutPolicy,
                     FairFormation, FixedBatchCapacity, PrefillFirstFormation,
                     Scheduler, SchedulerStack, StallFreeFormation,
                     TokenBudgetCapacity, UncappedCapacity, VTCAdmission)


class FairBatchingScheduler(SchedulerStack):
    """The paper's scheduler as a stack. ``budget_mode``:

    - "time"  (FB-vanilla): adaptive time budget from decode slack (§3.2).
    - "token" (FB-TB ablation): slack converted to a token budget through the
      token-only model (context term ignored when sizing the batch).
    - "fixed" (FB-FB ablation): Sarathi-style fixed token budget; only the
      3-group formation of §3.3 is active.
    """

    def __init__(self, model: LinearCostModel,
                 formation: Optional[FormationConfig] = None,
                 budget_mode: str = "time", calibrate: bool = True,
                 fixed_token_budget: int = 512,
                 cold_start_safety: float = 0.7, warmup_obs: int = 32,
                 admission: Optional[AdmissionPolicy] = None):
        assert budget_mode in ("time", "token", "fixed")
        self.budget_mode = budget_mode
        self.formation = formation or FormationConfig()
        self.fixed_token_budget = fixed_token_budget
        cap = {
            "time": lambda: AdaptiveTimeCapacity(
                self.formation, cold_start_safety, warmup_obs),
            "token": lambda: TokenBudgetCapacity(
                self.formation, cold_start_safety, warmup_obs),
            "fixed": lambda: FixedBatchCapacity(
                fixed_token_budget, self.formation, cold_start_safety,
                warmup_obs),
        }[budget_mode]()
        name = {"time": "fairbatching", "token": "fb-token-budget",
                "fixed": "fb-fix-batch"}[budget_mode]
        super().__init__(name, model, admission=admission,
                         capacity_policy=cap, formation=FairFormation(),
                         calibrate=calibrate)


class SarathiScheduler(SchedulerStack):
    """Stall-free batching (Sarathi) as a stack.

    ``token_budget`` is the tuned hyperparameter (paper: "best tuned for each
    testcase"); benchmarks sweep it.
    """

    def __init__(self, model: LinearCostModel, token_budget: int = 512,
                 calibrate: bool = True,
                 admission: Optional[AdmissionPolicy] = None):
        self.token_budget = token_budget
        super().__init__("sarathi", model, admission=admission,
                         capacity_policy=UncappedCapacity(),
                         formation=StallFreeFormation(token_budget),
                         calibrate=calibrate)


class VLLMVanillaScheduler(SchedulerStack):
    """Prefill-prioritizing FCFS with a large max-BS (vLLM default) as a
    stack."""

    def __init__(self, model: LinearCostModel,
                 max_num_batched_tokens: int = 8192, calibrate: bool = True,
                 admission: Optional[AdmissionPolicy] = None):
        self.max_tokens = max_num_batched_tokens
        super().__init__("vllm-vanilla", model, admission=admission,
                         capacity_policy=UncappedCapacity(),
                         formation=PrefillFirstFormation(
                             max_num_batched_tokens),
                         calibrate=calibrate)


def make_scheduler(name: str, model: LinearCostModel, *,
                   vtc: bool = False, vtc_weights: Optional[dict] = None,
                   vtc_burst_tokens: int = 1024, brownout: bool = False,
                   brownout_grace: float = 0.0, **kw) -> Scheduler:
    """Factory used by configs/CLI: name in
    {vllm-vanilla, sarathi, fairbatching, fb-token-budget, fb-fix-batch}.

    ``vtc=True`` swaps the stack's admission stage from FCFS to per-tenant
    VTC fair queuing (DESIGN.md §13): ``vtc_weights`` maps tenant → service
    weight (default 1.0) and ``vtc_burst_tokens`` bounds how far a tenant's
    virtual counter may run ahead of the floor before its prefills are held.
    Orthogonal to the capacity/formation stages — every named stack accepts
    it.

    ``brownout=True`` attaches the overload-shedding stage (DESIGN.md §16):
    while the cluster broadcasts fleet saturation, deadline-infeasible
    prefills are terminated per-tenant-fairly instead of burning budget on
    guaranteed SLO misses; ``brownout_grace`` extends the deadline test.
    Also orthogonal — any stack, with or without VTC, can shed.
    """
    if vtc:
        kw["admission"] = VTCAdmission(weights=vtc_weights,
                                       burst_tokens=vtc_burst_tokens)
    if name == "vllm-vanilla":
        sched = VLLMVanillaScheduler(model, **kw)
    elif name == "sarathi":
        sched = SarathiScheduler(model, **kw)
    elif name == "fairbatching":
        sched = FairBatchingScheduler(model, budget_mode="time", **kw)
    elif name == "fb-token-budget":
        sched = FairBatchingScheduler(model, budget_mode="token", **kw)
    elif name == "fb-fix-batch":
        sched = FairBatchingScheduler(model, budget_mode="fixed", **kw)
    else:
        raise ValueError(f"unknown scheduler: {name!r}")
    if brownout:
        sched.brownout = BrownoutPolicy(grace=brownout_grace)
    return sched
