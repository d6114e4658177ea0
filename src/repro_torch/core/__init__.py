"""FairBatching core: the paper's contribution, engine-agnostic.

Public API re-exports. See DESIGN.md §1 for the contribution → module map.
"""
from .types import SchedTask, TaskKind, BatchItem, BatchPlan
from .slo import token_deadline, request_deadline, slack, attainment
from .cost_model import (LinearCostModel, TokenCostModel, PaddedCostModel,
                         RecursiveLeastSquares, fit_linear, default_buckets,
                         kv_bytes_per_token, kv_page_budget)
from .capacity import commit_horizon, init_time_budget, min_tpot_slo
from .batch_formation import (FormationConfig, classify, form_batch,
                              form_prefill_first, form_stall_free)
from .pab import prefill_admission_budget, PABAdmissionController
from .policy import (AdaptiveTimeCapacity, AdmissionPolicy, CapacityPolicy,
                     FCFSAdmission, FairFormation, FixedBatchCapacity,
                     FormationPolicy, PrefillFirstFormation, Scheduler,
                     SchedulerStack, StallFreeFormation, TokenBudgetCapacity,
                     UncappedCapacity, VTCAdmission)
from .schedulers import (FairBatchingScheduler, SarathiScheduler,
                         VLLMVanillaScheduler, make_scheduler)

__all__ = [
    "SchedTask", "TaskKind", "BatchItem", "BatchPlan",
    "token_deadline", "request_deadline", "slack", "attainment",
    "LinearCostModel", "TokenCostModel", "PaddedCostModel",
    "RecursiveLeastSquares", "fit_linear", "default_buckets",
    "kv_bytes_per_token", "kv_page_budget",
    "commit_horizon", "init_time_budget", "min_tpot_slo",
    "FormationConfig", "classify", "form_batch",
    "form_stall_free", "form_prefill_first",
    "prefill_admission_budget", "PABAdmissionController",
    "SchedulerStack", "AdmissionPolicy", "CapacityPolicy", "FormationPolicy",
    "FCFSAdmission", "VTCAdmission",
    "AdaptiveTimeCapacity", "TokenBudgetCapacity", "FixedBatchCapacity",
    "UncappedCapacity",
    "FairFormation", "StallFreeFormation", "PrefillFirstFormation",
    "Scheduler", "FairBatchingScheduler", "SarathiScheduler",
    "VLLMVanillaScheduler", "make_scheduler",
]
