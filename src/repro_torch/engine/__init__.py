from .request import Request, RequestState
from .engine import (Engine, EngineConfig, InflightStep, InternalStep,
                     StepRecord)
from .executor import SimExecutor, PagedTransformerExecutor
from .kv_manager import BlockAllocator
from .metrics import RequestMetrics, summarize

__all__ = ["Request", "RequestState", "Engine", "EngineConfig",
           "InflightStep", "InternalStep", "StepRecord",
           "SimExecutor", "PagedTransformerExecutor", "BlockAllocator",
           "RequestMetrics", "summarize"]
