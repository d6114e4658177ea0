"""Chaos engineering for the serving stack (DESIGN.md §16): seeded
fault plans, tick-silence failure detection, and fault-injecting
executor wrappers."""
from .executor import ChaosExecutor
from .health import HealthConfig, HealthMonitor
from .plan import FaultPlan, u01

__all__ = ["ChaosExecutor", "FaultPlan", "HealthConfig", "HealthMonitor",
           "u01"]
