"""Discrete-event simulation core (DESIGN.md §8).

``replay(trace, scheduler=..., n_ranks=..., lb=...)`` is the one entry point
benchmarks and examples use for seeded, bit-reproducible multi-replica runs.
"""
from .events import Event, EventKind, EventQueue
from .replay import ReplayResult, drive, replay

__all__ = ["Event", "EventKind", "EventQueue", "ReplayResult", "drive",
           "replay"]
