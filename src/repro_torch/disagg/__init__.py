"""Disaggregated prefill/decode serving with live KV-page migration
(DESIGN.md §15): pool split + migration control loop (``pools``), KV
capture/transfer/install primitives and the recompute fallback
(``migration``), and the two-stage fairness-aware router (``router``)."""
from .migration import (KVPayload, MigrationTicket, breakeven_tokens,
                        capture_kv, install_kv_pages, migrate_out)
from .pools import DisaggConfig, DisaggController, KVGeometry
from .router import DisaggRouter

__all__ = ["KVPayload", "MigrationTicket", "breakeven_tokens", "capture_kv",
           "install_kv_pages", "migrate_out", "DisaggConfig",
           "DisaggController", "KVGeometry", "DisaggRouter"]
