"""Quantized-KV numerics harness (DESIGN.md §14), in PyTorch.

A port of ``src/repro/engine/numerics.py``. Two oracles pin the quantized
data plane against its fp32 twin:

* **KV parity** — ``kv_parity_report`` compares a quantized executor's
  paged K/V (dequantized through its scale pages) against an fp32 executor
  that ran the *identical* plan sequence on identical inputs. Layer 0's
  bound is exact: its K/V depend only on the token embeddings, so both
  executors compute the same fp32 rows and the quantized store differs by
  at most ``row_error_bound`` (half a quantization step of the row absmax).
  Deeper layers compound — layer ``l``'s inputs already carry the previous
  layers' dequantization error through attention and MLP — so their rows
  are reported against the same per-row bound with a caller-supplied slack
  multiple (the empirical envelope the tests document).

* **Scheduling bit-identity** — ``capture_schedule`` records every plan
  the scheduler forms (items, order, kinds), every deferral set the data
  plane reports, and the admission stage's per-tenant VTC counters. Token
  *values* may drift within the §14 bound; token *counts* — the only thing
  the control plane consumes — must not, so two engines differing only in
  ``kv_dtype`` must produce byte-identical traces. ``ModelTimedExecutor``
  makes the comparison well-posed: it runs the real data plane but reports
  the cost model's step time instead of the measured wall clock, so both
  engines advance identical clocks (the real executor's ``perf_counter``
  dt would leak machine noise into scheduling decisions).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.cost_model import LinearCostModel
from ..core.types import BatchPlan
from ..kernels import quant as kvq
from ..kernels.ref import index_pages


# ---------------------------------------------------------------------------
# KV parity: quantized pages vs the fp32 oracle executor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerParity:
    """Per-layer K/V parity of one request (max over tokens/heads/dims)."""
    layer: int
    k_err: float          # max |dequant(k_quant) - k_fp32|
    v_err: float
    k_bound: float        # max per-row row_error_bound of the fp32 rows
    v_bound: float

    def within(self, slack: float = 1.0) -> bool:
        return self.k_err <= slack * self.k_bound \
            and self.v_err <= slack * self.v_bound


def _gather_rows(pages: torch.Tensor, table, n_tokens: int) -> torch.Tensor:
    """pages: (P, page, ...) for one layer; table: page ids → (n, ...)."""
    idx = torch.as_tensor(table, dtype=torch.long, device=pages.device)
    g = index_pages(pages, idx)                   # (n_pages, page, ...)
    return g.reshape(-1, *g.shape[2:])[:n_tokens]


def kv_parity_report(exec_q, exec_ref, req_id: int) -> list[LayerParity]:
    """Per-layer parity of ``req_id``'s cached K/V across two executors.

    ``exec_q`` is quantized (``kv_dtype`` int8/fp8), ``exec_ref`` is fp32;
    both must have executed the identical plan sequence over identical
    request tokens (teacher-forced — a decode fed a *different* sampled
    token would legitimately diverge beyond any quantization bound).
    """
    assert exec_q.qspec is not None and exec_ref.qspec is None, \
        "kv_parity_report compares a quantized executor against an fp32 one"
    spec = exec_q.qspec
    n = exec_q.alloc.context_len(req_id)
    assert n == exec_ref.alloc.context_len(req_id), \
        "executors diverged on context length — plans were not identical"
    tbl_q = exec_q.alloc.tables[req_id]
    stbl = exec_q.alloc.scale_table(req_id)
    tbl_r = exec_ref.alloc.tables[req_id]
    out = []
    for layer in range(exec_q.cfg.n_layers):
        rows = {}
        for name, pages_q, scales_q, pages_r in (
                ("k", exec_q.k_pages, exec_q.k_scales, exec_ref.k_pages),
                ("v", exec_q.v_pages, exec_q.v_scales, exec_ref.v_pages)):
            vals = _gather_rows(pages_q[layer], tbl_q, n)      # (n, Hkv, D)
            scl = _gather_rows(scales_q[layer], stbl, n)       # (n, Hkv)
            deq = kvq.dequantize_kv(vals, scl)
            ref = _gather_rows(pages_r[layer], tbl_r, n).to(deq.device)
            err = float((deq - ref).abs().max())
            bound = float(kvq.row_error_bound(ref, spec).max())
            rows[name] = (err, bound)
        out.append(LayerParity(layer, rows["k"][0], rows["v"][0],
                               rows["k"][1], rows["v"][1]))
    return out


# ---------------------------------------------------------------------------
# scheduling bit-identity: trace capture + deterministic clock
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SchedTrace:
    """Every control-plane decision of one engine run, in order."""
    plans: list = dataclasses.field(default_factory=list)
    deferred: list = dataclasses.field(default_factory=list)

    def fingerprint(self) -> tuple:
        return (tuple(self.plans), tuple(self.deferred))


def capture_schedule(engine) -> SchedTrace:
    """Record every plan the scheduler forms and every deferral set the
    data plane reports. Wraps the live scheduler/executor in place (the
    engine keeps working normally); returns the growing trace."""
    trace = SchedTrace()
    sched, execu = engine.sched, engine.executor
    orig_schedule = sched.schedule

    def schedule(now, tasks):
        plan = orig_schedule(now, tasks)
        trace.plans.append(tuple((it.req_id, it.n_tokens, it.kind.name)
                                 for it in plan.items))
        return plan

    orig_execute = execu.execute

    def execute(plan, requests, now):
        out = orig_execute(plan, requests, now)
        trace.deferred.append(tuple(sorted(execu.last_deferred)))
        return out

    sched.schedule = schedule
    execu.execute = execute
    return trace


def vtc_counters(engine) -> dict:
    """The admission stage's committed per-tenant virtual-token counters
    (empty for non-VTC stacks) — the billing half of the bit-identity
    contract."""
    adm = getattr(engine.sched, "admission", None)
    counters = getattr(adm, "counters", None)
    return dict(counters) if counters is not None else {}


def assert_same_decisions(a: SchedTrace, b: SchedTrace,
                          label: str = "runs") -> None:
    """Byte-identical plans and deferral sets, with the first divergent
    step named on failure."""
    for field in ("plans", "deferred"):
        xs, ys = getattr(a, field), getattr(b, field)
        for i, (x, y) in enumerate(zip(xs, ys)):
            assert x == y, (f"{label} diverged at {field}[{i}]: "
                            f"{x!r} != {y!r}")
        assert len(xs) == len(ys), \
            f"{label}: {field} length {len(xs)} != {len(ys)}"


class ModelTimedExecutor:
    """Real data plane, deterministic clock (DESIGN.md §14).

    Delegates everything to the wrapped real executor but reports the cost
    model's step time (over the items actually served, mirroring the sim
    executor's accounting) instead of the measured wall clock — the engine's
    ``now`` then advances identically across runs that differ only in
    numerics, making scheduling traces comparable bit for bit.
    """

    def __init__(self, inner, model: Optional[LinearCostModel] = None):
        self._inner = inner
        self._model = model or LinearCostModel(a=1e-3, b=1e-4, c=0.0)

    def execute(self, plan: BatchPlan, requests, now):
        _, emitted = self._inner.execute(plan, requests, now)
        served = [it for it in plan.items
                  if it.req_id not in self._inner.last_deferred]
        nt = sum(it.n_tokens for it in served)
        ctx = sum(requests[it.req_id].to_sched_task().cost_context()
                  for it in served)
        return (self._model.step_time(nt, ctx) if nt else 1e-4), emitted

    def __getattr__(self, name):
        return getattr(self._inner, name)
