"""Per-batch execution-time models (paper §3.2).

The paper's linear model:

    batch_time = a + b * total_new_tokens + c * total_context

`a` is fixed launch/step overhead, `b` the per-new-token (FLOP-side) cost and
`c` the per-context-token (KV-cache HBM traffic) cost. It is fit offline and
continuously calibrated online; the paper reports token-only estimation errs
by ±5.2% vs ±1.3% for the linear model.

TPU adaptation: XLA compiles fixed step shapes, so the engine pads
``total_new_tokens`` up to a bucket. ``PaddedCostModel`` charges the padded
size — the analogue of the paper's CUDA-graph-size-driven token budget.

With a prefix cache (DESIGN.md §10) the engine's per-step observations
already reflect reuse: ``new_tokens`` counts only computed (uncached)
tokens while ``context`` includes cache-served pages, so the online RLS
calibration fits the hardware's true effective-token cost surface with no
cache-awareness of its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

from .types import SchedTask


@dataclasses.dataclass
class LinearCostModel:
    """batch_time = a + b*new_tokens + c*context  (seconds)."""

    a: float
    b: float
    c: float

    def task_cost(self, new_tokens: int, context: int) -> float:
        """Marginal cost of adding a task to a batch (no `a`; paid once)."""
        return self.b * new_tokens + self.c * context

    def step_time(self, total_new_tokens: int, total_context: int) -> float:
        if total_new_tokens <= 0:
            return 0.0
        return self.a + self.b * total_new_tokens + self.c * total_context

    def step_time_for(self, tasks: Sequence[tuple[int, int]]) -> float:
        """tasks: (new_tokens, context) pairs."""
        nt = sum(t for t, _ in tasks)
        ctx = sum(c for _, c in tasks)
        return self.step_time(nt, ctx)

    def tokens_within(self, time_budget: float, context: int = 0) -> int:
        """Max new tokens processable within `time_budget` at given context.

        Used by the PAB derivation (T_prefill = R_prefill / (b+c)).
        """
        t = time_budget - self.a - self.c * context
        if t <= 0 or self.b <= 0:
            return 0
        return int(t / self.b)


@dataclasses.dataclass
class TokenCostModel(LinearCostModel):
    """Strawman token-only model (paper's ±5.2% baseline; FB-TB ablation).

    Same calibrated (a, b) but charges nothing for context.
    """

    def __init__(self, a: float, b: float):
        super().__init__(a=a, b=b, c=0.0)


def per_shard_model(model: LinearCostModel, n_shards: int) -> LinearCostModel:
    """The cost model one shard of an ``n_shards``-way tensor-parallel step
    sees (DESIGN.md §17).

    Matmul FLOPs and KV HBM traffic partition across the model axis, so the
    per-token (``b``) and per-context (``c``) coefficients divide by the
    shard count; the fixed launch overhead ``a`` is paid once per step on
    every shard, not amortized. Collective time is folded into ``a`` by the
    online RLS calibration — at serving scale the per-layer all-reduce is
    latency-bound, so a constant is the right shape.

    Scheduler budgets stay expressed in wall-clock per step; dividing the
    marginal coefficients is what lets the same SLO budget admit ~n_shards
    times the compute-bound token load (the TP scaling bench's roofline).
    Derived classes (``PaddedCostModel``/``TokenCostModel``) keep their type
    so padding semantics survive sharding.
    """
    n = max(int(n_shards), 1)
    if n == 1:
        return model
    if isinstance(model, TokenCostModel):       # custom (a, b) __init__
        return TokenCostModel(a=model.a, b=model.b / n)
    return dataclasses.replace(model, b=model.b / n, c=model.c / n)


# HBM bytes per stored KV element by storage format (DESIGN.md §14). Kept
# string-keyed so the scheduler core stays free of array-library imports.
_KV_ELT_BYTES = {"fp32": 4, "float32": 4, "fp16": 2, "bf16": 2,
                 "int8": 1, "fp8_e4m3": 1}
_KV_QUANTIZED = frozenset({"int8", "fp8_e4m3"})


def kv_bytes_per_token(n_layers: int, n_kv_heads: int, head_dim: int,
                       kv_dtype: str = "fp32", scale_bytes: int = 4,
                       tp: int = 1) -> int:
    """HBM bytes one cached token occupies across K and V (DESIGN.md §14).

    Quantized formats (int8 / fp8-e4m3) store 1 byte per element plus one
    f32 dequantization scale per (token, kv-head) row for EACH of K and V —
    the scale pages carried by ``BlockAllocator`` — so int8 is a ~3.9x (not
    4x) byte reduction vs fp32 at head_dim 128. This is the number PAB and
    commit-horizon capacity math must use for the page budget to stay
    correct at ~2-4x quantized capacity.

    ``tp`` asks for ONE shard's bytes under tensor parallelism: the KV
    pools shard on the kv-head axis (DESIGN.md §17), so each device stores
    ``n_kv_heads / tp`` head rows (and their scales). Page IDs and counts
    stay global — only the per-page byte footprint shrinks, which is why
    ``kv_page_budget`` against a single shard's HBM uses this number.
    """
    heads = max(1, n_kv_heads // max(int(tp), 1))
    elt = _KV_ELT_BYTES[kv_dtype]
    per = 2 * n_layers * heads * head_dim * elt               # K and V
    if kv_dtype in _KV_QUANTIZED:
        per += 2 * n_layers * heads * scale_bytes             # scale rows
    return per


def kv_page_budget(hbm_bytes: int, page_size: int,
                   bytes_per_token: int) -> int:
    """KV pages of ``page_size`` tokens that fit in ``hbm_bytes``.

    Feed ``kv_bytes_per_token`` in: at equal HBM, int8 KV funds roughly
    double the fp16 page count — the capacity gain the quantized-capacity
    end-to-end test (tests/test_preemption.py) measures as fewer
    preemptions and a higher prefix-cache hit rate.
    """
    if page_size <= 0 or bytes_per_token <= 0:
        return 0
    return int(hbm_bytes // (page_size * bytes_per_token))


@dataclasses.dataclass
class LinkModel:
    """Point-to-point interconnect cost for KV-page migration (DESIGN.md §15).

    ``transfer_time`` is the classic latency + size/bandwidth model: one
    fixed per-transfer launch cost (RDMA/NCCL setup, control messages) plus
    the serialized byte stream at effective link bandwidth. Defaults are a
    conservative intra-pod RDMA NIC (~25 GB/s effective, 100 us launch);
    the disagg bench sweeps these to trace the transfer-vs-recompute
    breakeven curve.
    """

    latency: float = 100e-6        # per-transfer launch cost (seconds)
    bandwidth: float = 25e9        # effective bytes/second

    def transfer_time(self, n_bytes: int) -> float:
        return self.latency + max(0, n_bytes) / self.bandwidth


def default_buckets(max_tokens: int = 8192) -> list[int]:
    """Power-of-two token buckets, 128-aligned — XLA compiled-shape set."""
    buckets = []
    v = 128
    while v < max_tokens:
        buckets.append(v)
        v *= 2
    buckets.append(max_tokens)
    return buckets


@dataclasses.dataclass
class PaddedCostModel(LinearCostModel):
    """Linear model that charges the padded (bucketed) token count.

    TPU engines run a fixed set of compiled hybrid-step shapes; a step with
    N new tokens executes the smallest bucket >= N and pays for the pad.
    """

    buckets: Sequence[int] = dataclasses.field(default_factory=default_buckets)

    def pad(self, n: int) -> int:
        for bkt in self.buckets:
            if n <= bkt:
                return bkt
        return self.buckets[-1]

    def step_time(self, total_new_tokens: int, total_context: int) -> float:
        if total_new_tokens <= 0:
            return 0.0
        return self.a + self.b * self.pad(total_new_tokens) + self.c * total_context


class RecursiveLeastSquares:
    """Online calibration of (a, b, c) with a forgetting factor.

    Observation model: t = [1, new_tokens, context] · theta. RLS keeps a 3x3
    covariance; O(1) per update, no numpy dependency in the hot path. The
    paper fits offline then "continuously calibrates" — this is that loop.
    """

    def __init__(self, theta0: tuple[float, float, float] = (1e-3, 1e-5, 1e-8),
                 p0: float = 1e4, forgetting: float = 0.995):
        self.theta = list(theta0)
        self.P = [[p0 if i == j else 0.0 for j in range(3)] for i in range(3)]
        self.lam = forgetting
        self.n_obs = 0

    def update(self, new_tokens: int, context: int, observed_time: float) -> None:
        x = [1.0, float(new_tokens), float(context)]
        # P x
        Px = [sum(self.P[i][j] * x[j] for j in range(3)) for i in range(3)]
        denom = self.lam + sum(x[i] * Px[i] for i in range(3))
        k = [Px[i] / denom for i in range(3)]
        pred = sum(self.theta[i] * x[i] for i in range(3))
        err = observed_time - pred
        for i in range(3):
            self.theta[i] += k[i] * err
        # P = (P - k x^T P) / lam
        xP = [sum(x[i] * self.P[i][j] for i in range(3)) for j in range(3)]
        for i in range(3):
            for j in range(3):
                self.P[i][j] = (self.P[i][j] - k[i] * xP[j]) / self.lam
        self.n_obs += 1

    def model(self, floor: tuple[float, float, float] = (0.0, 1e-9, 0.0)) -> LinearCostModel:
        a, b, c = (max(v, f) for v, f in zip(self.theta, floor))
        return LinearCostModel(a=a, b=b, c=c)


def fit_linear(samples: Iterable[tuple[int, int, float]]) -> LinearCostModel:
    """Offline least-squares fit from (new_tokens, context, time) samples.

    Solves the 3x3 normal equations directly (no numpy needed — callers in
    the scheduler hot path must stay dependency-free).
    """
    sx = [[0.0] * 3 for _ in range(3)]
    sy = [0.0] * 3
    n = 0
    for nt, ctx, t in samples:
        x = [1.0, float(nt), float(ctx)]
        for i in range(3):
            for j in range(3):
                sx[i][j] += x[i] * x[j]
            sy[i] += x[i] * t
        n += 1
    if n < 3:
        raise ValueError(f"need >=3 samples to fit, got {n}")
    theta = _solve3(sx, sy)
    return LinearCostModel(a=max(theta[0], 0.0), b=max(theta[1], 1e-12),
                           c=max(theta[2], 0.0))


def _solve3(m: list[list[float]], y: list[float]) -> list[float]:
    """Gaussian elimination with partial pivoting for the 3x3 system."""
    a = [row[:] + [yy] for row, yy in zip(m, y)]
    for col in range(3):
        piv = max(range(col, 3), key=lambda r: abs(a[r][col]))
        if abs(a[piv][col]) < 1e-30:
            raise ValueError("singular normal equations (degenerate samples)")
        a[col], a[piv] = a[piv], a[col]
        for r in range(3):
            if r != col:
                f = a[r][col] / a[col][col]
                for k in range(col, 4):
                    a[r][k] -= f * a[col][k]
    return [a[i][3] / a[i][i] for i in range(3)]


def batch_totals(tasks: Sequence[SchedTask], granted: dict[int, int]) -> tuple[int, int]:
    """(total_new_tokens, total_cost_context) for tasks with granted tokens."""
    nt = 0
    ctx = 0
    for t in tasks:
        g = granted.get(t.req_id, 0)
        if g > 0:
            nt += g
            ctx += t.cost_context()
    return nt, ctx
