"""Mixture-of-Experts FFN: the exact per-token oracle and the capacity
dispatch.

Port of ``src/repro/models/moe.py``: token-choice top-k routing, gates
softmaxed over the selected experts.

* ``moe_dense_exact`` — every token through every expert, gated combine.
  Exact; the parity path. Its products stay ``torch.matmul``, as the JAX
  package leaves its einsums to XLA.
* ``moe_capacity`` — the production path: sort the token slots by expert,
  gather them into an (E, C, d) dispatch buffer (capacity C per expert,
  overflow dropped), three batched expert GEMMs through
  ``kernels.ops.moe_gmm_op`` (kernel B4 on the card, its plain version on
  the CPU), weighted combine. Token-chunked at ``router_chunk`` by a Python
  loop where the JAX package uses ``lax.map``.

The capacity path is differentiable: ``moe_gmm_op`` is the ``MoeGmm``
Function, so in training B4 also runs the two backward GEMMs of each
expert GEMM.

Dtypes follow ``jnp``: the router and the combine run in fp32, the
output in x's dtype, and each expert product runs in the dtype JAX's
einsum promotes its operands to (``_promoted``): bf16 activations with
fp32 parameters (the launch training opts) in fp32, with bf16 parameters
(the serving opts) in bf16, where ``torch.matmul`` would refuse the mix.

Expert parallelism (``experts=(lo, hi)``, the paged executor under a
mesh): ``params`` then hold experts lo..hi-1 of the global router's E, and
each path returns this rank's part of the output, which an all-reduce over
the ranks completes. ``exact`` weights its experts' per-token outputs by the
global router's gates; ``capacity`` computes the capacity and the dispatch
from the replicated router output and runs B4 over its own experts' rows
of the dispatch buffer only. With the experts replicated and ``expert_ff``
sharded, ``params`` hold a slice of each expert's hidden dim and the same
code returns a partial sum (``experts=None``).

What differs from the JAX package, none of it changing a value: no
``constrain`` sharding hints (under a mesh the executor runs the
collectives itself, ``distributed.tp``) and no ``jax.checkpoint`` around each router chunk (``DecoderLM``
checkpoints whole layers under ``remat``); ties in the router's top-k go to
the lower expert id, by a stable descending sort, as ``lax.top_k`` gives
them; each expert's first sorted slot comes from a search of the sorted ids
instead of a scatter-add of counts; and the combine adds each token's kept
contributions in ascending expert order — the order JAX's scatter-add takes
them in — without atomics, so repeated runs on the card are bitwise equal.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..kernels.ops import moe_gmm_op
from .module import silu


# "exact": the per-token oracle; "capacity": the production dispatch (B4)
MOE_IMPLS = ("exact", "capacity")


MOE_AXES = {
    "router": (None, None),
    "w_gate": ("expert", "embed", "expert_ff"),
    "w_up": ("expert", "embed", "expert_ff"),
    "w_down": ("expert", "expert_ff", "embed"),
}


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` cast to the dtype ``jnp`` promotes a product of the
    two to (a no-op for one that has it already)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Top-k routing. Returns (gates (T, k) f32, experts (T, k) int64)."""
    logits = x.float() @ router.float()
    topv, tope = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, tope = topv[:, :top_k], tope[:, :top_k]
    return torch.softmax(topv, dim=-1), tope


def moe_dense_exact(x: torch.Tensor, params: dict, cfg: MoEConfig,
                    experts: Optional[tuple] = None) -> torch.Tensor:
    """x: (T, d) → (T, d). Computes all experts (those of ``experts``, when
    given); exact oracle."""
    t, _ = x.shape
    gates, tope = _route(x, params["router"], cfg.top_k)
    h = torch.matmul(*_promoted(x, params["w_gate"]))         # (E, T, f)
    u = torch.matmul(*_promoted(x, params["w_up"]))
    y = torch.matmul(*_promoted(silu(h) * u, params["w_down"]))  # (E, T, d)
    # a token's top-k experts are distinct: scatter equals JAX's .at[].add
    dense_gates = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                              device=x.device).scatter_(1, tope, gates)
    if experts is not None:
        dense_gates = dense_gates[:, experts[0]:experts[1]]
    return torch.einsum("te,etd->td", dense_gates,
                        y.float()).to(x.dtype)


def _capacity(chunk_tokens: int, cfg: MoEConfig) -> int:
    """Per-expert capacity. Decode-size chunks (≤512 tokens) use
    4-alignment, larger ones 8-alignment (the JAX package's rule)."""
    c = math.ceil(chunk_tokens * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
    if chunk_tokens <= 512:
        return max(4, -(-c // 4) * 4)
    return max(8, -(-c // 8) * 8)  # 8-aligned, >= 8


class Dispatch(NamedTuple):
    """One chunk's routing, over the T·k token slots sorted by expert
    (stable): ``order`` the sort, ``sg`` each sorted slot's gate (0 for an
    invalid token), ``keep`` whether it got a place in its expert's
    capacity, ``slot`` its row of the (E·C) dispatch buffer (E·C when
    dropped) and ``slot_token`` (E·C,) the token in each buffer row (T,
    the zero pad row, when empty)."""
    order: torch.Tensor
    sg: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    slot_token: torch.Tensor


def dispatch(x: torch.Tensor, valid: torch.Tensor, router: torch.Tensor,
             cfg: MoEConfig, capacity: int) -> Dispatch:
    """Route one chunk x (T, d) and lay its kept slots out by expert."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    gates, tope = _route(x, router, k)
    gates = gates * valid[:, None]
    flat_e = tope.reshape(-1)                             # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]                                    # sorted expert ids
    st = order // k                                       # source token
    sg = gates.reshape(-1)[order]
    # each expert's first sorted slot: cumsum(counts) - counts
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = (pos < capacity) & (sg > 0)
    slot = torch.where(keep, se * capacity + pos, e * capacity)
    # dropped slots all write the last entry, which is cut off
    slot_token = torch.full((e * capacity + 1,), t, dtype=torch.long,
                            device=dev)
    slot_token[slot] = st
    return Dispatch(order, sg, keep, slot, slot_token[:-1])


def _moe_chunk(x: torch.Tensor, valid: torch.Tensor, params: dict,
               cfg: MoEConfig, capacity: int,
               experts: Optional[tuple] = None) -> torch.Tensor:
    """One chunk of the capacity path. x: (T, d); valid: (T,) bool. With
    ``experts=(lo, hi)`` only those experts' rows of the dispatch buffer
    run, and slots routed elsewhere add 0."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    lo, hi = experts or (0, e)
    r0, rows = lo * capacity, (hi - lo) * capacity
    dp = dispatch(x, valid, params["router"], cfg, capacity)
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    xg = x_pad[dp.slot_token[r0:r0 + rows]].reshape(hi - lo, capacity, d)
    h = moe_gmm_op(*_promoted(xg, params["w_gate"]))
    u = moe_gmm_op(*_promoted(xg, params["w_up"]))
    y = moe_gmm_op(*_promoted(silu(h) * u, params["w_down"]))
    y_flat = y.reshape(rows, d).float()

    # combine: out[st] += gate * y[slot], a dropped (or another rank's)
    # slot adding 0
    mine = dp.keep & (dp.slot >= r0) & (dp.slot < r0 + rows)
    contrib = torch.where(mine, dp.sg, 0.0)[:, None] * y_flat[
        (dp.slot - r0).clamp(0, rows - 1)]
    # each token's k sorted positions, ascending: its experts in id order
    where = torch.empty_like(dp.order)
    where[dp.order] = torch.arange(t * k, device=x.device)
    rows = where.view(t, k).sort(dim=1).values
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + contrib[rows[:, j]]
    return out.to(x.dtype)


def moe_capacity(x: torch.Tensor, params: dict, cfg: MoEConfig,
                 valid: Optional[torch.Tensor] = None,
                 experts: Optional[tuple] = None) -> torch.Tensor:
    """Capacity-dispatch MoE over a flat token buffer. x: (T, d) → (T, d).
    Chunks of ``router_chunk`` tokens each get the capacity of a full
    chunk; the last is zero-padded and its pad tokens are invalid.
    ``experts`` as in ``_moe_chunk``."""
    t, _ = x.shape
    if valid is None:
        valid = torch.ones(t, dtype=torch.bool, device=x.device)
    chunk, cap = cfg.router_chunk, chunk_capacity(t, cfg)
    if t <= chunk:
        return _moe_chunk(x, valid, params, cfg, cap, experts)
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    xp = F.pad(x, (0, 0, 0, pad))
    vp = F.pad(valid, (0, pad))
    out = [_moe_chunk(xp[i * chunk:(i + 1) * chunk],
                      vp[i * chunk:(i + 1) * chunk], params, cfg, cap,
                      experts)
           for i in range(n_chunks)]
    return torch.cat(out)[:t]


def router_chunks(n_tokens: int, cfg: MoEConfig) -> int:
    """Chunks ``moe_capacity`` splits ``n_tokens`` into: each runs the
    three expert GEMMs once."""
    return max(1, -(-n_tokens // cfg.router_chunk))


def chunk_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Per-expert capacity C of every chunk ``moe_capacity`` splits
    ``n_tokens`` into: the (E, C, ·) rows of its expert GEMMs."""
    return _capacity(min(n_tokens, cfg.router_chunk), cfg)
