"""Transformer layer primitives: GQA attention with ring-buffer KV caches,
the gated MLP and the residual FFN block (MLP or MoE). Port of
``src/repro/models/layers.py``; the matrix products stay ``torch.matmul``,
as the JAX package left them to XLA.

KV cache contract (per attention stack; stacks share one window size W):
    k, v   : (L, B, W, Hkv, Dh)  — ring buffer, slot of global pos p = p % W
    kv_pos : (B, W) int32        — global position held in each slot, -1 empty
    (full-attention stacks are the W = max_len special case)

Position-array-driven masking (``attention.py``) makes ring order
irrelevant to correctness — slots carry their global positions, the mask
does the rest. A decode step writes its token into the cache in place,
where JAX's ``.at[].set`` returns new arrays (the serving path donates the
cache, so XLA updates it in place too). ``cross_attn_apply`` is the
encoder-decoder's cross-attention over the encoder memory; the parameter
initializers are subtrees of ``weights.init_params``. ``ATTN_AXES`` and
``MLP_AXES`` are the weights' logical sharding axes, as in JAX; the layers
carry no sharding constraints: under a mesh the paged executor runs the
collectives itself (``distributed.tp``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from .attention import (dense_attention, flash_attention,
                        flash_attention_banded)
from .module import rmsnorm, silu
from .moe import moe_capacity, moe_dense_exact
from .rope import apply_rope


ATTN_AXES = {
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
}


MLP_AXES = {
    "w_gate": ("embed", "ffn"),
    "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def _same(y: torch.Tensor) -> torch.Tensor:
    return y


def layer_ffn(cfg: ArchConfig, lp: dict, x: torch.Tensor,
              moe_impl: str = "exact", experts: Optional[tuple] = None,
              reduce=_same) -> torch.Tensor:
    """Residual FFN block: the gated MLP, or for MoE archs ``moe_impl``'s
    FFN over the flattened tokens — every row of x, padding included, as
    the JAX executor (``_layer_ffn``) and ``DecoderLM`` (``_ffn``) route
    them. Under a mesh ``lp`` holds one rank's FFN columns, or its
    ``experts`` (global ids [lo, hi)), and ``reduce`` sums the partial
    output over the ranks before the residual."""
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        return x + reduce(mlp_apply(lp["mlp"], h))
    moe_fn = moe_capacity if moe_impl == "capacity" else moe_dense_exact
    y = moe_fn(h.reshape(-1, h.shape[-1]), lp["moe"], cfg.moe,
               experts=experts)
    return x + reduce(y.reshape(h.shape))


# --------------------------------------------------------------------------
# KV cache ring-buffer plumbing
# --------------------------------------------------------------------------

def empty_kv_cache(n_layers: int, batch: int, width: int, n_kv: int,
                   head_dim: int, dtype=torch.bfloat16, device=None) -> dict:
    """Zero K/V and empty slots; bf16 by default, as the JAX
    ``empty_kv_cache`` (the models pass their ``cache_dtype``)."""
    shape = (n_layers, batch, width, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kv_pos": torch.full((batch, width), -1, dtype=torch.int32,
                                 device=device)}


def prefill_ring_write(k_new: torch.Tensor, seq_len: int, width: int):
    """Gather indices + positions to store the last `width` of a prefilled
    sequence into ring order. Returns (gather_idx (W,) int64, kv_pos (W,)
    int32) on ``k_new``'s device — shared by every layer/batch."""
    s = torch.arange(width, device=k_new.device)
    if seq_len <= width:
        idx = s % max(seq_len, 1)
        pos = torch.where(s < seq_len, s, -1)
        return idx, pos.to(torch.int32)
    start = seq_len - width
    idx = start + ((s - (start % width)) % width)
    return idx, idx.to(torch.int32)  # position == token index


def write_prefix_cache(k: torch.Tensor, v: torch.Tensor, width: int):
    """k, v: (B, S, Hkv, Dh) freshly-prefilled → ring cache (B, W, Hkv, Dh)
    and kv_pos (B, W)."""
    idx, pos = prefill_ring_write(k, k.shape[1], width)
    return (k.index_select(1, idx), v.index_select(1, idx),
            pos.expand(k.shape[0], width).contiguous())


def decode_ring_write(cache_k, cache_v, kv_pos, k_new, v_new, positions):
    """Insert one token per sequence, in place. cache_*: (B,W,Hkv,Dh);
    k_new: (B,1,...); positions: (B,) global position of the new token.
    Returns the three updated tensors."""
    slot = (positions % cache_k.shape[1]).long()
    b = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[b, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[b, slot] = v_new[:, 0].to(cache_v.dtype)
    kv_pos[b, slot] = positions.to(kv_pos.dtype)
    return cache_k, cache_v, kv_pos


# --------------------------------------------------------------------------
# Attention block apply
# --------------------------------------------------------------------------

def attn_qkv(p: dict, h: torch.Tensor, positions: torch.Tensor,
             cfg: ArchConfig, theta: Optional[float] = None):
    """h: (B, T, d); positions: (B, T). Returns q (B, T, H, D) and k, v
    (B, T, Hkv, D), RoPE applied to q and k."""
    b, t, _ = h.shape
    q = (h @ p["wq"].to(h.dtype)).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (h @ p["wk"].to(h.dtype)).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"].to(h.dtype)).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    th = theta if theta is not None else cfg.rope_theta
    q = apply_rope(q, positions, th)
    k = apply_rope(k, positions, th)
    return q, k, v


def attn_seq(p, x, positions, cfg: ArchConfig, *, window: Optional[int],
             ln_w, impl: str = "flash", flash_block: int = 512,
             banded: bool = False, cache_width: Optional[int] = None,
             causal: bool = True):
    """Full-sequence attention (train / whole-prompt prefill / the
    encoder's non-causal pass). Under ``flash`` a causal windowed layer
    takes the banded path only when ``banded`` (the prefill path, which is
    forward only); in training it runs the differentiable windowed flash.

    Returns (residual output, (k_ring, v_ring, kv_pos) if cache_width else
    None).
    """
    h = rmsnorm(x, ln_w, cfg.norm_eps)
    q, k, v = attn_qkv(p, h, positions, cfg)
    if impl == "flash" and banded and window and causal:
        o = flash_attention_banded(q, k, v, positions, positions,
                                   window=window, block=flash_block)
    elif impl == "flash":
        o = flash_attention(q, k, v, positions, positions, causal=causal,
                            window=window, block=flash_block)
    else:
        o = dense_attention(q, k, v, positions, positions, causal=causal,
                            window=window)
    out = o.reshape(*x.shape[:2], cfg.q_dim) @ p["wo"].to(x.dtype)
    new_cache = None
    if cache_width is not None:
        new_cache = write_prefix_cache(k, v, cache_width)
    return x + out, new_cache


def attn_decode(p, x, positions, cfg: ArchConfig, *, window: Optional[int],
                ln_w, cache_k, cache_v, kv_pos):
    """Single-token decode against a ring cache, which it updates in place.
    x: (B, 1, d)."""
    h = rmsnorm(x, ln_w, cfg.norm_eps)
    q, k, v = attn_qkv(p, h, positions, cfg)
    cache_k, cache_v, kv_pos = decode_ring_write(
        cache_k, cache_v, kv_pos, k, v, positions[:, 0])
    o = dense_attention(q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                        positions, kv_pos, causal=True, window=window)
    out = o.reshape(*x.shape[:2], cfg.q_dim) @ p["wo"].to(x.dtype)
    return x + out, (cache_k, cache_v, kv_pos)


def cross_attn_apply(p, x, memory_kv, memory_pos, positions,
                     cfg: ArchConfig, ln_w):
    """Cross-attention for the encoder-decoder's decoder: x (B, T, d)
    against the encoder memory's precomputed (k, v) (B, S_enc, Hkv, Dh) at
    ``memory_pos`` (B, S_enc), non-causal."""
    h = rmsnorm(x, ln_w, cfg.norm_eps)
    b, t, _ = h.shape
    q = (h @ p["wq"].to(h.dtype)).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k, v = memory_kv
    o = dense_attention(q, k.to(x.dtype), v.to(x.dtype), positions,
                        memory_pos, causal=False)
    out = o.reshape(b, t, cfg.q_dim) @ p["wo"].to(x.dtype)
    return x + out
