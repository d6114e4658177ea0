"""Transformer layer primitives the serving step uses: the QKV projection
with RoPE and the gated MLP. Port of ``attn_qkv`` and ``mlp_apply`` in
``src/repro/models/layers.py``; the matrix products stay ``torch.matmul``,
as the JAX package left them to XLA."""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from .module import silu
from .rope import apply_rope


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


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
