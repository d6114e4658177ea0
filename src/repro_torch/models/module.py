"""Model primitives shared by every layer: RMSNorm and SiLU.

Port of ``src/repro/models/module.py``. Parameters are plain dicts of
tensors, in the JAX package's layout.
"""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``1 + w`` scale (zero-initialised norm weights),
    computed in fp32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
