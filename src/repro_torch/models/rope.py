"""Rotary position embeddings, position-array driven (works for contiguous
prefill and ragged hybrid batches alike). Port of ``src/repro/models/rope.py``:
half-split rotation, fp32 frequencies."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T), integer.

    Invalid slots (position < 0) are rotated by |pos|, which is harmless: the
    attention mask excludes them.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    ang = positions.float()[..., None, None] * freqs              # (..., T,1,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
