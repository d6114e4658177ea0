"""Dispatch wrappers for the port's kernels.

Backend policy: a kernel wrapper runs its CUDA kernel on CUDA tensors and
its plain PyTorch version (``ref.py``) on CPU tensors; the choice follows
where the tensors lie, never a fallback. Later slices add the remaining
ops of ``src/repro/kernels/ops.py`` here.
"""
from __future__ import annotations

from typing import Optional

from .paged_attention import paged_attention, paged_attention_ragged


def paged_attention_op(q, k_pages, v_pages, block_table, context_lens,
                       q_starts, *, window: Optional[int] = None):
    """Batched paged attention (decode Tq=1 / verify Tq=γ+1 / prefill-chunk
    Tq=chunk). q: (B, Tq, H, D); ``q_starts`` the global position of
    q[:, 0]."""
    return paged_attention(q, k_pages, v_pages, block_table, context_lens,
                           q_starts, window=window)


def paged_attention_ragged_op(q, k_pages, v_pages, block_tables, context_lens,
                              q_starts, q_lens, pos0, *,
                              window: Optional[int] = None):
    """Token-packed ragged paged attention — the fused hybrid step's single
    attention launch per layer (DESIGN.md §11). q: (T, H, D) packed
    stream."""
    return paged_attention_ragged(q, k_pages, v_pages, block_tables,
                                  context_lens, q_starts, q_lens, pos0,
                                  window=window)
