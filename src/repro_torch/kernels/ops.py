"""Dispatch wrappers for the port's kernels.

Backend policy: a kernel wrapper runs its CUDA kernel on CUDA tensors and
its plain PyTorch version (``ref.py``) on CPU tensors; the choice follows
where the tensors lie, never a fallback. Later slices add the remaining
ops of ``src/repro/kernels/ops.py`` here.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .paged_attention import (paged_attention, paged_attention_ragged,
                              paged_attention_ragged_quant)


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


def paged_attention_quant_op(q, k_pages, v_pages, k_scales, v_scales,
                             block_table, scale_table, context_lens,
                             q_starts, *, window: Optional[int] = None):
    """Quantized-KV batched paged attention (DESIGN.md §14): int8/fp8 value
    pages + f32 scale pages. On the card the batch is flattened through
    the ragged quant kernel (one launch), as the JAX package does on the
    TPU: packed starts ``arange(B)·Tq``, ``q_lens = Tq``, ``pos0 =
    q_starts``. On the CPU the batched oracle dequantizes the gathered
    context."""
    if q.device.type == "cpu":
        return ref.paged_attention_quant_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_table,
            scale_table, context_lens, q_starts, window=window)
    b, tq, h, d = q.shape
    packed_starts = torch.arange(b, dtype=torch.int32, device=q.device) * tq
    q_lens = torch.full((b,), tq, dtype=torch.int32, device=q.device)
    out = paged_attention_ragged_quant(
        q.reshape(b * tq, h, d), k_pages, v_pages, k_scales, v_scales,
        block_table, scale_table, context_lens, packed_starts, q_lens,
        q_starts, window=window)
    return out.reshape(b, tq, h, d)


def paged_attention_ragged_quant_op(q, k_pages, v_pages, k_scales, v_scales,
                                    block_tables, scale_tables, context_lens,
                                    q_starts, q_lens, pos0, *,
                                    window: Optional[int] = None):
    """Quantized token-packed ragged paged attention (DESIGN.md §14): the
    fused step's attention under int8/fp8 KV."""
    return paged_attention_ragged_quant(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, scale_tables,
        context_lens, q_starts, q_lens, pos0, window=window)
