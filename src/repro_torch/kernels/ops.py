"""Dispatch wrappers for the port's kernels.

Backend policy: a kernel wrapper runs its CUDA kernel on CUDA tensors and
its plain PyTorch version (``ref.py``) on CPU tensors; the choice follows
where the tensors lie, never a fallback. This module is the port's one
dispatch table, the counterpart of ``src/repro/kernels/ops.py``: the
executor and the models reach every kernel through an op here, even where
the op only forwards to its wrapper. Later slices add the remaining ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .mamba2_scan import MambaChunkScan
from .moe_gmm import MoeGmm
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


def moe_gmm_op(x, w):
    """(E, C, K) × (E, K, N) batched expert GEMM — the capacity-dispatch MoE
    FFN's gate, up and down projections. Kernel B4 masks the ragged edges,
    so C, K and N are not padded to 128 as on the TPU. Differentiable
    (``MoeGmm``: the two backward GEMMs are B4 too); without grad it is
    one ``moe_gmm`` call."""
    return MoeGmm.apply(x, w)


def mamba_chunk_scan_op(xdt, a_dt, b, c, init_state=None, y_dtype=None):
    """SSD chunk scan over pre-chunked inputs (kernel B5): xdt (B, NC, L,
    H, P), a_dt (B, NC, L, H), b and c (B, NC, L, N), init_state (B, H, P,
    N) or None for zeros. Returns (y (B, NC, L, H, P) in ``y_dtype``
    (xdt's if None), the final state (B, H, P, N) fp32, the model
    convention), what the model's ``ssd_chunked`` computes. The inputs are made contiguous here (``b`` and ``c`` are
    split views of the conv output); unlike the TPU op this one takes an
    initial state, which ``mamba_seq`` seeds from its cache.
    Differentiable (``MambaChunkScan``: its backward is B5's backward
    kernel); without grad it is one ``mamba_chunk_scan`` launch."""
    return MambaChunkScan.apply(
        xdt.contiguous(), a_dt.contiguous(), b.contiguous(), c.contiguous(),
        None if init_state is None else init_state.contiguous(), y_dtype)
