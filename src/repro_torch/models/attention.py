"""Attention over position arrays: the dense oracle and blocked flash, in
PyTorch.

Port of ``src/repro/models/attention.py``. One masking rule serves every
layout ``DecoderLM`` runs: a contiguous prefill, single-token decode over a
ring-buffer cache (full or sliding window), and a banded sliding-window
prefill.

    mask = (kv_pos >= 0)                                  # slot validity
         & (kv_pos <= q_pos)            if causal
         & (q_pos - kv_pos < window)    if sliding window

The JAX functions are plain XLA ops, not a Pallas kernel, and so are these:
``einsum`` products and, for flash, a Python loop over KV blocks with the
online softmax where JAX scans. The block structure is kept so that the
log-sum-exp, the ``-1e30`` masking and the banded slicing are the
reference's. ``merge_partial_attention`` is the one the split-KV kernel
references use (``kernels/ref.py``).

``flash_attention`` is differentiable: ``FlashAttention``, a
``torch.autograd.Function``, is the port of the JAX custom VJP
(``_flash_vjp_fwd``/``_flash_vjp_bwd``), a FlashAttention-2-style backward
that keeps q, k, v, the positions, the output and the log-sum-exp and
recomputes each KV block's probabilities from the log-sum-exp, so nothing
of size (Tq, Tk) outlives a block. Its scores are the forward's, the
pre-scaled query times the keys, so that the recomputed probabilities are
the forward's to the last bit; the scale then enters dq and dk once, as
JAX's ``ds · scale`` does. ``flash_attention_with_lse`` and
``flash_attention_banded`` stay forward only, as in JAX. The ``unroll``
switch of the JAX costing parts has no counterpart: the loop over KV
blocks runs eagerly, so ``launch.cost_analysis`` sees every block.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the flash-decoding merge over disjoint KV shards is the kernels' own
from ..kernels.ref import merge_partial_attention  # noqa: F401

NEG_INF = -1e30


def attn_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """(B, Tq, Tk) boolean mask from global position arrays."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & ((q - k) < window)
    return m


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, t, h, d = q.shape
    return q.reshape(b, t, n_kv, h // n_kv, d)


def dense_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Reference attention. q: (B,Tq,H,D); k,v: (B,Tk,Hkv,D) → (B,Tq,H,D),
    and with ``return_lse`` the log-sum-exp (B,Tq,H).

    Materializes (B,Hkv,G,Tq,Tk) scores — short prompts and decode only.
    """
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qf = _split_gqa(q, hkv).float()
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    m = attn_mask(q_pos, kv_pos, causal=causal, window=window)[:, None, None]
    s = torch.where(m, s, NEG_INF)
    smax = s.amax(dim=-1, keepdim=True)
    p = torch.where(m, torch.exp(s - smax), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bshd->bthgd", p / l.clamp_min(1e-30),
                       v.float())
    out = out.reshape(b, tq, h, d).to(q.dtype)
    if return_lse:
        lse = smax[..., 0] + torch.log(l[..., 0].clamp_min(1e-30))
        return out, lse.permute(0, 3, 1, 2).reshape(b, tq, h)
    return out


def _flash_fwd_impl(q, k, v, q_pos, kv_pos, causal, window, block, scale):
    """Blocked attention with the online softmax over KV blocks of
    ``block`` keys (the last padded with invalid slots). Returns (out
    (B,Tq,H,D), lse (B,Tq,H))."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nb = -(-tk // block)
    pad = nb * block - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    qf = _split_gqa(q, hkv).float() * scale
    m = torch.full((b, tq, hkv, g), NEG_INF, device=q.device)
    l = torch.zeros((b, tq, hkv, g), device=q.device)
    acc = torch.zeros((b, tq, hkv, g, d), device=q.device)
    for i in range(nb):
        blk = slice(i * block, (i + 1) * block)
        s = torch.einsum("bthgd,bshd->bthgs", qf, k[:, blk].float())
        msk = attn_mask(q_pos, kv_pos[:, blk], causal=causal,
                        window=window)[:, :, None, None]      # (B,Tq,1,1,Bk)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bthgs,bshd->bthgd", p, v[:, blk].float())
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(b, tq, h, d)
    lse = (m + torch.log(l.clamp_min(1e-30))).reshape(b, tq, h)
    return out.to(q.dtype), lse


def _blocks(t: torch.Tensor, nb: int, block: int, fill=0) -> torch.Tensor:
    """Dim 1 of ``t`` padded with ``fill`` to ``nb`` whole blocks."""
    pad = nb * block - t.shape[1]
    if not pad:
        return t
    spec = (0, 0) * (t.dim() - 2) + (0, pad)
    return F.pad(t, spec, value=fill)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the JAX package's recomputing backward.

    Forward saves (q, k, v, q_pos, kv_pos, out, lse); backward walks the
    same KV blocks (the last padded with invalid slots), with delta =
    sum(dO · O) per query row: p = exp(s - lse) masked, dV = pᵀ dO, dP =
    dO Vᵀ, dS = p (dP - delta), dQ += dS K · scale, dK = dSᵀ Q · scale.
    The positions get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, block, scale):
        out, lse = _flash_fwd_impl(q, k, v, q_pos, kv_pos, causal, window,
                                   block, scale)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.opts = (causal, window, block, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        causal, window, block, scale = ctx.opts
        b, tq, h, d = q.shape
        tk, hkv = k.shape[1], k.shape[2]
        g = h // hkv
        nb = -(-tk // block)
        kp, vp = _blocks(k, nb, block), _blocks(v, nb, block)
        posp = _blocks(kv_pos, nb, block, fill=-1)
        qs = _split_gqa(q, hkv).float() * scale      # the forward's scores
        do = _split_gqa(dout, hkv).float()
        lse_r = lse.reshape(b, tq, hkv, g)
        delta = (do * _split_gqa(out, hkv).float()).sum(-1)   # (B,Tq,Hkv,G)
        dq = torch.zeros((b, tq, hkv, g, d), device=q.device)
        dks, dvs = [], []
        for i in range(nb):
            blk = slice(i * block, (i + 1) * block)
            k_b, v_b = kp[:, blk].float(), vp[:, blk].float()
            s = torch.einsum("bthgd,bshd->bthgs", qs, k_b)
            msk = attn_mask(q_pos, posp[:, blk], causal=causal,
                            window=window)[:, :, None, None]
            p = torch.where(msk, torch.exp(s - lse_r[..., None]), 0.0)
            dvs.append(torch.einsum("bthgs,bthgd->bshd", p, do))
            dp = torch.einsum("bthgd,bshd->bthgs", do, v_b)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bthgs,bshd->bthgd", ds, k_b) * scale
            dks.append(torch.einsum("bthgs,bthgd->bshd", ds, qs))
        dk = torch.cat(dks, 1)[:, :tk]
        dv = torch.cat(dvs, 1)[:, :tk]
        return (dq.reshape(b, tq, h, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None, None)


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: Optional[int] = None, block: int = 512,
                    scale: Optional[float] = None):
    """Differentiable blocked flash attention (``FlashAttention``). Shapes
    as ``dense_attention``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window,
                                block, scale)


def flash_attention_with_lse(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                             window: Optional[int] = None, block: int = 512,
                             scale: Optional[float] = None):
    """Forward-only flash returning (out, lse) — for context-parallel
    merge."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _flash_fwd_impl(q, k, v, q_pos, kv_pos, causal, window, block,
                           scale)


def flash_attention_banded(q, k, v, q_pos, kv_pos, *, window: int,
                           q_block: int = 512, block: int = 512,
                           scale: Optional[float] = None):
    """Sliding-window flash that only computes the live KV band.

    Each block of ``q_block`` queries attends to the (window + q_block)-wide
    KV band it can see, so a window-W layer costs O(S·W) instead of O(S²).
    Plain flash runs instead when the band covers every key, the queries
    are not whole blocks, or queries and keys differ in length (the JAX
    function's fall-back). Forward only (the serving prefill path).
    """
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    band = window + q_block
    if band >= tk or tq % q_block or tq != tk:
        return flash_attention(q, k, v, q_pos, kv_pos, causal=True,
                               window=window, block=block, scale=scale)
    outs = []
    for qb in range(tq // q_block):
        rows = slice(qb * q_block, (qb + 1) * q_block)
        start = min(max(qb * q_block + q_block - band, 0), tk - band)
        cols = slice(start, start + band)
        o, _ = _flash_fwd_impl(q[:, rows], k[:, cols], v[:, cols],
                               q_pos[:, rows], kv_pos[:, cols], True, window,
                               block, scale)
        outs.append(o)
    return torch.cat(outs, dim=1)
