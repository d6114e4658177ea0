"""Plain PyTorch versions of the port's kernels.

Same math as the JAX oracles in ``src/repro/kernels/ref.py``, in fp32.
They are the CPU backend of the kernel wrappers and the ground truth the
CUDA kernels are held against on the card (``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

# bytes of gathered per-token K (or V) one chunk of the ragged oracle may
# materialize; rows are independent, so chunking never changes a value
_GATHER_BUDGET = 1 << 28


def paged_gather(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pages: (P, page, Hkv, D); block_table: (B, n_pages) → (B, n_pages*page, Hkv, D)."""
    g = pages[block_table.long()]           # (B, n_pages, page, Hkv, D)
    b, n, p, h, d = g.shape
    return g.reshape(b, n * p, h, d)


def _attend_gathered(q, k, v, context_lens, q_starts, *, window, scale):
    """Core masked-softmax attention over already-gathered per-seq KV.

    q: (B, Tq, H, D); k/v: (B, L, Hkv, D) gathered context. Row (b, t)
    sits at q_pos = q_starts[b] + t and sees every kv_pos with kv_pos <
    context_lens[b], kv_pos <= q_pos and, with a window, q_pos - kv_pos <
    window; a row with no visible key gives 0.
    """
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    dev = q.device
    kv_pos = torch.arange(k.shape[1], device=dev)[None, :]          # (1, L)
    q_pos = (q_starts.long()[:, None]
             + torch.arange(tq, device=dev)[None, :])               # (B, Tq)
    valid = kv_pos < context_lens.long()[:, None]                   # (B, L)
    mask = valid[:, None, :] & (kv_pos[:, None, :] <= q_pos[..., None])
    if window is not None:
        mask &= (q_pos[..., None] - kv_pos[:, None, :]) < window
    qf = q.reshape(b, tq, hkv, g, d).float()
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    m = mask[:, None, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    o = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return o.reshape(b, tq, h, d).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_table, context_lens,
                        q_starts, *, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Reference batched paged attention (decode AND chunked prefill).

    q: (B, Tq, H, D)       — Tq = 1 for decode, = chunk for prefill chunks
    k_pages/v_pages: (P, page, Hkv, D)
    block_table: (B, n_pages) int32 — page ids per sequence
    context_lens: (B,) int32 — total tokens in cache (incl. current chunk)
    q_starts: (B,) int32 — global position of q[:, 0]
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    k = paged_gather(k_pages, block_table)                 # (B, L, Hkv, D)
    v = paged_gather(v_pages, block_table)
    return _attend_gathered(q, k, v, context_lens, q_starts,
                            window=window, scale=scale)


def paged_attention_ragged_ref(q, k_pages, v_pages, block_tables,
                               context_lens, q_starts, q_lens, pos0,
                               *, window: Optional[int] = None,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Reference token-packed ragged paged attention (fused hybrid step).

    One packed query stream carries every sequence of the step — prefill
    chunks and decode tokens alike (DESIGN.md §11):

    q: (T, H, D)           — packed stream; seq s owns rows
                             [q_starts[s], q_starts[s] + q_lens[s])
    k_pages/v_pages: (P, page, Hkv, D)
    block_tables: (S, n_pages) int32 — page ids per sequence
    context_lens: (S,) int32 — tokens in cache incl. this step's (0 = pad seq)
    q_starts: (S,) int32 — packed-stream offset of each sequence
    q_lens: (S,) int32   — query tokens per sequence (0 = pad seq)
    pos0: (S,) int32     — global position of each sequence's first query

    Rows not owned by any sequence (stream padding) return zeros. The rows
    are processed in chunks that bound the per-token gathered context.
    """
    t, _, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k = paged_gather(k_pages, block_tables)                # (S, L, Hkv, D)
    v = paged_gather(v_pages, block_tables)
    row_bytes = max(k[0].numel() * k.element_size(), 1)
    chunk = max(1, _GATHER_BUDGET // row_bytes)
    outs = [_attend_ragged_gathered(q[r0:r0 + chunk], k, v, context_lens,
                                    q_starts, q_lens, pos0, window=window,
                                    scale=scale, row0=r0)
            for r0 in range(0, t, chunk)]
    return torch.cat(outs) if len(outs) != 1 else outs[0]


def _attend_ragged_gathered(q, k, v, context_lens, q_starts, q_lens, pos0,
                            *, window, scale, row0: int = 0):
    """Ragged attention core over per-sequence gathered KV (S, L, Hkv, D).
    ``q`` holds stream rows ``[row0, row0 + len(q))``."""
    t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    dev = q.device
    q_starts, q_lens = q_starts.long(), q_lens.long()
    tok = row0 + torch.arange(t, device=dev)
    owns = ((tok[None, :] >= q_starts[:, None])
            & (tok[None, :] < (q_starts + q_lens)[:, None]))    # (S, T)
    token_seq = torch.argmax(owns.to(torch.int32), dim=0)       # (T,)
    owned = owns.any(dim=0)                                     # (T,)
    k = k[token_seq]                                       # (T, L, Hkv, D)
    v = v[token_seq]
    s_len = k.shape[1]
    q_pos = pos0.long()[token_seq] + tok - q_starts[token_seq]  # (T,)
    kv_pos = torch.arange(s_len, device=dev)[None, :]           # (1, L)
    mask = (owned[:, None]
            & (kv_pos < context_lens.long()[token_seq][:, None])
            & (kv_pos <= q_pos[:, None]))
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos) < window
    qf = q.reshape(t, hkv, g, d).float()
    s = torch.einsum("thgd,tlhd->thgl", qf, k.float()) * scale
    m = mask[:, None, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    o = torch.einsum("thgl,tlhd->thgd", p, v.float())
    return o.reshape(t, h, d).to(q.dtype)
