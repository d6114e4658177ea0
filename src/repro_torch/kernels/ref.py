"""Plain PyTorch versions of the port's kernels.

Same math as the JAX oracles in ``src/repro/kernels/ref.py``, in fp32.
They are the CPU backend of the kernel wrappers and the ground truth the
CUDA kernels are held against on the card (``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .quant import raw_pool

NEG_INF = -1e30

# bytes of gathered per-token K (or V) one chunk of the ragged oracle may
# materialize; rows are independent, so chunking never changes a value
_GATHER_BUDGET = 1 << 28


def index_pages(pages: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pages[idx]`` over the leading dim, through ``raw_pool``."""
    return raw_pool(pages)[idx.long()].view(pages.dtype)


def paged_gather(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pages: (P, page, Hkv, D); block_table: (B, n_pages) → (B, n_pages*page, Hkv, D)."""
    g = index_pages(pages, block_table)     # (B, n_pages, page, Hkv, D)
    b, n, p, h, d = g.shape
    return g.reshape(b, n * p, h, d)


def paged_gather_scales(scale_pages: torch.Tensor,
                        scale_table: torch.Tensor) -> torch.Tensor:
    """scale_pages: (P, page, Hkv); scale_table: (B, n_pages)
    → (B, n_pages*page, Hkv). The scale-row companion of ``paged_gather``
    (DESIGN.md §14)."""
    g = scale_pages[scale_table.long()]     # (B, n_pages, page, Hkv)
    b, n, p, h = g.shape
    return g.reshape(b, n * p, h)


def _dequant_gather(pages, scale_pages, table, scale_table) -> torch.Tensor:
    """The gathered context of quantized pages, dequantized in f32."""
    return (paged_gather(pages, table).float()
            * paged_gather_scales(scale_pages, scale_table)[..., None])


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


def paged_attention_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                              block_table, scale_table, context_lens,
                              q_starts, *, window: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Quantized-KV oracle (DESIGN.md §14): dequantize the gathered context
    with per-(token, kv-head) scales, then run the exact fp32 reference math.

    k_pages/v_pages: (P, page, Hkv, D) int8/fp8; k_scales/v_scales:
    (Ps, page, Hkv) f32 scale pages; scale_table: (B, n_pages) parallel to
    block_table (``BlockAllocator.scale_table``).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    k = _dequant_gather(k_pages, k_scales, block_table, scale_table)
    v = _dequant_gather(v_pages, v_scales, block_table, scale_table)
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
    k = paged_gather(k_pages, block_tables)                # (S, L, Hkv, D)
    v = paged_gather(v_pages, block_tables)
    return _attend_ragged_chunked(q, k, v, context_lens, q_starts, q_lens,
                                  pos0, window=window, scale=scale)


def paged_attention_ragged_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                                     block_tables, scale_tables, context_lens,
                                     q_starts, q_lens, pos0,
                                     *, window: Optional[int] = None,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Quantized token-packed ragged oracle (DESIGN.md §14): dequantize each
    sequence's gathered context with its scale pages, then run the exact
    fp32 ragged reference math. scale_tables: (S, n_pages) parallel to
    block_tables. The plain version of kernel B2."""
    k = _dequant_gather(k_pages, k_scales, block_tables, scale_tables)
    v = _dequant_gather(v_pages, v_scales, block_tables, scale_tables)
    return _attend_ragged_chunked(q, k, v, context_lens, q_starts, q_lens,
                                  pos0, window=window, scale=scale)


def _attend_ragged_chunked(q, k, v, context_lens, q_starts, q_lens, pos0,
                           *, window, scale):
    """``_attend_ragged_gathered`` over chunks of stream rows that bound
    the per-token gathered context; rows are independent, so chunking
    never changes a value."""
    t, _, d = q.shape
    scale = scale if scale is not None else d ** -0.5
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
