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


def merge_partial_attention(outs: torch.Tensor,
                            lses: torch.Tensor) -> torch.Tensor:
    """Combine partial attention over disjoint key shards (the
    flash-decoding merge; the JAX ``models/attention.py::
    merge_partial_attention``). outs: (P, ..., D) each shard's normalized
    output; lses: (P, ...) its log-sum-exp. A shard a row sees no key of
    carries lse = NEG_INF and weighs nothing; a row with no key in any
    shard merges to 0."""
    m = lses.max(dim=0).values
    w = torch.exp(lses - m)
    num = (outs.float() * w[..., None]).sum(dim=0)
    return (num / w.sum(dim=0).clamp_min(1e-30)[..., None]).to(outs.dtype)


def _attend_range(q, k, v, q_pos, kv_pos, *, window, scale):
    """(out, lse) of rows q (R, H, D) at positions q_pos over the keys k, v
    (L, Hkv, D) at kv_pos, causal and windowed; a row with no visible key
    gives (0, NEG_INF)."""
    r, h, d = q.shape
    hkv = k.shape[1]
    mask = kv_pos[None, :] <= q_pos[:, None]                    # (R, L)
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    s = torch.einsum("rhgd,lhd->rhgl", q.reshape(r, hkv, h // hkv, d),
                     k) * scale
    m = mask[:, None, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    mx = s.max(dim=-1, keepdim=True).values
    p = torch.where(m, torch.exp(s - mx), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("rhgl,lhd->rhgd", p, v) / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, mx[..., 0] + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, NEG_INF))
    return o.reshape(r, h, d), lse.reshape(r, h)


def _attend_cuts(q, k, v, p0, ctx, *, split_keys, window, scale):
    """Rows q (R, H, D) at positions p0.. over one sequence's gathered keys
    k, v (L, Hkv, D) below ctx, the kernels' split arithmetic: the keys
    any row can see cut at multiples of ``split_keys`` (None: one piece),
    each piece's (out, lse) computed alone and the pieces merged by
    ``merge_partial_attention`` in order. A row with no visible key is 0."""
    n = q.shape[0]
    lo = 0 if window is None else max(0, p0 - window + 1)
    hi = min(ctx, p0 + n, k.shape[0])
    if hi <= lo:
        return torch.zeros_like(q, dtype=torch.float32)
    cuts = [(lo, hi)] if split_keys is None else [
        (max(lo, i * split_keys), min(hi, (i + 1) * split_keys))
        for i in range(lo // split_keys, (hi - 1) // split_keys + 1)]
    q_pos = torch.arange(p0, p0 + n, device=q.device)
    parts = [_attend_range(q.float(), k[a:b], v[a:b], q_pos,
                           torch.arange(a, b, device=q.device),
                           window=window, scale=scale) for a, b in cuts]
    return merge_partial_attention(torch.stack([o for o, _ in parts]),
                                   torch.stack([lse for _, lse in parts]))


def _ragged_split(q, k, v, context_lens, q_starts, q_lens, pos0, *,
                  split_keys, decode_vecs, window, scale):
    """The ragged layout's split arithmetic over gathered K/V (S, L, Hkv,
    D): a sequence whose rows x G fit ``decode_vecs`` is cut at multiples
    of ``split_keys``, any other attends to its visible keys in one piece;
    rows no sequence owns are 0."""
    t, h, d = q.shape
    g = h // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.zeros_like(q, dtype=torch.float32)
    for s in range(len(q_lens)):
        start, n = int(q_starts[s]), min(int(q_lens[s]), t - int(q_starts[s]))
        if int(q_lens[s]) <= 0 or n <= 0:
            continue
        split = split_keys if int(q_lens[s]) * g <= decode_vecs else None
        out[start:start + n] = _attend_cuts(
            q[start:start + n], k[s], v[s], int(pos0[s]),
            int(context_lens[s]), split_keys=split, window=window,
            scale=scale)
    return out.to(q.dtype)


def paged_attention_ragged_split_ref(
        q, k_pages, v_pages, block_tables, context_lens, q_starts, q_lens,
        pos0, *, split_keys: int, decode_vecs: int,
        window: Optional[int] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """B1's algorithm in plain PyTorch, for checking its split bookkeeping
    on the CPU: ``_ragged_split`` over fp32 pools, ``split_keys`` and
    ``decode_vecs`` from the kernel's ``quant_plan``. Same result as
    ``paged_attention_ragged_ref`` up to fp32 rounding."""
    return _ragged_split(q, paged_gather(k_pages, block_tables),
                         paged_gather(v_pages, block_tables), context_lens,
                         q_starts, q_lens, pos0, split_keys=split_keys,
                         decode_vecs=decode_vecs, window=window, scale=scale)


def paged_attention_ragged_quant_split_ref(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, scale_tables,
        context_lens, q_starts, q_lens, pos0, *, split_keys: int,
        decode_vecs: int, window: Optional[int] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """B2's algorithm in plain PyTorch: ``_ragged_split`` over the
    dequantized pools. Same result as ``paged_attention_ragged_quant_ref``
    up to fp32 rounding."""
    return _ragged_split(
        q, _dequant_gather(k_pages, k_scales, block_tables, scale_tables),
        _dequant_gather(v_pages, v_scales, block_tables, scale_tables),
        context_lens, q_starts, q_lens, pos0, split_keys=split_keys,
        decode_vecs=decode_vecs, window=window, scale=scale)


def paged_attention_split_ref(q, k_pages, v_pages, block_table, context_lens,
                              q_starts, *, rows: int,
                              split_keys: Optional[int],
                              window: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """B3's algorithm in plain PyTorch: each sequence's Tq rows cut into
    tiles of ``rows`` rows (the plan's: all Tq rows for decode tiles, 64 /
    G for chunk tiles), a tile's visible keys cut at multiples of
    ``split_keys`` (None: one piece) and merged. Every row is written, 0
    where no key is visible. Same result as ``paged_attention_ref`` up to
    fp32 rounding."""
    b, tq, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k = paged_gather(k_pages, block_table)
    v = paged_gather(v_pages, block_table)
    out = torch.empty_like(q, dtype=torch.float32)
    for i in range(b):
        for r0 in range(0, tq, rows):
            out[i, r0:r0 + rows] = _attend_cuts(
                q[i, r0:r0 + rows], k[i], v[i], int(q_starts[i]) + r0,
                int(context_lens[i]), split_keys=split_keys, window=window,
                scale=scale)
    return out.to(q.dtype)


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


def moe_gmm_ref(x_groups: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched expert GEMM: (E, C, K) × (E, K, N) → (E, C, N), in fp32."""
    return torch.einsum("eck,ekn->ecn", x_groups.float(),
                        w.float()).to(x_groups.dtype)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l, h) log decays → (..., h, l, l): the sum of a over (j, i]
    at [i, j], -inf above the diagonal (its exp is exactly 0 there); the
    JAX ``models/mamba2._segsum``."""
    l = a.shape[-2]
    cs = torch.cumsum(a.movedim(-1, -2), dim=-1)             # (..., h, l)
    diff = cs[..., :, None] - cs[..., None, :]
    causal = torch.ones(l, l, dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~causal, float("-inf"))


def mamba_chunk_scan_ref(xdt: torch.Tensor, a_dt: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor,
                         init_state: Optional[torch.Tensor] = None):
    """SSD over pre-chunked inputs (the Mamba2 chunk scan), in fp32 (fp64
    for fp64 inputs: a check's exact answer).

    xdt: (B, NC, L, H, P) inputs times dt; a_dt: (B, NC, L, H) log decays
    (A·dt, negative); b, c: (B, NC, L, N) (n_groups = 1); init_state:
    (B, H, P, N) or None for zeros. Returns (y (B, NC, L, H, P), the state
    after the last chunk (B, H, P, N)), the model's convention. The math
    of the JAX ``models/mamba2.ssd_chunked`` written as pairwise
    contractions: CBᵀ once per chunk, ⊙ each head's segment decay, @ X (a
    four-operand einsum would build a (B, NC, L, H, L, N) intermediate)."""
    dt = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    x, a, b, c = (t.to(dt) for t in (xdt, a_dt, b, c))
    bsz, nc, l, h, p = x.shape
    n = b.shape[-1]
    a_cum = torch.cumsum(a, dim=2)                            # (b,c,l,h)
    ldec = torch.exp(segsum(a))                               # (b,c,h,l,s)
    cb = torch.einsum("bcln,bcsn->bcls", c, b)
    y_diag = torch.matmul(cb[:, :, None] * ldec,
                          x.permute(0, 1, 3, 2, 4))           # (b,c,h,l,p)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)                    # (b,c,l,h,p)

    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)     # (b,c,l,h)
    states = torch.einsum("bclhp,bcln->bchpn",
                          x * decay_states[..., None], b)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])               # (b,c,h)
    carry = (torch.zeros(bsz, h, p, n, dtype=dt, device=x.device)
             if init_state is None else init_state.to(dt))
    prev = []
    for i in range(nc):                       # the state before each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                    # (b,c,h,p,n)
    y_off = torch.einsum("bcln,bchpn->bclhp", c, prev_states)
    y_off = y_off * torch.exp(a_cum)[..., None]
    return y_diag + y_off, carry


def mamba_chunk_scan_split_ref(xdt: torch.Tensor, a_dt: torch.Tensor,
                               b: torch.Tensor, c: torch.Tensor,
                               init_state: Optional[torch.Tensor] = None,
                               slab: int = 32):
    """The SSD chunk scan as kernel B5 splits it (csrc/mamba2_scan.cu),
    in plain PyTorch (fp32, or fp64 for fp64 inputs), same contract as
    ``mamba_chunk_scan_ref``:

    1. per chunk, acum = cumsum(a) for every head, the chunk's decay
       exp(acum_L), and G = C Bᵀ once for all heads, formed only on the
       ``slab`` x ``slab`` tiles at or below the diagonal (the rest stays
       0, never formed);
    2. each chunk's own end state from a zero start, Bᵀ (w ⊙ X) with w =
       exp(acum_L − acum), in the kernel's (N, P) layout;
    3. the state carried into each chunk, in chunk order, and the final
       state;
    4. y = exp(acum) ⊙ (C · carried state) + M X, M = G ⊙ exp(acum_i −
       acum_j) on i >= j, 0 above the diagonal (a select: the decay above
       it is never multiplied in)."""
    dt = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    x, a, b, c = (t.to(dt) for t in (xdt, a_dt, b, c))
    bsz, nc, l, h, p = x.shape
    n = b.shape[-1]
    acum = torch.cumsum(a, dim=2)                             # (b,c,l,h)
    decay = torch.exp(acum[:, :, -1])                         # (b,c,h)
    g = torch.zeros(bsz, nc, l, l, dtype=dt, device=x.device)
    for i0 in range(0, l, slab):                # causal tiles of G only
        for j0 in range(0, i0 + 1, slab):
            g[:, :, i0:i0 + slab, j0:j0 + slab] = torch.einsum(
                "bcin,bcjn->bcij", c[:, :, i0:i0 + slab],
                b[:, :, j0:j0 + slab])
    w = torch.exp(acum[:, :, -1:] - acum)                     # (b,c,l,h)
    own = torch.einsum("bcjn,bcjhp->bchnp", b, x * w[..., None])
    carry = (torch.zeros(bsz, h, n, p, dtype=dt, device=x.device)
             if init_state is None else init_state.to(dt).transpose(-1, -2))
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * decay[:, i, :, None, None] + own[:, i]
    prev = torch.stack(prev, dim=1)                           # (b,c,h,n,p)
    y_off = torch.einsum("bcin,bchnp->bcihp", c, prev)
    y_off = y_off * torch.exp(acum)[..., None]
    seg = acum.permute(0, 1, 3, 2)                            # (b,c,h,l)
    diff = seg[..., :, None] - seg[..., None, :]              # (b,c,h,i,j)
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    m = torch.where(causal, g[:, :, None] * torch.exp(
        diff.masked_fill(~causal, 0.0)), torch.zeros((), dtype=dt,
                                                     device=x.device))
    y_diag = torch.einsum("bchij,bcjhp->bcihp", m, x)
    return y_off + y_diag, carry.transpose(-1, -2)
