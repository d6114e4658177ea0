"""Live KV-page migration between engines (DESIGN.md §15).

A migration moves ONE request from a source engine to a destination engine
at a step boundary, carrying its paged KV instead of recomputing it:

1. **capture** — gather the request's data pages (and, for quantized KV,
   the paired scale pages — copied verbatim, never requantized: a
   requantize would change stored values and break the bitwise-oracle
   contract) from the source executor's arrays, in table order;
2. **detach** — ``Engine.export_request`` removes the request from the
   source's host state and releases its table (shared prefix-cache pages
   survive for their other holders via the allocator refcounts);
3. **install** — on arrival, leading full blocks the destination's radix
   cache already holds transfer *as references* (``fork``, zero bytes on
   the wire); the remainder is materialized into freshly-extended pages by
   a bitwise scatter of the captured rows. Per-row attention determinism
   means the destination's independently-computed cache pages hold exactly
   the source's values for the same token blocks, so mixing referenced and
   materialized pages is safe.

The cheap fallback — ``mode="recompute"`` — ships only the token ids and
re-prefills the full known prefix on the destination via the existing
``preempt_requeue``/``cached_context`` machinery (DESIGN.md §13).
``breakeven_tokens`` gives the context length where the transfer starts
beating the recompute; ``DisaggConfig.mode="auto"`` applies it per request.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..cache.radix import split_blocks
from ..core.cost_model import LinearCostModel, LinkModel
from ..kernels.quant import raw_pool


@dataclasses.dataclass
class KVPayload:
    """One request's paged KV, captured in table order from the source.

    Arrays are host-side (numpy): ``k``/``v`` are
    (n_layers, n_pages, page_size, n_kv_heads, head_dim) in the executor's
    *storage* dtype (int8 values stay int8); ``k_scales``/``v_scales`` are
    the paired f32 dequantization scales (None for fp32 executors).
    numpy has no fp8, so 1-byte pools (int8, fp8-e4m3) travel as their raw
    bytes (uint8, ``kernels.quant.raw_pool``) and ``dtype`` records the
    pool's torch storage dtype, which the install checks.
    """
    n_tokens: int
    block_size: int
    k: object
    v: object
    k_scales: Optional[object] = None
    v_scales: Optional[object] = None
    dtype: object = None

    @property
    def n_pages(self) -> int:
        return -(-self.n_tokens // self.block_size)


@dataclasses.dataclass
class MigrationTicket:
    """One in-flight migration: host blob + optional KV payload + timing."""
    req_id: int
    src: int
    dst: int
    mode: str                  # "kv" | "recompute"
    reason: str                # "handoff" | "shed"
    t_detach: float
    t_launch: float            # payload hits the wire (per-source serial link)
    t_arrive: float
    n_tokens: int              # KV tokens resident at detach
    ref_tokens: int            # estimated reference-transferred (zero-byte)
    n_bytes: int               # modeled wire bytes
    blob: str                  # Engine.export_request host state
    kv: Optional[KVPayload] = None
    tenant: str = "default"
    # fault-plane retries so far (DESIGN.md §16): a disrupted transfer is
    # relaunched with exponential backoff, mutating t_launch/t_arrive
    attempt: int = 0


def _data_plane(executor):
    """Unwrap delegating shims (e.g. ``ModelTimedExecutor``) down to the
    object that actually owns the KV arrays — attribute *writes* on a
    wrapper would shadow instead of update."""
    while hasattr(executor, "_inner"):
        executor = executor._inner
    return executor


def capture_kv(executor, req_id: int) -> Optional[KVPayload]:
    """Gather ``req_id``'s pages from a real executor (None for sim).

    Must run BEFORE ``Engine.export_request`` — export releases the table.
    Refused for a sharded executor (ROADMAP A13b).
    """
    ex = _data_plane(executor)
    if getattr(ex, "mesh", None) is not None:
        raise NotImplementedError("KV migration (capture_kv) under a mesh "
                                  "is not ported yet (ROADMAP A13b)")
    alloc = getattr(ex, "alloc", None)
    if alloc is None or not hasattr(ex, "k_pages"):
        return None
    tbl = alloc.tables.get(req_id)
    if not tbl:
        return None
    n = alloc.lens[req_id]

    def host(pool, ids):
        # one gather on the device, one device->host copy per pool
        idx = torch.as_tensor(ids, dtype=torch.long, device=pool.device)
        return raw_pool(pool)[:, idx].cpu().numpy()

    payload = KVPayload(
        n_tokens=n, block_size=alloc.block_size,
        k=host(ex.k_pages, tbl), v=host(ex.v_pages, tbl),
        dtype=ex.k_pages.dtype)
    if getattr(ex, "k_scales", None) is not None:
        stbl = alloc.scale_table(req_id)
        payload.k_scales = host(ex.k_scales, stbl)
        payload.v_scales = host(ex.v_scales, stbl)
    return payload


def cached_prefix_pages(dst_engine, tokens, n_tokens: int,
                        now: float) -> list[int]:
    """Leading full-block pages of ``tokens`` the destination's radix cache
    already holds — the reference-transfer set. Unlike admission-time
    ``begin_request`` there is no ``len-1`` cap: a migrated decode's prompt
    logits were already consumed at the source, so even a fully-cached
    prompt transfers entirely by reference."""
    cache = getattr(dst_engine, "prefix_cache", None)
    if cache is None or not cache.enabled or not tokens:
        return []
    pages = cache.tree.match(split_blocks(tokens, cache.block_size), now)
    return pages[:n_tokens // cache.block_size]


def migrate_out(engine, req_id: int) -> tuple[str, Optional[KVPayload]]:
    """Capture KV, then detach the request from ``engine`` (order matters:
    export releases the table the capture gathers through)."""
    payload = capture_kv(engine.executor, req_id)
    return engine.export_request(req_id), payload


def _mirror_cow(ex, alloc) -> None:
    """Mirror any COW copies our fork/extend produced into the device
    arrays. Block-aligned reference transfer never needs one (the shared
    tail is always full), so this is a defensive drain: the executor's own
    (``_mirror_cow_batched``, scale and draft pages included)."""
    assert ex.alloc is alloc
    ex._mirror_cow_batched()


def install_kv_pages(executor, prefix_cache, req, payload: KVPayload,
                     now: float) -> Optional[int]:
    """Install a captured payload into a real destination executor.

    Returns the number of reference-transferred pages, or None if the
    destination cannot host the table (out of pages after cache eviction,
    or table longer than its per-seq cap) — the caller falls back to
    recompute. On success the request's pages bitwise-equal the source's
    and the prompt's full blocks are published to the destination cache.
    Refused for a sharded executor (ROADMAP A13b).
    """
    ex = _data_plane(executor)
    if getattr(ex, "mesh", None) is not None:
        raise NotImplementedError("KV migration (install_kv_pages) under a "
                                  "mesh is not ported yet (ROADMAP A13b)")
    alloc = ex.alloc
    assert alloc.block_size == payload.block_size, \
        "cross-page-size migration unsupported"
    if payload.dtype != ex.k_pages.dtype:
        return None                      # cross-dtype pools: recompute
    max_pages = getattr(ex, "max_pages", None)
    if max_pages is not None and payload.n_pages > max_pages:
        return None
    ref = cached_prefix_pages(_Shim(prefix_cache), req.tokens,
                              payload.n_tokens, now)
    cached = len(ref) * alloc.block_size
    if ref:
        alloc.fork(req.req_id, ref, cached)
    rest = payload.n_tokens - cached
    if rest > 0:
        tbl = alloc.extend(req.req_id, rest)
        if tbl is None and prefix_cache is not None and prefix_cache.enabled:
            prefix_cache.evict_for(alloc.blocks_needed(req.req_id, rest) + 1)
            tbl = alloc.extend(req.req_id, rest)
        if tbl is None:
            alloc.release(req.req_id)
            return None
    _mirror_cow(ex, alloc)
    tbl = alloc.tables[req.req_id]
    nref = len(ref)
    if len(tbl) > nref:
        sel = slice(nref, len(tbl))

        def put(pool, ids, rows):
            # one host->device copy per pool, then a bitwise page scatter
            idx = torch.as_tensor(ids, dtype=torch.long, device=pool.device)
            raw_pool(pool)[:, idx] = torch.from_numpy(
                np.ascontiguousarray(rows[:, sel])).to(pool.device)

        put(ex.k_pages, tbl[nref:], payload.k)
        put(ex.v_pages, tbl[nref:], payload.v)
        if payload.k_scales is not None \
                and getattr(ex, "k_scales", None) is not None:
            sdst = alloc.scale_table(req.req_id)[nref:]
            put(ex.k_scales, sdst, payload.k_scales)
            put(ex.v_scales, sdst, payload.v_scales)
    if prefix_cache is not None and prefix_cache.enabled and req.tokens:
        prefix_cache.insert_request(req.req_id, req.tokens, now)
    return nref


class _Shim:
    """Adapter so ``cached_prefix_pages`` accepts a bare PrefixCache."""

    def __init__(self, cache):
        self.prefix_cache = cache


def install_virtual(dst_engine, req, now: float) -> int:
    """Sim-mode install: mirror the page bookkeeping a real transfer would
    do on the destination's *virtual* allocator (the one its PrefixCache
    owns), so allocator pressure and cache contents stay realistic. The
    virtual allocator tracks prefill growth only (decode tokens are not
    mirrored there — see ``PrefixCache.on_prefill_progress``), so the
    installed length is ``prefilled``. Overflow degrades tracking, never
    correctness. Returns reference-transferred pages."""
    cache = getattr(dst_engine, "prefix_cache", None)
    if cache is None or not cache.enabled or not cache.owns_alloc \
            or not req.tokens:
        return 0
    ref = cached_prefix_pages(dst_engine, req.tokens, req.prefilled, now)
    cached = len(ref) * cache.block_size
    if ref:
        cache.alloc.fork(req.req_id, ref, cached)
    rest = req.prefilled - cached
    if rest > 0:
        if cache.alloc.extend(req.req_id, rest) is None:
            cache.evict_for(cache.alloc.blocks_needed(req.req_id, rest))
            if cache.alloc.extend(req.req_id, rest) is None:
                cache._overflow.add(req.req_id)
    cache.insert_request(req.req_id, req.tokens, now)
    return len(ref)


def install(dst_engine, ticket: MigrationTicket,
            now: float) -> tuple[object, str, int]:
    """Land a migration on the destination engine.

    Returns ``(request, mode_used, ref_pages)`` — ``mode_used`` is
    "recompute" when a KV install could not be hosted and fell back.
    """
    req = dst_engine.import_migrated(ticket.blob, now=now)
    mode, nref = ticket.mode, 0
    if mode == "kv":
        if ticket.kv is not None:
            got = install_kv_pages(dst_engine.executor,
                                   dst_engine.prefix_cache, req, ticket.kv,
                                   now)
            if got is None:
                mode = "recompute"
            else:
                nref = got
        else:
            nref = install_virtual(dst_engine, req, now)
    if mode == "recompute":
        dst_engine.requeue_migrated(req)
    return req, mode, nref


def breakeven_tokens(link: LinkModel, model: LinearCostModel,
                     bytes_per_token: int) -> float:
    """Context length beyond which transferring KV beats recomputing it.

    Transfer: ``latency + n·bpt/bandwidth``; recompute: ``a + (b+c)·n``
    (every recomputed token is both a new token and context). If the wire's
    per-token slope is not below the compute slope, transfer never catches
    up → inf. A non-positive result means transfer wins at any length.
    """
    s_xfer = bytes_per_token / link.bandwidth
    s_rec = model.b + model.c
    if s_xfer >= s_rec:
        return math.inf
    return max(0.0, (link.latency - model.a) / (s_rec - s_xfer))
