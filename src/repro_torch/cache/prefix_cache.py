"""PrefixCache: the engine-facing facade of the cache subsystem
(DESIGN.md §10).

At admission the engine calls ``begin_request`` to split a prompt into
``cached + new`` tokens: the matched pages are ``fork``ed into the request's
block table (refcount++, zero data movement) and the request starts with
``prefilled = cached`` — every downstream consumer (batch formation,
capacity, PAB, the RLS calibration) then operates on *effective* tokens for
free, because ``SchedTask.new_tokens`` excludes the cached prefix while
``SchedTask.context`` still charges it as KV traffic.

Two deployment modes, one code path:

* **real** — constructed with the ``PagedTransformerExecutor``'s allocator;
  the executor writes K/V and extends tables, the cache only forks/inserts.
* **virtual** — the cache owns a private ``BlockAllocator`` whose pages are
  pure bookkeeping; the engine drives ``on_prefill_progress`` so the sim
  reproduces real allocation pressure (and eviction) without any tensors.

``capacity_pages=0`` disables the cache entirely: every call is a no-op and
engine behaviour is bit-identical to running without one (regression-tested).
Capacity is enforced by LRU eviction of unpinned radix leaves; pages shared
with an active request are pinned (refcount > 1) and never evicted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..engine.kv_manager import BlockAllocator
from .radix import RadixTree, block_hashes, split_blocks


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hit_requests: int = 0
    hit_tokens: int = 0
    lookup_tokens: int = 0
    inserted_pages: int = 0
    evicted_pages: int = 0

    @property
    def hit_rate(self) -> float:
        """Token hit rate: fraction of looked-up prompt tokens served from
        cache — the engine/LB-report metric."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0


class PrefixCache:
    def __init__(self, capacity_pages: int, block_size: int = 128,
                 alloc: Optional[BlockAllocator] = None,
                 alloc_pages: Optional[int] = None):
        self.capacity_pages = max(0, capacity_pages)
        self.block_size = block_size
        self.enabled = self.capacity_pages > 0
        self.owns_alloc = alloc is None
        if alloc is not None:
            assert alloc.block_size == block_size
            self.alloc = alloc
        elif self.enabled:
            # virtual mode: pages are bookkeeping; size the pool to hold the
            # cache plus in-flight request tables, so allocator pressure (and
            # therefore eviction) still occurs at roughly real proportions
            self.alloc = BlockAllocator(alloc_pages or
                                        self.capacity_pages * 2 + 64,
                                        block_size)
        else:
            self.alloc = None
        self.tree = RadixTree()
        self.stats = CacheStats()
        self._overflow: set[int] = set()   # reqs whose virtual alloc failed

    # ------------------------------------------------------------------
    # request lifecycle hooks (called by the engine)
    # ------------------------------------------------------------------

    def begin_request(self, req_id: int, tokens: Sequence[int],
                      now: float) -> int:
        """Match ``tokens`` against the radix tree and fork the hit into the
        request's block table. Returns the number of cached tokens (block-
        aligned, capped at prompt_len - 1 so at least the final prompt token
        is computed — its logits produce the first output)."""
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(tokens)
        if not self.enabled or not tokens:
            return 0
        blocks = split_blocks(tokens, self.block_size)
        pages = self.tree.match(blocks, now)
        max_blocks = (len(tokens) - 1) // self.block_size
        pages = pages[:max_blocks]
        cached = len(pages) * self.block_size
        self.alloc.fork(req_id, pages, cached)
        if cached:
            self.stats.hit_requests += 1
            self.stats.hit_tokens += cached
        return cached

    def on_prefill_progress(self, req_id: int, n_tokens: int) -> None:
        """Virtual-mode bookkeeping: mirror the data plane's table growth.

        Real executors extend the shared allocator themselves, so this
        no-ops there. Under pool pressure it evicts unpinned cache leaves;
        if the pool is exhausted by active requests alone, the request is
        marked overflowed and later inserted only up to its allocated
        prefix (tracking degrades, correctness never depends on it)."""
        if not self.enabled or not self.owns_alloc:
            return
        if self.alloc.extend(req_id, n_tokens) is None:
            self.evict_for(self.alloc.blocks_needed(req_id, n_tokens))
            if self.alloc.extend(req_id, n_tokens) is None:
                self._overflow.add(req_id)

    def insert_request(self, req_id: int, tokens: Sequence[int],
                       now: float) -> int:
        """Adopt the request's computed full-block pages into the radix tree
        (called at prefill completion, so concurrent identical prompts hit).
        Returns the number of pages newly adopted."""
        if not self.enabled:
            return 0
        tbl = self.alloc.tables.get(req_id)
        if not tbl:
            return 0
        n_blocks = min(len(tokens), self.alloc.context_len(req_id)) \
            // self.block_size
        n_blocks = min(n_blocks, len(tbl))
        if not n_blocks:
            return 0
        prefix = tokens[:n_blocks * self.block_size]
        adopted = self.tree.insert(split_blocks(prefix, self.block_size),
                                   tbl[:n_blocks],
                                   block_hashes(prefix, self.block_size), now)
        for i in adopted:
            self.alloc.acquire_page(tbl[i])
        self.stats.inserted_pages += len(adopted)
        # capacity bound: best-effort LRU trim (pinned leaves can force a
        # transient overshoot; they become evictable when their requests end)
        while self.tree.n_pages > self.capacity_pages:
            if not self._evict_leaf():
                break
        return len(adopted)

    def end_request(self, req_id: int) -> None:
        """Release the request's table references (idempotent: a real
        executor's own ``release`` afterwards becomes a no-op)."""
        if self.alloc is not None:
            self.alloc.release(req_id)
        self._overflow.discard(req_id)

    abort_request = end_request     # admission rejection: same cleanup

    # ------------------------------------------------------------------
    # memory pressure
    # ------------------------------------------------------------------

    def _evict_leaf(self) -> int:
        pages = self.tree.evict_one(
            lambda pgs: all(self.alloc.refcount.get(p, 0) == 1 for p in pgs))
        for p in pages:
            self.alloc.release_page(p)
        self.stats.evicted_pages += len(pages)
        return len(pages)

    def evict_for(self, n_pages: int) -> int:
        """Free at least ``n_pages`` by LRU-evicting unpinned cache leaves
        (called by executors when a table extension finds no free blocks).
        Returns pages actually freed (may be fewer if everything is pinned)."""
        if not self.enabled:
            return 0
        freed = 0
        while freed < n_pages:
            got = self._evict_leaf()
            if not got:
                break
            freed += got
        return freed

    # ------------------------------------------------------------------
    # checkpoints (DESIGN.md §16): warm rejoin after a rank failure
    # ------------------------------------------------------------------

    def snapshot(self) -> list:
        """Serializable cache content: one ``(blocks, hashes)`` pair per
        root-to-leaf path, in deterministic (hash) order. Page ids are
        deliberately NOT captured — they are meaningless across engine
        incarnations; ``restore`` allocates fresh ones."""
        if not self.enabled:
            return []
        out: list[tuple[list, list]] = []

        def walk(node, blocks, hashes):
            blocks = blocks + list(node.key)
            hashes = hashes + list(node.hashes)
            if node.is_leaf:
                if blocks:
                    out.append((blocks, hashes))
                return
            for child in node.children.values():
                walk(child, blocks, hashes)

        walk(self.tree.root, [], [])
        out.sort(key=lambda p: p[1])
        return out

    def restore(self, paths: list, now: float) -> int:
        """Warm-start an *empty* cache from ``snapshot()`` output.

        Each path gets fresh pages from this incarnation's allocator via a
        synthetic request id that is released immediately after the radix
        adoption (so only tree references pin the pages — exactly the state
        ``insert_request`` leaves behind). Stops early if the pool can't
        hold more. Returns pages adopted."""
        if not self.enabled or not self.owns_alloc:
            return 0
        n = 0
        for i, (blocks, hashes) in enumerate(paths):
            rid = -1000 - i
            if self.alloc.extend(rid, len(blocks) * self.block_size) is None:
                self.alloc.release(rid)
                break
            tbl = list(self.alloc.tables[rid])
            adopted = self.tree.insert([tuple(b) for b in blocks], tbl,
                                       list(hashes), now)
            for j in adopted:
                self.alloc.acquire_page(tbl[j])
            n += len(adopted)
            self.alloc.release(rid)
            while self.tree.n_pages > self.capacity_pages:
                if not self._evict_leaf():
                    break
        return n

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @property
    def held_pages(self) -> int:
        return self.tree.n_pages

    def prefix_hash_summary(self, limit: int = 4096) -> list[int]:
        """Compact cache summary shipped in LB report ticks: cumulative
        prefix hashes of cached paths (see ``CacheAwareLB``)."""
        if not self.enabled:
            return []
        return self.tree.prefix_hash_summary(limit)

    def stats_dict(self) -> dict:
        d = dataclasses.asdict(self.stats)
        d["hit_rate"] = self.stats.hit_rate
        d["held_pages"] = self.held_pages
        return d
