"""Paged KV-cache block allocator (vLLM-style, 128-token TPU pages).

Pages are reference-counted so the prefix cache (DESIGN.md §10) can share
them across requests: a cache hit ``fork()``s the matched pages into the new
request's block table (refcount++), and the radix tree itself holds one
reference per page it has adopted. A page returns to the free list only when
its last reference drops — shared pages are therefore pinned while any
active request maps them.

Copy-on-write: block-granular prefix matching means shared pages are always
*full*, so the serving path never writes into one; the COW branch in
``extend()`` is the safety net for non-aligned forks (a partially-filled
tail page with refcount > 1 is copied before new tokens land in it). Real
executors drain ``pop_cow_events()`` after every ``extend`` and mirror the
page copy into the device K/V arrays.

Scale pages (DESIGN.md §14): quantized KV stores int8/fp8 values in the
data pages and per-(token, kv-head) dequantization scales in a parallel
*scale page* pool of the same cardinality. Every live data page owns exactly
one scale page (``scale_of`` is a bijection onto the allocated scales) and
the pairing follows the data page through its whole lifecycle: allocated
together in ``extend``, shared by reference in ``fork``/``acquire_page``
(scales ride the data page — no separate refcount), given a *fresh* scale
page when the data page is COW'd (the copy event carries both ids so the
executor mirrors values and scales in the same drain), and freed together
when the last reference drops (``release``/``shrink``/``evict_request``).
The allocator tracks scales unconditionally — fp32 executors simply never
read them — so ``check_invariants`` can assert the bijection everywhere.
"""
from __future__ import annotations

from typing import Optional


class BlockAllocator:
    def __init__(self, num_blocks: int, block_size: int = 128):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}    # req_id -> page ids
        self.lens: dict[int, int] = {}            # req_id -> tokens stored
        self.refcount: dict[int, int] = {}        # page id -> live references
        # scale-page pool (DESIGN.md §14): same cardinality as the data pool,
        # so a scale allocation can never fail when the data one succeeded
        self._free_scales = list(range(num_blocks - 1, -1, -1))
        self.scale_of: dict[int, int] = {}        # data page -> scale page
        # (old_page, new_page, old_scale, new_scale) per COW copy
        self._cow_events: list[tuple[int, int, int, int]] = []

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self.refcount)

    def blocks_needed(self, req_id: int, extra_tokens: int) -> int:
        have = len(self.tables.get(req_id, ())) * self.block_size
        need = self.lens.get(req_id, 0) + extra_tokens
        return max(0, -(-(need - have) // self.block_size))

    def can_fit(self, req_id: int, extra_tokens: int) -> bool:
        return self.blocks_needed(req_id, extra_tokens) <= self.free_blocks

    def _needs_cow(self, req_id: int, extra_tokens: int) -> bool:
        tbl = self.tables.get(req_id)
        return bool(extra_tokens > 0 and tbl
                    and self.lens.get(req_id, 0) % self.block_size
                    and self.refcount.get(tbl[-1], 0) > 1)

    def extend(self, req_id: int, extra_tokens: int) -> Optional[list[int]]:
        """Reserve space for extra tokens; returns the request's full table
        or None if out of blocks (caller defers the request or asks the
        prefix cache to evict). Atomic: no state changes on failure."""
        n = self.blocks_needed(req_id, extra_tokens)
        cow = self._needs_cow(req_id, extra_tokens)
        if n + cow > len(self._free):
            return None
        tbl = self.tables.setdefault(req_id, [])
        if cow:
            # shared partial tail page: copy before writing into it. The
            # copy gets its own scale page — the old one stays with the
            # surviving holders of the old data page.
            old = tbl[-1]
            new = self._alloc_page()
            self.refcount[old] -= 1
            tbl[-1] = new
            self._cow_events.append((old, new, self.scale_of[old],
                                     self.scale_of[new]))
        for _ in range(n):
            tbl.append(self._alloc_page())
        self.lens[req_id] = self.lens.get(req_id, 0) + extra_tokens
        return tbl

    def _alloc_page(self) -> int:
        """Pop a fresh (data, scale) page pair; returns the data page id."""
        page = self._free.pop()
        self.refcount[page] = 1
        self.scale_of[page] = self._free_scales.pop()
        return page

    def fork(self, req_id: int, pages: list[int], n_tokens: int) -> list[int]:
        """Adopt already-populated shared ``pages`` as the table prefix of a
        new request (prefix-cache hit): refcount++ each, no data movement."""
        assert req_id not in self.tables, f"req {req_id} already has a table"
        for p in pages:
            self.refcount[p] += 1
        self.tables[req_id] = list(pages)
        self.lens[req_id] = n_tokens
        return self.tables[req_id]

    def acquire_page(self, page: int) -> None:
        """Add a reference to a live page (prefix-cache adoption)."""
        self.refcount[page] += 1

    def release_page(self, page: int) -> None:
        """Drop one reference; the page (and its scale page) frees when the
        last one goes."""
        rc = self.refcount[page] - 1
        if rc:
            self.refcount[page] = rc
        else:
            del self.refcount[page]
            self._free.append(page)
            self._free_scales.append(self.scale_of.pop(page))

    def shrink(self, req_id: int, n_tokens: int) -> None:
        """Undo the tail of an ``extend``: drop ``n_tokens`` reserved tokens
        and free now-unused trailing pages (pipeline rollback, DESIGN.md §12).

        Only the whole-page tail added by the rolled-back extend is released;
        a page that was COW'd by that extend keeps its (valid) copy — the
        request simply resumes writing into it at the restored length.
        """
        have = self.lens.get(req_id, 0)
        assert 0 <= n_tokens <= have, (req_id, n_tokens, have)
        new_len = have - n_tokens
        self.lens[req_id] = new_len
        tbl = self.tables.get(req_id, [])
        keep = -(-new_len // self.block_size)
        while len(tbl) > keep:
            self.release_page(tbl.pop())

    def shrink_to(self, req_id: int, n_tokens: int) -> None:
        """Slot-granular absolute truncation: keep exactly ``n_tokens``
        reserved slots, freeing whole trailing pages past the new length
        (speculative accept/reject, DESIGN.md §18).

        ``shrink`` is relative (undo N reserved tokens); the speculative
        path instead knows the *final* accepted length after a
        variable-acceptance round — a round reserves γ+1 slots per
        sequence optimistically and keeps only the accepted prefix.
        Partially-filled tail pages stay mapped; the stale K/V in slots
        past ``n_tokens`` is unreachable (attention masks by context
        length) and is overwritten before it could ever be read.
        """
        have = self.lens.get(req_id, 0)
        assert 0 <= n_tokens <= have, (req_id, n_tokens, have)
        self.shrink(req_id, have - n_tokens)

    def release(self, req_id: int) -> None:
        for p in self.tables.pop(req_id, ()):
            self.release_page(p)
        self.lens.pop(req_id, None)

    # ------------------------------------------------------------------
    # preemption support (DESIGN.md §13): victim cost/benefit accounting
    # ------------------------------------------------------------------

    def reclaimable_pages(self, req_id: int) -> int:
        """Pages that would actually return to the free list if ``req_id``
        were evicted now: only its exclusively-held pages (refcount 1).
        Pages shared with the prefix cache or COW-forked siblings stay
        live — the victim selector uses this to rank candidates by real
        benefit, not table length."""
        return sum(1 for p in self.tables.get(req_id, ())
                   if self.refcount.get(p, 0) == 1)

    def evict_request(self, req_id: int) -> int:
        """Preempt a victim: drop its table, refcount/COW-aware (shared
        pages survive for their other holders). Returns pages actually
        freed. The stale K/V left in freed pages is unreachable — no
        surviving table maps them — so they are immediately rewritable."""
        before = len(self._free)
        self.release(req_id)
        return len(self._free) - before

    def pop_cow_events(self) -> list[tuple[int, int]]:
        """Drain (old_page, new_page) copies the data plane must mirror.

        fp32 executors only mirror data pages; quantized ones use
        ``pop_cow_events_batched`` which also carries the scale-page copies.
        """
        ev, self._cow_events = self._cow_events, []
        return [(old, new) for old, new, _, _ in ev]

    def pop_cow_events_batched(self) -> tuple[list[int], list[int],
                                              list[int], list[int]]:
        """Drain every pending COW copy as parallel
        (old_pages, new_pages, old_scales, new_scales) id lists, so the data
        plane mirrors the whole step in ONE vectorized gather/scatter instead
        of one device op per event (DESIGN.md §11). Quantized executors
        mirror the scale arrays with the scale id lists in the same drain.
        Within a drain the lists never chain (a COW target has refcount 1 and
        is never re-copied), so a single gather from ``old_pages`` is safe."""
        ev, self._cow_events = self._cow_events, []
        if not ev:
            return [], [], [], []
        old, new, s_old, s_new = zip(*ev)
        return list(old), list(new), list(s_old), list(s_new)

    def context_len(self, req_id: int) -> int:
        return self.lens.get(req_id, 0)

    def scale_table(self, req_id: int) -> list[int]:
        """The request's scale-page ids, parallel to ``tables[req_id]``."""
        return [self.scale_of[p] for p in self.tables.get(req_id, ())]

    def check_invariants(self) -> None:
        """free + referenced == total, refcounts positive, no free dupes,
        and the scale↔data page bijection (DESIGN.md §14).

        The conservation laws the property tests assert after every op."""
        assert len(self._free) + len(self.refcount) == self.num_blocks, (
            f"leak/double-free: {len(self._free)} free + "
            f"{len(self.refcount)} live != {self.num_blocks}")
        assert len(set(self._free)) == len(self._free), "free-list dupes"
        assert all(rc > 0 for rc in self.refcount.values())
        assert not (set(self._free) & set(self.refcount)), \
            "page both free and referenced"
        # scale pages: exactly one per live data page (no orphans), no two
        # data pages alias one scale (injective), and scale conservation
        assert set(self.scale_of) == set(self.refcount), \
            "scale orphan/missing: scale_of keys must be the live data pages"
        held = set(self.scale_of.values())
        assert len(held) == len(self.scale_of), "scale page aliased"
        assert len(self._free_scales) + len(held) == self.num_blocks, (
            f"scale leak/double-free: {len(self._free_scales)} free + "
            f"{len(held)} held != {self.num_blocks}")
        assert not (set(self._free_scales) & held), \
            "scale page both free and held"
