"""Radix-tree prefix index over token-ID sequences (DESIGN.md §10).

SGLang-style path-compressed tree whose matching unit is one KV *page*
(block of ``block_size`` token ids): every edge is labelled with a sequence
of full blocks and carries the page id holding each block's K/V. Matching a
prompt walks the tree block by block and may stop mid-edge (block-granular
match, no split on read); inserting a diverging path splits the edge at the
divergence point, exactly like radix-tree insertion.

The tree stores *references*: page lifetime is owned by the
``BlockAllocator`` refcounts (engine/kv_manager.py). A node also records the
cumulative prefix hash at each of its blocks — ``CacheAwareLB`` ships these
hashes in LB report ticks as the per-rank cache summary.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

Block = tuple  # tuple of block_size token ids

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def block_hashes(tokens: Sequence[int], block_size: int) -> list[int]:
    """Cumulative FNV-1a hash per full block of ``tokens``.

    ``out[i]`` digests tokens[0 : (i+1)*block_size]; prefix-consistent, so a
    load balancer can estimate longest-prefix match length by counting how
    many leading hashes appear in a rank's reported hash set. Deterministic
    across processes (no Python str-hash salting).
    """
    h = _FNV_OFFSET
    out = []
    for i in range(len(tokens) // block_size):
        for t in tokens[i * block_size:(i + 1) * block_size]:
            h ^= t & _MASK
            h = (h * _FNV_PRIME) & _MASK
        out.append(h)
    return out


def split_blocks(tokens: Sequence[int], block_size: int) -> list[Block]:
    return [tuple(tokens[i * block_size:(i + 1) * block_size])
            for i in range(len(tokens) // block_size)]


class RadixNode:
    __slots__ = ("key", "pages", "hashes", "children", "parent",
                 "last_access")

    def __init__(self, key: list[Block], pages: list[int],
                 hashes: list[int], parent: Optional["RadixNode"],
                 last_access: float):
        self.key = key            # blocks along the edge into this node
        self.pages = pages        # page id per block, aligned with key
        self.hashes = hashes      # cumulative prefix hash per block
        self.children: dict[Block, RadixNode] = {}
        self.parent = parent
        self.last_access = last_access

    @property
    def is_leaf(self) -> bool:
        return not self.children


class RadixTree:
    def __init__(self):
        self.root = RadixNode([], [], [], None, 0.0)
        self.n_pages = 0          # pages currently referenced by the tree

    # ------------------------------------------------------------------

    def match(self, blocks: Sequence[Block], now: float) -> list[int]:
        """Longest cached prefix of ``blocks``; returns its page ids.

        Block-granular: a partial edge match still yields that edge's
        leading pages. Touches ``last_access`` along the path (LRU)."""
        node, out, i = self.root, [], 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                break
            k = 0
            while (k < len(child.key) and i < len(blocks)
                   and child.key[k] == blocks[i]):
                out.append(child.pages[k])
                i += 1
                k += 1
            child.last_access = now
            if k < len(child.key):
                break
            node = child
        return out

    def insert(self, blocks: Sequence[Block], pages: Sequence[int],
               hashes: Sequence[int], now: float) -> list[int]:
        """Insert a path; returns indices of blocks the tree newly adopted.

        Blocks already present keep their existing pages (the caller's
        duplicate pages stay owned by the caller and free on its release);
        only the adopted indices must be ``acquire_page``d by the caller."""
        node, i = self.root, 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                new = RadixNode(list(blocks[i:]), list(pages[i:]),
                                list(hashes[i:]), node, now)
                node.children[blocks[i]] = new
                self.n_pages += len(new.pages)
                return list(range(i, len(blocks)))
            k = 0
            while (k < len(child.key) and i < len(blocks)
                   and child.key[k] == blocks[i]):
                i += 1
                k += 1
            child.last_access = now
            if k == len(child.key):
                node = child
                continue
            # diverged (or ran out of blocks) mid-edge: split child at k
            # (k >= 1: child was found by its first block)
            self._split(child, k, now)
            if i < len(blocks):
                top = child.parent
                rest = RadixNode(list(blocks[i:]), list(pages[i:]),
                                 list(hashes[i:]), top, now)
                top.children[blocks[i]] = rest
                self.n_pages += len(rest.pages)
                return list(range(i, len(blocks)))
            return []
        return []

    def _split(self, node: RadixNode, k: int, now: float) -> None:
        """Split ``node``'s edge after its first ``k`` blocks (k >= 1)."""
        assert 0 < k < len(node.key)
        parent = node.parent
        top = RadixNode(node.key[:k], node.pages[:k], node.hashes[:k],
                        parent, now)
        parent.children[top.key[0]] = top
        node.key, node.pages, node.hashes = (node.key[k:], node.pages[k:],
                                             node.hashes[k:])
        node.parent = top
        top.children[node.key[0]] = node

    # ------------------------------------------------------------------

    def leaves(self) -> list[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.is_leaf and n is not self.root:
                out.append(n)
            else:
                stack.extend(n.children.values())
        return out

    def evict_one(self, evictable: Callable[[list[int]], bool]) -> list[int]:
        """Remove the LRU leaf whose pages ``evictable`` approves (i.e. not
        pinned by an active request); returns its page ids ([] if none)."""
        cands = [n for n in self.leaves() if evictable(n.pages)]
        if not cands:
            return []
        victim = min(cands, key=lambda n: n.last_access)
        del victim.parent.children[victim.key[0]]
        self.n_pages -= len(victim.pages)
        return victim.pages

    def prefix_hash_summary(self, limit: int = 4096) -> list[int]:
        """Cumulative prefix hashes of cached paths, BFS (shallow first) so
        truncation keeps the most widely-shared prefixes."""
        out: list[int] = []
        queue = [self.root]
        while queue and len(out) < limit:
            node = queue.pop(0)
            out.extend(node.hashes[:limit - len(out)])
            queue.extend(sorted(node.children.values(),
                                key=lambda n: n.hashes[0] if n.hashes else 0))
        return out

    def check_invariants(self) -> None:
        """Structural radix invariants, asserted by the property tests."""
        seen: set[int] = set()
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                assert node.key, "non-root node with empty edge"
                assert len(node.key) == len(node.pages) == len(node.hashes)
                assert node.parent.children[node.key[0]] is node
                for p in node.pages:
                    assert p not in seen, f"page {p} on two tree paths"
                    seen.add(p)
                count += len(node.pages)
            for first, child in node.children.items():
                assert child.key[0] == first, "child dict key mismatch"
            stack.extend(node.children.values())
        assert count == self.n_pages, "n_pages counter drifted"
