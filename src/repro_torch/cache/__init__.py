"""Radix-tree prefix cache with copy-on-write paged KV reuse (DESIGN.md §10).

``PrefixCache`` is the engine-facing facade; ``RadixTree`` the block-granular
prefix index; page lifetime lives in ``repro_torch.engine.kv_manager``'s
refcounted ``BlockAllocator``.
"""
from .prefix_cache import CacheStats, PrefixCache
from .radix import RadixTree, block_hashes, split_blocks

__all__ = ["CacheStats", "PrefixCache", "RadixTree", "block_hashes",
           "split_blocks"]
