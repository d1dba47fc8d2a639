"""Refcounted prefix cache of the paged serving engine, after
``paddle_tpu/inference/prefix_cache.py`` without the host-DRAM tier.

* **Chain hashing, page granularity.** Block ``i``'s key is
  ``blake2b(parent_key || tokens_i)``, so a key commits to the whole token
  prefix through its block. Only full blocks (``page_size`` tokens) are
  cached; a prompt's partial tail page is always recomputed.
* **Verify on hit.** Every entry keeps its block's tokens and a lookup
  compares them, so a hash collision (or a mis-registered entry) degrades
  to a miss, never to the wrong prefix.
* **Refcounts live with the owner.** The cache never owns pages: the
  engine's allocator counts slot references per physical page, and the
  cache indexes pages whose content is known. A page only the cache knows
  has refcount 0 (resident, idle) and is what :meth:`evict_lru` reclaims
  under pool pressure; a referenced page is never a candidate.
* **Leaf-first LRU eviction.** Only entries without cached children are
  evicted, oldest stamp first; a lookup re-stamps its whole matched chain,
  so stale chains unwind tail-first.
* **Invalidate on doubt.** :meth:`invalidate_page` drops the entry backing
  a page and every descendant; :meth:`clear` flushes everything.

Pure host code (stdlib and numpy): the engine passes its refcount array in
where a reclamation decision needs it.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "chain_keys"]


def chain_keys(tokens, page_size: int) -> List[bytes]:
    """The chain-hash keys of every FULL block of ``tokens``: block ``i``'s
    key is ``blake2b(parent_key || tokens_i)``, 16 bytes."""
    ps = int(page_size)
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: List[bytes] = []
    parent = b""
    for i in range(toks.size // ps):
        block = toks[i * ps:(i + 1) * ps]
        key = hashlib.blake2b(parent + block.tobytes(),
                              digest_size=16).digest()
        out.append(key)
        parent = key
    return out


class _Entry:
    """One cached full block: a physical page plus the chain identity."""

    __slots__ = ("key", "page", "tokens", "parent", "children", "stamp")

    def __init__(self, key: bytes, page: int, tokens: np.ndarray,
                 parent: Optional[bytes], stamp: int):
        self.key = key
        self.page = int(page)
        self.tokens = tokens          # this block's page_size tokens
        self.parent = parent          # parent block's key (None at root)
        self.children: set = set()    # keys of cached child blocks
        self.stamp = stamp            # LRU clock at last touch


class PrefixCache:
    """Block-chain index from token prefixes to resident physical pages."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._by_key: Dict[bytes, _Entry] = {}
        self._by_page: Dict[int, _Entry] = {}
        self._clock = 0
        self.hits = 0        # lookups that matched >= 1 block
        self.misses = 0      # lookups that matched nothing
        self.evictions = 0   # pages reclaimed by evict_lru

    def _chain(self, tokens) -> List[Tuple[bytes, np.ndarray]]:
        """(key, block_tokens) for every FULL block of ``tokens``."""
        ps = self.page_size
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return [(key, toks[i * ps:(i + 1) * ps])
                for i, key in enumerate(chain_keys(toks, ps))]

    def lookup(self, tokens, touch: bool = True):
        """Longest cached block-aligned prefix of ``tokens``: ``(pages,
        matched_len)``, ``matched_len`` a multiple of ``page_size``.
        ``touch=False`` is a pure peek: no LRU re-stamp, no hit/miss
        count."""
        pages: List[int] = []
        chain: List[_Entry] = []
        for key, block in self._chain(tokens):
            ent = self._by_key.get(key)
            if ent is None or not np.array_equal(ent.tokens, block):
                break  # missing, or caught by the token re-verification
            chain.append(ent)
            pages.append(ent.page)
        if touch:
            if chain:
                self._clock += 1
                for ent in chain:
                    ent.stamp = self._clock
                self.hits += 1
            else:
                self.misses += 1
        return pages, len(pages) * self.page_size

    def register(self, tokens, pages) -> int:
        """Publish the full blocks of ``tokens`` as backed by ``pages`` (one
        page per block, block order). A block already cached keeps its
        original page (first writer wins). Returns the pages adopted."""
        adopted = 0
        self._clock += 1
        parent_ent: Optional[_Entry] = None
        for (key, block), page in zip(self._chain(tokens), pages):
            page = int(page)
            ent = self._by_key.get(key)
            if ent is not None:
                if not np.array_equal(ent.tokens, block):
                    break  # a colliding key must not chain through
                ent.stamp = self._clock
                parent_ent = ent
                continue
            if page <= 0 or page in self._by_page:
                break  # page 0 is the trash page; a page backs one block
            ent = _Entry(key, page, np.array(block, np.int32),
                         parent_ent.key if parent_ent is not None else None,
                         self._clock)
            self._by_key[key] = ent
            self._by_page[page] = ent
            if parent_ent is not None:
                parent_ent.children.add(key)
            parent_ent = ent
            adopted += 1
        return adopted

    @property
    def n_pages(self) -> int:
        return len(self._by_page)

    def contains_page(self, page: int) -> bool:
        return int(page) in self._by_page

    def evictable_count(self, page_ref) -> int:
        """Upper bound on reclaimable pages: entries whose page has no live
        reference (an interior block above a pinned leaf counts but is not
        yet evictable; the caller handles the allocation failure)."""
        return sum(1 for p in self._by_page if not page_ref[p])

    def _remove(self, ent: _Entry):
        del self._by_key[ent.key]
        self._by_page.pop(ent.page, None)
        if ent.parent is not None:
            parent = self._by_key.get(ent.parent)
            if parent is not None:
                parent.children.discard(ent.key)

    def evict_lru(self, page_ref) -> Optional[int]:
        """Reclaim ONE idle page: the oldest-stamped leaf entry whose page
        has refcount 0. Returns the page, or None."""
        victim = None
        for ent in self._by_key.values():
            if page_ref[ent.page] or ent.children:
                continue
            if victim is None or ent.stamp < victim.stamp:
                victim = ent
        if victim is None:
            return None
        self._remove(victim)
        self.evictions += 1
        return victim.page

    def invalidate_page(self, page: int) -> List[int]:
        """Drop the entry backing ``page`` and every descendant block.
        Returns the pages whose entries were dropped."""
        ent = self._by_page.get(int(page))
        if ent is None:
            return []
        stack, dropped = [ent], []
        while stack:
            e = stack.pop()
            stack.extend(self._by_key[k] for k in e.children
                         if k in self._by_key)
            self._remove(e)
            dropped.append(e.page)
        return dropped

    def clear(self) -> List[int]:
        """Flush everything. Returns the previously cached pages."""
        pages = list(self._by_page)
        self._by_key.clear()
        self._by_page.clear()
        return pages
