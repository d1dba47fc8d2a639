"""Refcounted prefix cache of the paged serving engine, after
``paddle_tpu/inference/prefix_cache.py``.

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
  a page and every descendant; :meth:`clear` flushes everything. The
  integrity sentinel's page checksums (``integrity.py``) route their
  mismatches here, so a damaged page costs a miss.
* **Tiered entries.** With the host tier armed (``kv_tier.HostTier``)
  reclamation demotes instead of evicting: the entry stays in the index,
  its ``tier`` walks ``hbm -> spilling -> host`` while its bytes move to
  host memory and ``host -> promoting -> hbm`` on the way back, and its
  device page is surrendered at once. :meth:`lookup` splices only the
  HBM-resident chain prefix; ``tiers=True`` also returns the matched
  demoted entries, for the owner to promote. Demotion picks HBM victims
  whose children are already off HBM (the index keeps every entry
  reachable), host-capacity eviction drops the oldest host leaf, and the
  ``owner_release`` callback tells the owner when an entry leaves the
  index or re-binds to a device page, so its host slot comes back. Tier
  strings, host slots and job tokens are opaque bookkeeping the owner
  drives.

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

    __slots__ = ("key", "page", "tokens", "parent", "children", "stamp",
                 "tier", "hslot", "job")

    def __init__(self, key: bytes, page: int, tokens: np.ndarray,
                 parent: Optional[bytes], stamp: int):
        self.key = key
        self.page = int(page)
        self.tokens = tokens          # this block's page_size tokens
        self.parent = parent          # parent block's key (None at root)
        self.children: set = set()    # keys of cached child blocks
        self.stamp = stamp            # LRU clock at last touch
        # host tier: "hbm" backs a live device page; hslot is the host
        # slab row while host-resident; job is the owner's token, bumped
        # whenever the entry moves on, so a stale async completion dies
        self.tier: str = "hbm"
        self.hslot: Optional[int] = None
        self.job: int = 0


class PrefixCache:
    """Block-chain index from token prefixes to resident physical pages."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._by_key: Dict[bytes, _Entry] = {}
        self._by_page: Dict[int, _Entry] = {}
        self._clock = 0
        self.hits = 0        # lookups that matched >= 1 block
        self.misses = 0      # lookups that matched nothing
        self.evictions = 0   # pages reclaimed by evict_lru or demoted
        # host-tier owner hook: called with an entry whose host residency
        # ends outside the owner's own promote path (removal from the
        # index, a re-bind to a device page); None without a tier
        self.owner_release = None

    def _chain(self, tokens) -> List[Tuple[bytes, np.ndarray]]:
        """(key, block_tokens) for every FULL block of ``tokens``."""
        ps = self.page_size
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return [(key, toks[i * ps:(i + 1) * ps])
                for i, key in enumerate(chain_keys(toks, ps))]

    def lookup(self, tokens, touch: bool = True, tiers: bool = False):
        """Longest cached HBM-resident block-aligned prefix of ``tokens``:
        ``(pages, matched_len)``, ``matched_len`` a multiple of
        ``page_size``. ``touch=False`` is a pure peek: no LRU re-stamp, no
        hit/miss count. Past the first demoted block nothing splices (a
        chain is contiguous from the root); ``tiers=True`` returns the
        matched demoted entries too, ``(pages, matched_len, demoted)``.
        A touch re-stamps the demoted continuation as well; only a
        spliceable prefix counts as a hit."""
        pages: List[int] = []
        chain: List[_Entry] = []
        demoted: List[_Entry] = []
        for key, block in self._chain(tokens):
            ent = self._by_key.get(key)
            if ent is None or not np.array_equal(ent.tokens, block):
                break  # missing, or caught by the token re-verification
            if demoted or ent.tier != "hbm":
                demoted.append(ent)
                continue
            chain.append(ent)
            pages.append(ent.page)
        if touch:
            if chain or demoted:
                self._clock += 1
                for ent in chain + demoted:
                    ent.stamp = self._clock
            if chain:
                self.hits += 1
            else:
                self.misses += 1
        if tiers:
            return pages, len(pages) * self.page_size, demoted
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
                if ent.tier != "hbm" and page > 0 \
                        and page not in self._by_page:
                    # recompute-as-promote: the demoted block's bytes were
                    # just recomputed onto ``page``; re-binding the entry
                    # is the promotion without the copy
                    self._rebind(ent, page)
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
        # any async tier job for the entry is stale now, and its host slot
        # goes back to the owner
        ent.job += 1
        if self.owner_release is not None:
            self.owner_release(ent)
        if ent.parent is not None:
            parent = self._by_key.get(ent.parent)
            if parent is not None:
                parent.children.discard(ent.key)

    def _lru_victim(self, page_ref) -> Optional[_Entry]:
        """The victim of eviction and demotion alike: the oldest-stamped
        HBM entry at refcount 0 whose cached children are all off HBM
        (without a tier: the classic leaf-first rule)."""
        victim = None
        for ent in self._by_key.values():
            if ent.tier != "hbm" or page_ref[ent.page]:
                continue
            if any(self._by_key[k].tier == "hbm" for k in ent.children
                   if k in self._by_key):
                continue
            if victim is None or ent.stamp < victim.stamp:
                victim = ent
        return victim

    def evict_lru(self, page_ref) -> Optional[int]:
        """Reclaim ONE idle page: the LRU victim leaves the index. Returns
        the page, or None."""
        victim = self._lru_victim(page_ref)
        if victim is None:
            return None
        self._remove(victim)
        self.evictions += 1
        return victim.page

    # ------------------------------------------------- tier transitions
    def take_for_demotion(self, page_ref):
        """Demotion's twin of :meth:`evict_lru`: the same victim gives up
        its device page but stays indexed, ``tier="spilling"`` until its
        bytes land on the host. Returns ``(page, entry)`` or None."""
        victim = self._lru_victim(page_ref)
        if victim is None:
            return None
        page = victim.page
        del self._by_page[page]
        victim.page = 0
        victim.tier = "spilling"
        victim.job += 1
        self.evictions += 1
        return page, victim

    def promote(self, ent: _Entry, page: int) -> bool:
        """Re-bind a host-resident entry to the device page its verified
        bytes were restored into, re-stamped (freshly wanted). False when
        the entry left the index or the page is mapped already."""
        if self._by_key.get(ent.key) is not ent \
                or int(page) in self._by_page:
            return False
        ent.tier = "hbm"
        ent.hslot = None
        ent.job += 1
        ent.page = int(page)
        self._by_page[ent.page] = ent
        self._clock += 1
        ent.stamp = self._clock
        return True

    def _rebind(self, ent: _Entry, page: int):
        """Recompute-as-promote (``register``): end the entry's host
        residency (the owner reclaims the slot, the job goes stale) and
        bind it to the freshly computed ``page``."""
        ent.job += 1
        if self.owner_release is not None:
            self.owner_release(ent)
        ent.tier = "hbm"
        ent.hslot = None
        ent.page = int(page)
        self._by_page[ent.page] = ent

    def evict_host_lru(self) -> Optional[_Entry]:
        """Reclaim ONE host slot: drop the oldest host-resident entry with
        no cached children in any tier. Returns it (its slot comes back
        through ``owner_release``), or None."""
        victim = None
        for ent in self._by_key.values():
            if ent.tier != "host" or ent.children:
                continue
            if victim is None or ent.stamp < victim.stamp:
                victim = ent
        if victim is None:
            return None
        self._remove(victim)
        return victim

    def invalidate_entry(self, ent: _Entry) -> List[int]:
        """:meth:`invalidate_page` for an entry without a device page (a
        demoted block whose promotion failed its digest)."""
        if self._by_key.get(ent.key) is not ent:
            return []
        return self._invalidate_from(ent)

    def invalidate_page(self, page: int) -> List[int]:
        """Drop the entry backing ``page`` and every descendant block.
        Returns the device pages whose entries were dropped."""
        ent = self._by_page.get(int(page))
        if ent is None:
            return []
        return self._invalidate_from(ent)

    def _invalidate_from(self, ent: _Entry) -> List[int]:
        stack, dropped = [ent], []
        while stack:
            e = stack.pop()
            stack.extend(self._by_key[k] for k in e.children
                         if k in self._by_key)
            self._remove(e)
            if e.page:
                dropped.append(e.page)
        return dropped

    def clear(self) -> List[int]:
        """Flush everything. Returns the previously cached device pages
        (demoted entries have none; their host slots come back through
        ``owner_release``)."""
        pages = list(self._by_page)
        if self.owner_release is not None:
            for ent in self._by_key.values():
                ent.job += 1
                self.owner_release(ent)
        self._by_key.clear()
        self._by_page.clear()
        return pages
