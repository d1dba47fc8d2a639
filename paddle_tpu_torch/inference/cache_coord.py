"""Page pool, allocator and prefix cache of the serving engine, after
``paddle_tpu/inference/cache_coord.py`` without the host tier.

The device page buffers (``k_pages`` / ``v_pages`` per layer, plus bf16
``scale_pages`` when the cache is int8) are allocated ONCE on the engine's
device and written in place by every forward. The allocator state (block
tables, lengths, per-page refcounts, free lists) lives on the host in
numpy. Physical page 0 is the trash page: never allocated, the target of
every idle or padding write.

With ``prefix_cache=True`` a :class:`PrefixCache` indexes full pages whose
content is known. A released page that the cache indexes stays resident at
refcount 0, and the allocator reclaims such idle cached pages (LRU, leaf
first) before it reports the pool empty, so the engine's preemption ladder
only runs once no idle cached page is left. ``cow_pending`` holds the
copy-on-write page copies an admission owes before any program writes into
its spliced table (:meth:`flush_cow`).

There is no host tier: :meth:`drain_tier` and :meth:`shutdown_tier` are the
reference coordinator's calls with ``kv_host_pages=0``, no-ops, so the
serving front end drives either engine the same way.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..observability.tracing import TRACER as _TRACER
from .prefix_cache import PrefixCache

__all__ = ["CacheCoordinator"]


class CacheCoordinator:
    """Paged KV pool + host allocator + prefix cache for one engine."""

    def __init__(self, engine, prefix_cache: bool = False):
        self.engine = engine
        self.num_pages = engine.num_pages
        self.page_size = engine.page_size
        self.tables = np.zeros(
            (engine.max_slots, engine.max_pages_per_seq), np.int32)
        self.lengths = np.zeros((engine.max_slots,), np.int32)
        self.page_ref = np.zeros((self.num_pages,), np.int32)
        self.pcache = PrefixCache(self.page_size) if prefix_cache else None
        self.cow_pending: List[Tuple[int, int]] = []  # (src, dst) copies
        self.cached_tokens = 0  # prefill tokens served from the cache
        self.free_pages: List[int] = []
        self.free_slots: List[int] = []
        self.k_pages: List[torch.Tensor] = []
        self.v_pages: List[torch.Tensor] = []
        self.scale_pages: List[Optional[torch.Tensor]] = []
        self._allocate()
        self.reset()

    def _allocate(self):
        eng = self.engine
        cfg = eng.cfg
        store = torch.int8 if eng.quantized else eng.dtype
        shape = (self.num_pages, self.page_size,
                 cfg.num_kv_heads * cfg.head_dim)
        dev = eng.device
        self.k_pages = [torch.zeros(shape, dtype=store, device=dev)
                        for _ in range(cfg.num_layers)]
        self.v_pages = [torch.zeros(shape, dtype=store, device=dev)
                        for _ in range(cfg.num_layers)]
        if eng.quantized:
            sshape = (self.num_pages, self.page_size, 128)
            self.scale_pages = [
                torch.zeros(sshape, dtype=torch.bfloat16, device=dev)
                for _ in range(cfg.num_layers)]
        else:
            self.scale_pages = [None] * cfg.num_layers

    @contextlib.contextmanager
    def trash_kept(self):
        """The trash page (physical page 0) of every layer as the block
        found it: a captured step's warm-up runs on idle rows, whose writes
        land there, and must not change what later discarded rows read."""
        saved = [(t, t[0].clone()) for t in self.k_pages + self.v_pages
                 + [s for s in self.scale_pages if s is not None]]
        try:
            yield
        finally:
            for t, page in saved:
                t[0].copy_(page)

    def reset(self):
        """Empty the allocator: every page free (page 0 stays the trash
        page), every slot free, the prefix cache flushed. Page content is
        left as is: data only counts below a slot's ``lengths``."""
        self.tables[:] = 0
        self.lengths[:] = 0
        self.page_ref[:] = 0
        self.free_pages = list(range(self.num_pages - 1, 0, -1))
        self.free_slots = list(range(self.engine.max_slots - 1, -1, -1))
        if self.pcache is not None:
            self.pcache.clear()
        self.cow_pending = []

    def alloc_page(self) -> Optional[int]:
        """Claim one physical page (refcount 1): the free list first, then
        LRU reclamation of an idle cached page. None when neither has
        one."""
        if self.free_pages:
            page = self.free_pages.pop()
        elif self.pcache is not None:
            page = self.pcache.evict_lru(self.page_ref)
            if page is None:
                return None
            m = self.engine._m
            if m is not None:
                m.pc_evictions.inc()
        else:
            return None
        self.page_ref[page] = 1
        return page

    def release_page(self, page: int):
        """Drop one reference; at refcount 0 the page returns to the free
        list unless the prefix cache indexes it (it then stays resident,
        LRU-evictable). Page 0 (trash) is never released."""
        page = int(page)
        if page <= 0:
            return
        ref = int(self.page_ref[page]) - 1
        if ref < 0:
            raise RuntimeError(f"page {page} refcount went negative")
        self.page_ref[page] = ref
        if ref == 0 and not (self.pcache is not None
                             and self.pcache.contains_page(page)):
            self.free_pages.append(page)

    def available_pages(self) -> int:
        """Pages an allocation burst could claim: free plus idle cached (an
        upper bound, see ``PrefixCache.evictable_count``)."""
        n = len(self.free_pages)
        if self.pcache is not None:
            n += self.pcache.evictable_count(self.page_ref)
        return n

    # ------------------------------------------------------- host tier
    def drain_tier(self):
        """Apply the host tier's completions: a no-op, there is no tier
        (the reference's behaviour with ``kv_host_pages=0``)."""

    def shutdown_tier(self):
        """Stop the host tier's spill worker: a no-op, there is none."""

    # ---------------------------------------------------- prefix cache
    def splice(self, row, prefix) -> int:
        """Splice the cached block-aligned prefix of ``prefix`` into the
        fresh table ``row`` (refcount + 1 per shared page) and return the
        tokens the prefill may skip (0 without a prefix cache).

        A FULL-prompt match still recomputes the last prompt token (its
        logits give the first generated token), and that token's K/V land
        in the last matched page, which is shared: the page is copied to a
        fresh one (``cow_pending``, flushed before the next program) and the
        splice reports ``prefix.size - 1`` cached tokens. Partial matches
        end at a page boundary, so their suffix opens fresh pages."""
        if self.pcache is None:
            return 0
        pages, matched = self.pcache.lookup(prefix)
        m = self.engine._m
        if m is not None:
            (m.pc_hits if matched else m.pc_misses).inc()
        if _TRACER.enabled:
            _TRACER.instant("cache.prefix_lookup", "cache",
                            matched=int(matched),
                            prefix_len=int(prefix.size))
        if not matched:
            return 0
        cow = None
        if matched == int(prefix.size):
            cow = self.alloc_page()
            if cow is None:
                # no page for the copy: recompute the whole last block
                pages = pages[:-1]
                matched -= self.page_size
                if not matched:
                    return 0
        for i, p in enumerate(pages if cow is None else pages[:-1]):
            row[i] = p
            self.page_ref[p] += 1
        if cow is not None:
            self.cow_pending.append((int(pages[-1]), int(cow)))
            row[len(pages) - 1] = cow
            matched -= 1  # the recomputed final token
        self.cached_tokens += matched
        if m is not None:
            m.pc_cached_tokens.inc(matched)
        return matched

    def peek(self, prefix) -> Tuple[int, int]:
        """(cached tokens, pages they save) for an admission of ``prefix``:
        a peek, with no LRU stamp and no hit/miss count. A full match still
        needs a fresh page for its copy-on-write."""
        if self.pcache is None:
            return 0, 0
        _, peeked = self.pcache.lookup(prefix, touch=False)
        reuse = peeked // self.page_size
        if peeked and peeked == int(prefix.size):
            reuse -= 1
        return peeked, reuse

    def register(self, prefix, row):
        """Publish the freshly prefilled FULL pages of ``prefix`` (table
        ``row``) in the prefix cache. Blocks already cached keep their page
        (the COW copy stays private)."""
        if self.pcache is None:
            return
        full = int(prefix.size) // self.page_size
        if full:
            self.pcache.register(prefix[:full * self.page_size],
                                 [int(row[i]) for i in range(full)])

    def drop_cow(self, row):
        """Cancel pending COW copies into ``row`` (an admission aborted
        between splice and dispatch: the row's pages are being released)."""
        if self.cow_pending:
            dead = {int(p) for p in row if p}
            self.cow_pending = [sd for sd in self.cow_pending
                                if sd[1] not in dead]

    def flush_cow(self):
        """Run the pending copy-on-write page copies (every layer's k, v and
        scale pages, src → dst) before any program writes into a spliced
        table."""
        if not self.cow_pending:
            return
        dev = self.engine.device
        src = torch.as_tensor([s for s, _ in self.cow_pending],
                              dtype=torch.int64, device=dev)
        dst = torch.as_tensor([d for _, d in self.cow_pending],
                              dtype=torch.int64, device=dev)
        for pages in (self.k_pages, self.v_pages, self.scale_pages):
            for p in pages:
                if p is not None:
                    p[dst] = p[src]
        self.cow_pending = []
