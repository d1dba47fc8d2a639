"""Page pool, allocator, prefix cache and host KV tier of the serving
engine, after ``paddle_tpu/inference/cache_coord.py``.

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

With ``kv_host_pages=N`` (which needs the prefix cache) the host tier
(``kv_tier.HostTier``) sits under the pool: reclamation demotes an idle
cached page to pinned host memory instead of evicting it, a later hit
promotes it back (:meth:`drain_tier` applies the tier's completions,
:meth:`shutdown_tier` stops its worker), and :meth:`export_handoff` ships a
prompt's cached pages to another engine. The splice and the registration
of the prefix cache carry the reference engine's tiered lookup, its
bounded promote wait and the integrity sentinel's checksum probes
(``integrity.py``): in the reference these sit in the engine's
``_splice_prefix`` and ``_register_prefix``, here in :meth:`splice` and
:meth:`register`.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..observability.tracing import TRACER as _TRACER
from .prefix_cache import PrefixCache

__all__ = ["CacheCoordinator"]


class CacheCoordinator:
    """Paged KV pool + host allocator + prefix cache for one engine."""

    def __init__(self, engine, prefix_cache: bool = False,
                 kv_host_pages: int = 0):
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
        # the host tier: idle cached pages demote to host memory instead
        # of being evicted, and a later hit promotes them back
        self.tier = None
        if kv_host_pages:
            if self.pcache is None:
                raise ValueError(
                    "kv_host_pages > 0 requires prefix_cache=True (the "
                    "host tier spills idle PREFIX-CACHE pages; without "
                    "the cache there is nothing to demote)")
            from .kv_tier import HostTier

            self.tier = HostTier(self, kv_host_pages)
        self.reset()

    def _allocate(self):
        eng = self.engine
        cfg = eng.cfg
        store = torch.int8 if eng.quantized else eng.dtype
        # GPT has no num_kv_heads: one K/V head a query head
        n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
        shape = (self.num_pages, self.page_size, n_kv * cfg.head_dim)
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

    def pages_flat(self) -> List[torch.Tensor]:
        """Every pool buffer in the reference's order: k, v, then (int8
        pages) the scales, one per layer each."""
        out = list(self.k_pages) + list(self.v_pages)
        if self.engine.quantized:
            out += list(self.scale_pages)
        return out

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
        left as is: data only counts below a slot's ``lengths``. The page
        checksums and the host tier go too: they describe a pool whose
        state a fault left in doubt."""
        ig = getattr(self.engine, "_integrity", None)
        if ig is not None:
            # getattr: construction resets before the sentinel exists
            ig.reset_kv()
        self.tables[:] = 0
        self.lengths[:] = 0
        self.page_ref[:] = 0
        self.free_pages = list(range(self.num_pages - 1, 0, -1))
        self.free_slots = list(range(self.engine.max_slots - 1, -1, -1))
        if self.pcache is not None:
            self.pcache.clear()
        if self.tier is not None:
            self.tier.reset()
        self.cow_pending = []

    def alloc_page(self) -> Optional[int]:
        """Claim one physical page (refcount 1): the free list first, then
        LRU reclamation of an idle cached page, which the host tier, when
        armed, demotes (its bytes are gathered on the engine's stream
        before this returns) instead of evicting. None when neither has
        one."""
        if self.free_pages:
            page = self.free_pages.pop()
        elif self.pcache is not None:
            if self.tier is not None:
                taken = self.pcache.take_for_demotion(self.page_ref)
                if taken is None:
                    return None
                page, ent = taken
                self.tier.demote(page, ent)
            else:
                page = self.pcache.evict_lru(self.page_ref)
                if page is None:
                    return None
            m = self.engine._m
            if m is not None:
                m.pc_evictions.inc()
        else:
            return None
        self.page_ref[page] = 1
        ig = getattr(self.engine, "_integrity", None)
        if ig is not None:
            # a new owner: the checksum of the old content is stale
            ig.forget_page(page)
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

    def grow(self, slot, need) -> bool:
        """Give ``slot``'s table its first ``need`` pages, claiming the
        missing ones (``alloc_page``). On a shortfall the claimed pages go
        back and False leaves the allocator unchanged."""
        # count actual allocations: chain headroom can exceed the pages a
        # slot's length needs
        have = int(np.count_nonzero(self.tables[slot]))
        taken = []
        for i in range(have, need):
            page = self.alloc_page()
            if page is None:
                for j in range(have, have + len(taken)):
                    self.tables[slot, j] = 0
                for pg in reversed(taken):
                    self.release_page(pg)
                return False
            taken.append(page)
            self.tables[slot, i] = page
        return True

    def trim(self, slot, keep):
        """Release ``slot``'s pages past its first ``keep`` (a spliced
        shared page merely loses this slot's reference)."""
        have = int(np.count_nonzero(self.tables[slot]))
        for i in range(have - 1, keep - 1, -1):
            self.release_page(int(self.tables[slot, i]))
            self.tables[slot, i] = 0

    def release_slot(self, slot):
        """Drop every page reference of ``slot``'s table (shared pages
        survive for their other referents, cached ones stay resident at
        refcount 0) and zero its row and length."""
        for p in self.tables[slot]:
            if p:
                self.release_page(int(p))
        self.tables[slot, :] = 0
        self.lengths[slot] = 0

    def available_pages(self) -> int:
        """Pages an allocation burst could claim: free plus idle cached (an
        upper bound, see ``PrefixCache.evictable_count``)."""
        n = len(self.free_pages)
        if self.pcache is not None:
            n += self.pcache.evictable_count(self.page_ref)
        return n

    # ------------------------------------------------------- host tier
    def drain_tier(self):
        """Apply the host tier's completions (no-op without a tier): landed
        spills become host-resident entries, verified promotions restore
        into the pool. Engine thread, at step and admission boundaries."""
        if self.tier is not None:
            self.tier.drain()

    def shutdown_tier(self):
        """Stop the host tier's worker (front-end drain or shutdown,
        quarantine). Idempotent; a no-op without a tier."""
        if self.tier is not None:
            self.tier.stop()

    def export_handoff(self, tokens) -> Optional[dict]:
        """The prompt's cached KV pages as a handoff payload
        (``kv_tier.capture_handoff_spill``) for another engine's
        ``adopt_kv_pages``. Engine thread; waits for the device-to-host
        copy. None when nothing is cached."""
        if self.pcache is None:
            return None
        from .kv_tier import capture_handoff_spill

        return capture_handoff_spill(self.engine, tokens)

    # ---------------------------------------------------- prefix cache
    def splice(self, row, prefix) -> int:
        """Splice the cached block-aligned prefix of ``prefix`` into the
        fresh table ``row`` (refcount + 1 per shared page) and return the
        tokens the prefill may skip (0 without a prefix cache). The
        engine's ``prefix-cache-corruption`` and ``bit-flip-kv`` fault
        points fire here, on a hit (``Engine._fi``).

        With the host tier, demoted blocks of the chain are promoted (most
        already are in flight: ``add_request`` prefetched them) and given a
        bounded wait (``Engine._last_promote_wait_s`` records it); what
        landed splices like any cached page, what did not rides the
        suffix prefill. With the integrity sentinel, the matched pages'
        checksums are verified before the splice commits: a mismatch
        invalidates and contains them, and the admission recomputes.

        A FULL-prompt match still recomputes the last prompt token (its
        logits give the first generated token), and that token's K/V land
        in the last matched page, which is shared: the page is copied to a
        fresh one (``cow_pending``, flushed before the next program) and the
        splice reports ``prefix.size - 1`` cached tokens. Partial matches
        end at a page boundary, so their suffix opens fresh pages."""
        eng = self.engine
        eng._last_promote_wait_s = 0.0
        if self.pcache is None:
            return 0
        if self.tier is not None:
            _, _, demoted = self.pcache.lookup(prefix, touch=False,
                                               tiers=True)
            if demoted:
                self.tier.request_promote(demoted)
                t0 = time.perf_counter()
                self.tier.await_promotions(demoted)
                eng._last_promote_wait_s = time.perf_counter() - t0
                if _TRACER.enabled:
                    _TRACER.instant(
                        "kvtier.promote_wait", "cache",
                        waited_s=eng._last_promote_wait_s,
                        pages=len(demoted))
        pages, matched = self.pcache.lookup(prefix)
        fi = eng._fi
        if matched and fi is not None \
                and fi.fire("prefix-cache-corruption"):
            # invalidate on doubt: the doubted page's bytes are damaged
            # (when idle), it and every descendant block leave the cache,
            # and this admission recomputes from scratch — a miss, never a
            # wrong token
            doubted = pages[-1]
            if int(self.page_ref[doubted]) == 0:
                self.corrupt_page(doubted)
            for p in self.pcache.invalidate_page(doubted):
                if int(self.page_ref[p]) == 0:
                    self.free_pages.append(p)
            pages, matched = [], 0
            self.pcache.hits -= 1
            self.pcache.misses += 1
        if matched and fi is not None and fi.fire("bit-flip-kv"):
            # silent damage, nothing invalidates: only the checksum probe
            # below stands between this flip and a wrong token
            doomed = pages[-1]
            if int(self.page_ref[doomed]) == 0:
                self.corrupt_page(doomed)
        ig = eng._integrity
        if matched and ig is not None:
            # the lookup's token compare proves the entry; the probe
            # proves the page's bytes since its registration
            bad = ig.verify_pages(pages)
            if bad:
                eng._contain_kv_corruption(bad)
                pages, matched = [], 0
                self.pcache.hits -= 1
                self.pcache.misses += 1
        m = eng._m
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
        (the COW copy stays private). With the integrity sentinel, every
        page now backing these blocks is checksummed: a fresh page records
        its sum, a page already cached (perhaps idle since its first
        registration) is verified against it."""
        if self.pcache is None:
            return
        full = int(prefix.size) // self.page_size
        if full:
            blocks = prefix[:full * self.page_size]
            self.pcache.register(blocks, [int(row[i]) for i in range(full)])
            ig = self.engine._integrity
            if ig is not None:
                # the canonical pages (dedup may keep another's): a peek
                pages, _ = self.pcache.lookup(blocks, touch=False)
                bad = ig.note_registered(pages)
                if bad:
                    self.engine._contain_kv_corruption(bad)

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

    def corrupt_page(self, page: int):
        """The ``prefix-cache-corruption`` / ``bit-flip-kv`` fault points'
        damage: garbage layer-0 K rows for one cached page, written in
        place (the captured graphs hold these buffers). A page is only read
        below ``lengths``, rows its next owner rewrites first, and a spliced
        one is checked first when the integrity sentinel is on."""
        self.k_pages[0][int(page)].fill_(
            57 if self.engine.quantized else 1e3)
