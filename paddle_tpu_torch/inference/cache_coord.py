"""Page pool and allocator of the serving engine, after
``paddle_tpu/inference/cache_coord.py`` without the prefix cache and the
host tier.

The device page buffers (``k_pages`` / ``v_pages`` per layer, plus bf16
``scale_pages`` when the cache is int8) are allocated ONCE on the engine's
device and written in place by every forward. The allocator state (block
tables, lengths, per-page refcounts, free lists) lives on the host in
numpy. Physical page 0 is the trash page: never allocated, the target of
every idle or padding write.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["CacheCoordinator"]


class CacheCoordinator:
    """Paged KV pool + host allocator for one engine."""

    def __init__(self, engine):
        self.engine = engine
        self.num_pages = engine.num_pages
        self.page_size = engine.page_size
        self.tables = np.zeros(
            (engine.max_slots, engine.max_pages_per_seq), np.int32)
        self.lengths = np.zeros((engine.max_slots,), np.int32)
        self.page_ref = np.zeros((self.num_pages,), np.int32)
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

    def reset(self):
        """Empty the allocator: every page free (page 0 stays the trash
        page), every slot free. Page content is left as is: data only
        counts below a slot's ``lengths``."""
        self.tables[:] = 0
        self.lengths[:] = 0
        self.page_ref[:] = 0
        self.free_pages = list(range(self.num_pages - 1, 0, -1))
        self.free_slots = list(range(self.engine.max_slots - 1, -1, -1))

    def alloc_page(self) -> Optional[int]:
        """Claim one physical page (refcount 1), or None when the pool is
        empty."""
        if not self.free_pages:
            return None
        page = self.free_pages.pop()
        self.page_ref[page] = 1
        return page

    def release_page(self, page: int):
        """Drop one reference; at refcount 0 the page returns to the free
        list. Page 0 (trash) is never released."""
        page = int(page)
        if page <= 0:
            return
        ref = int(self.page_ref[page]) - 1
        if ref < 0:
            raise RuntimeError(f"page {page} refcount went negative")
        self.page_ref[page] = ref
        if ref == 0:
            self.free_pages.append(page)

    def available_pages(self) -> int:
        return len(self.free_pages)
