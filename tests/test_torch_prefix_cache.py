"""The port's ``PrefixCache`` (pure host code), the unit cases of
``tests/test_prefix_cache.py::TestPrefixCacheUnit`` run against it, plus
its chain keys against the JAX package's on the same tokens."""
import numpy as np

from paddle_tpu.inference.prefix_cache import chain_keys as jax_chain_keys

from paddle_tpu_torch.inference.prefix_cache import PrefixCache, chain_keys
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)


class TestPrefixCacheUnit:
    def test_chain_lookup_roundtrip(self):
        pc = PrefixCache(4)
        toks = np.arange(12, dtype=np.int32)
        assert pc.register(toks, [5, 6, 7]) == 3
        pages, matched = pc.lookup(toks)
        assert pages == [5, 6, 7] and matched == 12
        # block-aligned: a 10-token prefix matches 2 blocks
        pages, matched = pc.lookup(toks[:10])
        assert pages == [5, 6] and matched == 8
        # divergence mid-chain stops the walk
        div = toks.copy()
        div[6] = 90
        pages, matched = pc.lookup(div)
        assert pages == [5] and matched == 4
        # a different FIRST block shares nothing even if later blocks
        # match token-wise (the chain hash commits to the whole prefix)
        shifted = np.concatenate([[77], toks[1:]]).astype(np.int32)
        assert pc.lookup(shifted) == ([], 0)
        assert pc.hits == 3 and pc.misses == 1

    def test_register_dedup_keeps_first(self):
        pc = PrefixCache(4)
        toks = np.arange(8, dtype=np.int32)
        assert pc.register(toks, [3, 4]) == 2
        assert pc.register(toks, [9, 10]) == 0  # duplicate content
        assert pc.lookup(toks)[0] == [3, 4]
        assert pc.n_pages == 2

    def test_verify_on_hit_catches_tampered_entry(self):
        pc = PrefixCache(4)
        toks = np.arange(8, dtype=np.int32)
        pc.register(toks, [3, 4])
        # a hash collision / corrupted index: the entry's tokens no longer
        # match what its key claims
        ent = next(iter(pc._by_key.values()))
        ent.tokens = ent.tokens + 1
        pages, matched = pc.lookup(toks)
        assert matched < 8  # a (partial) miss, not wrong pages

    def test_lru_evicts_leaf_first_and_oldest(self):
        pc = PrefixCache(4)
        a = np.arange(8, dtype=np.int32)
        b = np.arange(100, 108, dtype=np.int32)
        pc.register(a, [1, 2])
        pc.register(b, [3, 4])
        pc.lookup(a)  # touch chain a
        ref = np.zeros(16, np.int64)
        # the oldest chain (b) unwinds first, leaf before parent
        assert pc.evict_lru(ref) == 4
        assert pc.evict_lru(ref) == 3
        assert pc.evict_lru(ref) == 2  # then a's leaf
        assert pc.evict_lru(ref) == 1
        assert pc.evict_lru(ref) is None
        assert pc.evictions == 4

    def test_evict_never_touches_referenced_pages(self):
        pc = PrefixCache(4)
        pc.register(np.arange(8, dtype=np.int32), [1, 2])
        ref = np.zeros(16, np.int64)
        ref[2] = 1  # the leaf page is live
        # leaf pinned -> parent is interior -> nothing evictable
        assert pc.evict_lru(ref) is None
        assert pc.evictable_count(ref) == 1
        ref[2] = 0
        assert pc.evict_lru(ref) == 2

    def test_invalidate_drops_descendants(self):
        pc = PrefixCache(4)
        toks = np.arange(16, dtype=np.int32)
        pc.register(toks, [1, 2, 3, 4])
        dropped = pc.invalidate_page(2)
        assert sorted(dropped) == [2, 3, 4]  # block 1 and everything under
        pages, matched = pc.lookup(toks)
        assert pages == [1] and matched == 4
        assert pc.clear() == [1] and pc.n_pages == 0

    def test_trash_page_and_taken_pages_stop_registration(self):
        pc = PrefixCache(4)
        toks = np.arange(12, dtype=np.int32)
        assert pc.register(toks, [5, 0, 7]) == 1  # page 0 is the trash page
        assert pc.register(np.arange(50, 54, dtype=np.int32), [5]) == 0
        assert pc.lookup(toks) == ([5], 4)


def test_chain_keys_match_jax():
    toks = np.random.default_rng(0).integers(0, 32000, (70,))
    assert chain_keys(toks, 16) == jax_chain_keys(toks, 16)
    assert len(chain_keys(toks, 16)) == 4
