"""The port's contiguous and host-paged decode attention against
paddle_tpu's, on the CPU.

* The plain versions (``decode_attention_ref``, ``_slab_ref``,
  ``paged_decode_attention_ref``) and the CPU route of the wrappers of
  kernels #14, #15 and #4 against the JAX plain versions AND the Pallas
  kernels ``decode_attention_pallas``, ``_slab_pallas`` and
  ``paged_decode_attention`` in interpret mode: GQA, ragged lengths, int8
  pages. f32 within 2e-5 (the reference's own kernel-vs-twin bound).
* The length-0 rule: the port gives zeros; the JAX plain version gives the
  mean of V over the window (recorded in ROADMAP queue C).
* ``cache_prefill_write`` / ``cache_decode_step`` on the slab and the 5-D
  layout, ``masked_multihead_attention`` and the decode gradient (the
  reference's custom_vjp through the plain version).
* ``PagedKVCache``: prefill, append, ``free``, page recycling, pool
  exhaustion, attend, and ``paged_forward``'s ``time_step`` check.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the functions paddle_tpu.ops.pallas re-exports by the
# same names
JD = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")
JP = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
JF = importlib.import_module("paddle_tpu.incubate.nn.functional")

from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.ops.cuda import decode_attention as TD
from paddle_tpu_torch.ops.cuda import paged_attention as TP

ATOL = 2e-5
B, S, D = 3, 24, 32
LENS = [1, 13, 24]
HEADS = [(4, 4), (4, 2), (8, 1)]  # (H, Hkv): MHA, GQA 2, GQA 8


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _case(seed, h, h_kv, s=S):
    rng = np.random.default_rng(seed)
    return (_f32(rng, (B, h, D)), _f32(rng, (B, h_kv, s, D)),
            _f32(rng, (B, h_kv, s, D)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("h,h_kv", HEADS)
def test_decode_attention_matches_jax(h, h_kv):
    q, k, v = _case(h + h_kv, h, h_kv)
    lens = np.array(LENS, np.int32)
    want_ref = np.asarray(JD.decode_attention_ref(q, k, v, lens))
    want_kernel = np.asarray(JD.decode_attention_pallas(q, k, v, lens))
    got_ref = TD.decode_attention_ref(*_t(q, k, v, lens)).numpy()
    before = TD.decode_attention.launches
    got = TD.decode_attention(*_t(q, k, v, lens)).numpy()
    assert TD.decode_attention.launches == before  # the CPU launches none
    np.testing.assert_allclose(want_kernel, want_ref, atol=ATOL, rtol=0)
    for out in (got_ref, got):
        np.testing.assert_allclose(out, want_ref, atol=ATOL, rtol=0)
        np.testing.assert_allclose(out, want_kernel, atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,h_kv", HEADS)
def test_slab_decode_matches_jax(h, h_kv):
    q, k, v = _case(7 * h + h_kv, h, h_kv)
    # the slab [2, B, S, Hkv*D] holding the same rows
    slab = np.stack([k, v]).transpose(0, 1, 3, 2, 4).reshape(
        2, B, S, h_kv * D)
    lens = np.array(LENS, np.int32)
    scale = 1.0 / np.sqrt(D)
    want_ref = np.asarray(JD._slab_ref(q, slab, lens, scale))
    want_kernel = np.asarray(JD._slab_pallas(q, slab, lens, scale))
    np.testing.assert_allclose(want_kernel, want_ref, atol=ATOL, rtol=0)
    got_ref = TD._slab_ref(*_t(q, slab, lens)).numpy()
    got = TD.decode_attention_slab(*_t(q, slab, lens)).numpy()
    for out in (got_ref, got):
        np.testing.assert_allclose(out, want_ref, atol=ATOL, rtol=0)
    # the same rows through the 5-D layout's function
    np.testing.assert_allclose(got, TD.decode_attention(*_t(q, k, v, lens))
                               .numpy(), atol=1e-6, rtol=0)


def test_strided_slab_view_and_custom_scale():
    """A slab view cut from a wider one (its batch stride is the wide
    slab's) and a non-default scale."""
    q, k, v = _case(3, 4, 2, s=40)
    wide = np.stack([k, v]).transpose(0, 1, 3, 2, 4).reshape(2, B, 40, 2 * D)
    lens = np.array([5, 20, 24], np.int32)
    want = np.asarray(JD._slab_ref(q, wide[:, :, :S], lens, 0.3))
    view = torch.from_numpy(wide)[:, :, :S]
    assert not view.is_contiguous()
    got = TD.decode_attention_slab(torch.from_numpy(q), view,
                                   torch.from_numpy(lens), scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_length_zero_rule():
    """Length 0 gives zeros in the port (kernels and plain versions alike);
    the JAX plain version gives the mean of V over the window there. No
    caller passes 0 (generation passes time_step + 1)."""
    q, k, v = _case(11, 4, 2)
    lens = np.array([0, 5, 0], np.int32)
    got = TD.decode_attention(*_t(q, k, v, lens)).numpy()
    want = np.asarray(JD.decode_attention_ref(q, k, v, lens))
    assert np.all(got[0] == 0) and np.all(got[2] == 0)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=0)
    mean_v = np.repeat(v.mean(axis=2), 2, axis=1)  # GQA group 2
    np.testing.assert_allclose(want[0], mean_v[0], atol=1e-5, rtol=0)


def test_decode_gradient_matches_custom_vjp():
    q, k, v = _case(5, 4, 2)
    lens = np.array(LENS, np.int32)
    rng = np.random.default_rng(9)
    g = _f32(rng, q.shape)

    def loss(a, b, c):
        return jnp.sum(JD.decode_attention(a, b, c, lens) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = TD.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("rank", [4, 5])
def test_cache_prefill_and_decode_step_match_jax(rank):
    h, h_kv, s0, smax = 4, 2, 6, 16
    rng = np.random.default_rng(rank)
    if rank == 4:
        cache = np.zeros((2, B, smax, h_kv * D), np.float32)
    else:
        cache = np.zeros((2, B, h_kv, smax, D), np.float32)
    k0, v0 = _f32(rng, (B, s0, h_kv, D)), _f32(rng, (B, s0, h_kv, D))
    jc = JD.cache_prefill_write(jnp.asarray(cache), k0, v0)
    tc = TD.cache_prefill_write(torch.from_numpy(cache.copy()),
                                *_t(k0, v0))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for step, ts in enumerate((s0, s0 + 1, torch.tensor(s0 + 2))):
        q = _f32(rng, (B, 1, h, D))
        k, v = _f32(rng, (B, 1, h_kv, D)), _f32(rng, (B, 1, h_kv, D))
        want, jc = JD.cache_decode_step(jc, q, k, v, int(ts))
        got, tc2 = TD.cache_decode_step(tc, *_t(q, k, v), ts)
        assert tc2 is tc  # written in place
        assert got.shape == (B, 1, h, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_cache_layout_refused():
    with pytest.raises(TypeError, match="cache"):
        TD.cache_prefill_write(torch.zeros(2, 3, 4), torch.zeros(1, 1, 1, 4),
                               torch.zeros(1, 1, 1, 4))


def test_make_kv_slab():
    slab = TD.make_kv_slab(2, 9, 3, 32, dtype=torch.bfloat16, device="cpu")
    assert slab.shape == (2, 2, 9, 96) and slab.dtype == torch.bfloat16
    assert not slab.any()
    want = JD.make_kv_slab(2, 9, 3, 32)
    assert tuple(want.shape) == tuple(slab.shape)


def test_masked_multihead_attention_matches_jax():
    nh, smax = 4, 12
    rng = np.random.default_rng(21)
    cache = _f32(rng, (2, B, nh, smax, D))
    x = _f32(rng, (B, 3 * nh * D))
    lens = np.array([0, 4, 11], np.int32)
    jout, jcache = JF.masked_multihead_attention(
        jnp.asarray(x), cache_kv=jnp.asarray(cache),
        sequence_lengths=jnp.asarray(lens))
    tcache = torch.from_numpy(cache.copy())
    out, got_cache = TF.masked_multihead_attention(
        torch.from_numpy(x), cache_kv=tcache,
        sequence_lengths=torch.from_numpy(lens))
    assert got_cache is tcache  # written in place
    np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache._data))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout._data),
                               atol=ATOL, rtol=0)


def test_masked_multihead_attention_refusals():
    x = torch.zeros((1, 3 * 2 * D))
    cache = torch.zeros((2, 1, 2, 4, D))
    with pytest.raises(NotImplementedError) as got:
        TF.masked_multihead_attention(x, cache, src_mask=x, out_scale=2.0,
                                      sequence_lengths=torch.zeros(1))
    with pytest.raises(NotImplementedError) as want:
        JF.masked_multihead_attention(
            jnp.zeros((1, 3 * 2 * D)), jnp.zeros((2, 1, 2, 4, D)),
            src_mask=jnp.zeros(1), out_scale=2.0,
            sequence_lengths=jnp.zeros(1))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="sequence_lengths"):
        TF.masked_multihead_attention(x, cache)


# ----------------------------------------------------- host-paged cache (#4)
PS, NPAGES, MAXP = 4, 16, 5


def _pages(seed, h_kv, quant):
    rng = np.random.default_rng(seed)
    k = _f32(rng, (h_kv, NPAGES, PS, D))
    v = _f32(rng, (h_kv, NPAGES, PS, D))
    if not quant:
        return k, v, None, None
    kq, ks = (np.asarray(a) for a in JP.quantize_rows_int8(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in JP.quantize_rows_int8(jnp.asarray(v)))
    return kq, vq, ks, vs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,h_kv", HEADS)
def test_paged_decode_attention_matches_jax(quant, h, h_kv):
    k, v, ks, vs = _pages(h * 3 + h_kv + quant, h_kv, quant)
    rng = np.random.default_rng(h)
    q = _f32(rng, (B, h, D))
    tables = rng.permutation(NPAGES)[:B * MAXP].reshape(B, MAXP).astype(
        np.int32)
    lens = np.array([1, 9, MAXP * PS], np.int32)
    want_ref = np.asarray(JP.paged_decode_attention_ref(
        q, k, v, tables, lens, k_scales=ks, v_scales=vs))
    want_kernel = np.asarray(JP.paged_decode_attention(
        q, k, v, tables, lens, k_scales=ks, v_scales=vs))
    np.testing.assert_allclose(want_kernel, want_ref, atol=ATOL, rtol=0)
    args = _t(q, k, v, tables, lens)
    sc = dict(k_scales=None if ks is None else torch.from_numpy(ks),
              v_scales=None if vs is None else torch.from_numpy(vs))
    got_ref = TP.paged_decode_attention_ref(*args, **sc)
    got = TP.paged_decode_attention(*args, **sc)
    for out in (got_ref, got):
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want_ref, atol=ATOL, rtol=0)
    # length 0 gives zeros (the kernel's guard)
    zero = TP.paged_decode_attention(
        *_t(q, k, v, tables, np.array([0, 3, 0], np.int32)), **sc)
    assert not zero[0].any() and not zero[2].any()


def test_paged_decode_attention_refuses():
    q = torch.zeros((2, 4, D))
    pages = torch.zeros((2, NPAGES, PS, D))
    tables = torch.zeros((2, MAXP), dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):  # int8 pages without scales
        TP.paged_decode_attention(q, pages.to(torch.int8),
                                  pages.to(torch.int8), tables, lens)
    with pytest.raises(ValueError):  # head dims disagree
        TP.paged_decode_attention(q, pages[..., :-1], pages[..., :-1],
                                  tables, lens)
    with pytest.raises(ValueError):
        TP.paged_decode_attention(q, pages, pages, tables[:1], lens)


def _caches(quant, h_kv=2, batch=2):
    kw = dict(num_pages=8, page_size=PS, batch_size=batch,
              num_kv_heads=h_kv, head_dim=D, max_pages_per_seq=3,
              quantized=quant)
    return (JP.PagedKVCache(dtype=jnp.float32, **kw),
            TP.PagedKVCache(dtype=torch.float32, device="cpu", **kw))


def _same_state(jc, tc):
    np.testing.assert_array_equal(tc.block_tables, jc.block_tables)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    assert tc._free == jc._free
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    if jc.quantized:
        np.testing.assert_allclose(tc.k_scales.numpy(),
                                   np.asarray(jc.k_scales), rtol=1e-7)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kv_cache_matches_jax(quant):
    """Prefill 5 tokens, append 4 (crossing a page), attend after each;
    free slot 0 and prefill it again: its pages come back from the free
    list in the reference's order."""
    jc, tc = _caches(quant)
    rng = np.random.default_rng(31 + quant)
    k, v = _f32(rng, (2, 5, 2, D)), _f32(rng, (2, 5, 2, D))
    jc.prefill(jnp.asarray(k), jnp.asarray(v))
    tc.prefill(*_t(k, v))
    _same_state(jc, tc)
    for _ in range(4):
        k, v = _f32(rng, (2, 2, D)), _f32(rng, (2, 2, D))
        jc.append(jnp.asarray(k), jnp.asarray(v))
        tc.append(*_t(k, v))
        q = _f32(rng, (2, 4, D))
        want = np.asarray(jc.attend(jnp.asarray(q)))
        got = tc.attend(torch.from_numpy(q))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    _same_state(jc, tc)
    jc.free(0)
    tc.free(0)
    _same_state(jc, tc)
    k, v = _f32(rng, (1, 7, 2, D)), _f32(rng, (1, 7, 2, D))
    jc.prefill(jnp.asarray(k), jnp.asarray(v))
    tc.prefill(*_t(k, v))
    _same_state(jc, tc)


def test_paged_kv_cache_limits():
    """A sequence past ``max_pages_per_seq`` and a pool too small for the
    batch raise as the reference's do; a non-empty slot refuses a
    prefill."""
    _, tc = _caches(False)
    with pytest.raises(ValueError, match="max_pages"):
        tc.prefill(torch.zeros((2, 13, 2, D)), torch.zeros((2, 13, 2, D)))
    _, tc = _caches(False, batch=3)  # 3 slots x 3 pages > 8 pages
    with pytest.raises(RuntimeError, match="exhausted"):
        tc.prefill(torch.zeros((3, 12, 2, D)), torch.zeros((3, 12, 2, D)))
    _, tc = _caches(False)
    tc.prefill(torch.zeros((2, 3, 2, D)), torch.zeros((2, 3, 2, D)))
    with pytest.raises(ValueError, match="non-empty"):
        tc.prefill(torch.zeros((2, 3, 2, D)), torch.zeros((2, 3, 2, D)))


def test_paged_forward_checks_time_step():
    """Decode through ``paged_forward`` appends at ``time_step``, which
    must equal every slot's length; prefill (``time_step`` None) returns
    the context attention."""
    _, tc = _caches(False)
    x = torch.zeros((2, 3, 4, D))
    kv = torch.ones((2, 3, 2, D))
    out, same = TP.paged_forward(tc, x, kv, kv, lambda: "context")
    assert out == "context" and same is tc
    np.testing.assert_array_equal(tc.lengths, [3, 3])
    q1, kv1 = torch.zeros((2, 1, 4, D)), torch.ones((2, 1, 2, D))
    with pytest.raises(ValueError, match="time_step=2"):
        TP.paged_forward(tc, q1, kv1, kv1, None, time_step=2)
    out, _ = TP.paged_forward(tc, q1, kv1, kv1, None, time_step=3)
    assert out.shape == (2, 1, 4, D)
    np.testing.assert_array_equal(tc.lengths, [4, 4])
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-6)  # V is ones
