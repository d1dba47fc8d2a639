"""The port's paged cache path against paddle_tpu's: ``paged_state_prefill``
then ``paged_state_step`` on f32 and int8 pages, with ragged lengths, an
idle slot (length 0) and a slot at the table capacity. Compared: attention
outputs (f32, atol 1e-5), every page's bytes outside the trash page (exact,
int8 values and bf16 scales included) and the lengths (exact). On the CPU
the JAX step takes its ``_paged_slab_ref`` branch and the port its plain
twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as J

from paddle_tpu_torch.ops.cuda import paged_attention as T

B, H, HKV, D, PS, MAXP, P = 4, 4, 2, 16, 4, 4, 24
CAP = MAXP * PS


def _tables():
    # slot 0..2 own disjoint pages; slot 3 is idle (all-zero row → trash)
    t = np.zeros((B, MAXP), np.int32)
    t[0] = [3, 7, 1, 9]
    t[1] = [2, 5, 11, 4]
    t[2] = [6, 8, 10, 12]
    return t


def _states(quant, lengths, tables):
    kvd = np.int8 if quant else np.float32
    pages = np.zeros((P, PS, HKV * D), kvd)
    sc = np.zeros((P, PS, 128), np.float32) if quant else None
    js = J.PagedCacheState(
        jnp.asarray(pages), jnp.asarray(pages),
        None if sc is None else jnp.asarray(sc, jnp.bfloat16),
        jnp.asarray(tables), jnp.asarray(lengths), PS)
    ts = T.PagedCacheState(
        torch.from_numpy(pages.copy()), torch.from_numpy(pages.copy()),
        None if sc is None else torch.zeros((P, PS, 128),
                                            dtype=torch.bfloat16),
        torch.from_numpy(tables.copy()), torch.from_numpy(lengths.copy()),
        PS)
    return js, ts


def _assert_same_pages(js, ts):
    for jp, tp in ((js.k_pages, ts.k_pages), (js.v_pages, ts.v_pages)):
        np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    if js.scale_pages is not None:
        np.testing.assert_array_equal(
            ts.scale_pages.float().numpy()[1:],
            np.asarray(js.scale_pages.astype(jnp.float32))[1:])
    np.testing.assert_array_equal(ts.lengths.numpy(),
                                  np.asarray(js.lengths))


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_then_steps_match(quant, rng):
    tables = _tables()
    js, ts = _states(quant, np.zeros((B,), np.int32), tables)
    s0 = 16
    k = rng.standard_normal((B, s0, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s0, HKV, D)).astype(np.float32)
    # ragged prompts; slot 2 fills its table to the capacity
    real = np.array([5, 9, CAP, 1], np.int32)
    js = J.paged_state_prefill(js, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(real))
    ts = T.paged_state_prefill(ts, torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(real))
    _assert_same_pages(js, ts)
    # slot 3 turns idle (length 0) for the decode steps
    lengths = np.array([5, 9, CAP, 0], np.int32)
    js = js.replace(lengths=jnp.asarray(lengths))
    ts = ts.replace(lengths=torch.from_numpy(lengths))
    for step in range(3):
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        kk = rng.standard_normal((B, HKV, D)).astype(np.float32)
        vv = rng.standard_normal((B, HKV, D)).astype(np.float32)
        jo, js = J.paged_state_step(js, jnp.asarray(q), jnp.asarray(kk),
                                    jnp.asarray(vv))
        to, ts = T.paged_state_step(ts, torch.from_numpy(q),
                                    torch.from_numpy(kk),
                                    torch.from_numpy(vv))
        _assert_same_pages(js, ts)
        active = lengths > 0
        np.testing.assert_allclose(to.numpy()[active],
                                   np.asarray(jo)[active], atol=1e-5,
                                   rtol=0, err_msg=f"step {step}")
        # the idle slot reads zeros (the kernel's guard); the JAX ref
        # returns a window mean there, which the engine discards
        assert np.all(to.numpy()[~active] == 0)
        # the capped slot stays at the capacity
        assert int(ts.lengths[2]) == CAP
    np.testing.assert_array_equal(ts.lengths.numpy(), [8, 12, CAP, 0])


def test_quantize_rows_int8_matches(rng):
    x = (rng.standard_normal((5, 3, 16)) * 3).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    jv, js = J.quantize_rows_int8(jnp.asarray(x))
    tv, ts = T.quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant", [False, True])
def test_decode_twin_matches_jax_ref(quant, rng):
    """The plain twin against ``_paged_slab_ref`` directly, GQA group 2,
    lengths past the capacity clamped."""
    tables = _tables()
    lengths = np.array([3, CAP + 5, 11, 0], np.int32)
    if quant:
        kp = rng.integers(-127, 128, (P, PS, HKV * D)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, PS, HKV * D)).astype(np.int8)
        sc = np.zeros((P, PS, 128), np.float32)
        sc[..., :2 * HKV] = rng.uniform(0.001, 0.02, (P, PS, 2 * HKV))
        jsc = jnp.asarray(sc, jnp.bfloat16)
        tsc = torch.from_numpy(sc).bfloat16()
    else:
        kp = rng.standard_normal((P, PS, HKV * D)).astype(np.float32)
        vp = rng.standard_normal((P, PS, HKV * D)).astype(np.float32)
        jsc = tsc = None
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    want = np.asarray(J._paged_slab_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), 1 / np.sqrt(D), jsc))
    got = T.paged_slab_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lengths), H,
        scale_pages=tsc).numpy()
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-5, rtol=0)
    assert np.all(got[3] == 0)


def test_verify_state_not_ported():
    """A verify state used to raise here; it now takes the multi-query
    path (``paged_state_verify``, held against the JAX one in
    ``test_torch_verify.py``), checked before the prefill branch (whose
    context attention ignores the cache): every active slot appends the
    block, the idle slot stays at length 0, and the output keeps q's
    shape."""
    lengths = np.array([1, 1, 1, 0], np.int32)
    js, ts = _states(False, lengths, _tables())
    x = torch.zeros((B, 2, H, D))
    kv = torch.zeros((B, 2, HKV, D))

    def context():
        raise AssertionError("verify must not take the prefill branch")

    out, st = T.paged_forward(ts.replace(verify=True), x, kv, kv, context)
    assert out.shape == x.shape and torch.isfinite(out).all()
    np.testing.assert_array_equal(st.lengths.numpy(), [3, 3, 3, 0])


def test_decode_rejects_bad_operands(rng):
    tables = torch.from_numpy(_tables())
    lens = torch.ones((B,), dtype=torch.int32)
    q = torch.zeros((B, H, D))
    pages = torch.zeros((P, PS, HKV * D))
    with pytest.raises(TypeError):  # int8 pages without scales
        T.paged_slab_decode_attention(q, pages.to(torch.int8),
                                      pages.to(torch.int8), tables, lens)
    with pytest.raises(ValueError):  # lanes that split a head
        T.paged_slab_decode_attention(q, pages[..., :-1], pages[..., :-1],
                                      tables, lens)
    with pytest.raises(ValueError):
        T.paged_slab_decode_attention(q, pages, pages, tables[:2], lens)
