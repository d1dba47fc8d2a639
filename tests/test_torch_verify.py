"""The port's multi-query verify path against paddle_tpu's: the plain twin of
the verify kernel against ``_paged_multi_query_ref``, and
``paged_state_verify`` against the JAX one, in both of its forms (spec
verify, and partial prefill with per-row widths). Covered: ragged per-row
bases with base 0, GQA (4 q heads over 2 kv heads), m not a multiple of 8,
int8 pages with bf16 scale lanes, and bases past the table capacity.

On the CPU the JAX side takes ``_paged_multi_query_ref`` (its dispatch's
CPU branch) and the port its plain twin. Tolerance (the same math; the
einsum summation orders differ): atol 2e-6 on f32 pages; atol = rtol =
1e-4 on int8 pages, whose dequantised values reach about 25. Pages (every
page but the trash page 0, whose content depends on the order of duplicate
scatter writes) and lengths must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as J

from paddle_tpu_torch.ops.cuda import paged_attention as T
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

H, HKV, D, PS, MAXP = 4, 2, 32, 8, 4
KHD = HKV * D
CAP = MAXP * PS


def _tol(quantized):
    return dict(atol=1e-4, rtol=1e-4) if quantized else dict(atol=2e-6,
                                                             rtol=0)


def _pages(rng, b, quantized):
    p_total = 1 + b * MAXP
    if quantized:
        kp = rng.integers(-127, 128, (p_total, PS, KHD)).astype(np.int8)
        vp = rng.integers(-127, 128, (p_total, PS, KHD)).astype(np.int8)
        sc = np.zeros((p_total, PS, 128), np.float32)
        sc[..., :2 * HKV] = (rng.standard_normal((p_total, PS, 2 * HKV))
                             * 0.05 + 0.1)
        # round through bf16 once so both sides hold the same scales
        sc = np.asarray(jnp.asarray(sc, jnp.bfloat16).astype(jnp.float32))
    else:
        kp = rng.standard_normal((p_total, PS, KHD)).astype(np.float32)
        vp = rng.standard_normal((p_total, PS, KHD)).astype(np.float32)
        sc = None
    tables = np.arange(1, 1 + b * MAXP, dtype=np.int32).reshape(b, MAXP)
    return kp, vp, sc, tables


def _states(kp, vp, sc, tables, lengths, prefill_valid=None):
    js = J.PagedCacheState(
        jnp.asarray(kp), jnp.asarray(vp),
        None if sc is None else jnp.asarray(sc, jnp.bfloat16),
        jnp.asarray(tables), jnp.asarray(lengths), PS,
        prefill_valid=(None if prefill_valid is None
                       else jnp.asarray(prefill_valid)),
        verify=True)
    ts = T.PagedCacheState(
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
        None if sc is None else torch.from_numpy(sc.copy()).bfloat16(),
        torch.from_numpy(tables.copy()), torch.from_numpy(lengths.copy()),
        PS, prefill_valid=(None if prefill_valid is None
                           else torch.from_numpy(prefill_valid.copy())),
        verify=True)
    return js, ts


def _twin(q, kp, vp, sc, tables, base):
    return T.paged_verify_slab_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(base),
        scale_pages=(None if sc is None
                     else torch.from_numpy(sc.copy()).bfloat16()))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("m", [1, 5, 9])
def test_twin_matches_jax_ref(quantized, m):
    rng = np.random.default_rng(m)
    b = 3
    kp, vp, sc, tables = _pages(rng, b, quantized)
    base = np.array([17, 0, 26], np.int32)
    q = rng.standard_normal((b, m, H, D)).astype(np.float32)
    js, _ = _states(kp, vp, sc, tables, base + m)
    want = np.asarray(J._paged_multi_query_ref(jnp.asarray(q), js,
                                               jnp.asarray(base)))
    got = _twin(q, kp, vp, sc, tables, base)
    assert got.dtype == torch.float32 and got.shape == (b, m, H, D)
    np.testing.assert_allclose(got.numpy(), want, **_tol(quantized))


def test_twin_clamps_at_capacity():
    """base + m past the capacity: every query's window stops at the
    capacity, as the reference's does."""
    rng = np.random.default_rng(1)
    b, m = 2, 6
    kp, vp, sc, tables = _pages(rng, b, False)
    base = np.array([CAP - 2, CAP], np.int32)
    q = rng.standard_normal((b, m, H, D)).astype(np.float32)
    js, _ = _states(kp, vp, sc, tables, base)
    want = np.asarray(J._paged_multi_query_ref(jnp.asarray(q), js,
                                               jnp.asarray(base)))
    got = _twin(q, kp, vp, sc, tables, base).numpy()
    np.testing.assert_allclose(got, want, **_tol(False))


def _assert_states_equal(js, ts, quantized):
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))
    np.testing.assert_array_equal(ts.k_pages.numpy()[1:],
                                  np.asarray(js.k_pages)[1:])
    np.testing.assert_array_equal(ts.v_pages.numpy()[1:],
                                  np.asarray(js.v_pages)[1:])
    if quantized:
        np.testing.assert_array_equal(
            ts.scale_pages.float().numpy()[1:],
            np.asarray(js.scale_pages.astype(jnp.float32))[1:])


@pytest.mark.parametrize("quantized", [False, True])
def test_state_verify_spec_form_matches(quantized):
    """Spec verify: active rows (base > 0) append m rows and advance by m;
    the idle row (base 0) writes to the trash page and stays at 0; the
    last row overshoots the capacity."""
    rng = np.random.default_rng(2)
    b, m = 4, 5
    kp, vp, sc, tables = _pages(rng, b, quantized)
    lengths = np.array([9, 0, 20, CAP - 2], np.int32)
    js, ts = _states(kp, vp, sc, tables, lengths)
    q = rng.standard_normal((b, m, H, D)).astype(np.float32)
    k = rng.standard_normal((b, m, HKV, D)).astype(np.float32)
    v = rng.standard_normal((b, m, HKV, D)).astype(np.float32)
    jo, js = J.paged_state_verify(js, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    to, ts = T.paged_state_verify(ts, torch.from_numpy(q),
                                  torch.from_numpy(k), torch.from_numpy(v))
    _assert_states_equal(js, ts, quantized)
    np.testing.assert_array_equal(ts.lengths.numpy(), [14, 0, 25, CAP])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **_tol(quantized))


@pytest.mark.parametrize("quantized", [False, True])
def test_state_verify_mixed_hit_miss_wave(quantized):
    """Partial prefill with per-row widths in ONE wave: a cache-hit row
    (base 16, width 4), a miss row (base 0, full width 6), a full-hit row
    (base 24, width 1) and a pad row (width 0). The scenario of the
    reference's own ``test_state_verify_mixed_hit_miss_wave``, held
    against its jnp path."""
    rng = np.random.default_rng(3)
    b, m = 4, 6
    kp, vp, sc, tables = _pages(rng, b, quantized)
    lengths = np.array([16, 0, 24, 0], np.int32)
    widths = np.array([4, 6, 1, 0], np.int32)
    js, ts = _states(kp, vp, sc, tables, lengths, widths)
    q = rng.standard_normal((b, m, H, D)).astype(np.float32)
    k = rng.standard_normal((b, m, HKV, D)).astype(np.float32)
    v = rng.standard_normal((b, m, HKV, D)).astype(np.float32)
    jo, js = J.paged_state_verify(js, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    to, ts = T.paged_state_verify(ts, torch.from_numpy(q),
                                  torch.from_numpy(k), torch.from_numpy(v))
    _assert_states_equal(js, ts, quantized)
    np.testing.assert_array_equal(ts.lengths.numpy(), [20, 6, 25, 0])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **_tol(quantized))


def test_verify_rejects_bad_operands():
    rng = np.random.default_rng(5)
    kp, vp, _, tables = _pages(rng, 2, False)
    q = torch.zeros((2, 3, H, D))
    base = torch.zeros((2,), dtype=torch.int32)
    kpt, vpt, bt = (torch.from_numpy(a) for a in (kp, vp, tables))
    with pytest.raises(TypeError):  # int8 pages without scales
        T.paged_verify_slab_attention(q, kpt.to(torch.int8),
                                      vpt.to(torch.int8), bt, base)
    with pytest.raises(ValueError):  # lanes that split a head
        T.paged_verify_slab_attention(q, kpt[..., :-1], vpt[..., :-1], bt,
                                      base)
    with pytest.raises(ValueError):  # base_len of the wrong batch
        T.paged_verify_slab_attention(q, kpt, vpt, bt, base[:1])
    with pytest.raises(ValueError):  # q without its position axis
        T.paged_verify_slab_attention(q[:, 0], kpt, vpt, bt, base)
