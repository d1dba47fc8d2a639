"""The position-masked flash attention of the port
(``flash_attention_with_lse`` with ``q_positions`` / ``kv_positions``, whose
CPU path is the plain twins of kernels #2 and #6) against paddle_tpu's,
whose Pallas kernels run in interpret mode: ``out``, ``lse`` and
``jax.grad`` against ``torch.autograd`` with an lse cotangent.

Cases: the chunk pairs of a four-rank zig-zag ring over S=64 (each rank
holds chunks r and 7-r of eight), where whole rows of a pair can be masked;
a chunk that sees no key at all (lse -1e30, out 0); Sq != Sk; lengths that
are no multiple of 8 (the reference pads them with sentinel positions).
f32 atol 2e-5 (the twin forms P from the lse where the kernels tile, so
sums run in another order); bf16 atol 2e-2 on values of order 1 (P and dS
rounded to bf16 in both, summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fleet.meta_parallel.context_parallel import (
    zigzag_indices)
from paddle_tpu.ops.pallas import flash_attention as jfa

from paddle_tpu_torch.ops.cuda import flash_attention as fa

B, H, D = 1, 2, 64
ZIGZAG = zigzag_indices(64, 4).reshape(4, 16)  # rank r's 16 positions
ATOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, sq, sk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, sk, H, D)).astype(np.float32)
    ct = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    ctl = rng.standard_normal((B, H, sq)).astype(np.float32)
    return q, k, v, ct, ctl


def _jax(q, k, v, ct, ctl, qp, kp, dtype):
    def f(a, b, c):
        out, lse = jfa.flash_attention_with_lse(
            a, b, c, q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp))
        loss = jnp.sum(out.astype(jnp.float32) * ct) + jnp.sum(lse * ctl)
        return loss, (out, lse)

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    (_, (out, lse)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(*args)
    return (np.asarray(out.astype(jnp.float32)), np.asarray(lse),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(q, k, v, ct, ctl, qp, kp, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(
        *ts, q_positions=torch.from_numpy(np.asarray(qp)),
        kv_positions=torch.from_numpy(np.asarray(kp)))
    loss = ((out.float() * torch.from_numpy(ct)).sum()
            + (lse * torch.from_numpy(ctl)).sum())
    loss.backward()
    return (out.detach().float().numpy(), lse.detach().numpy(),
            [t.grad.float().numpy() for t in ts])


def _compare(qp, kp, dt, seed):
    q, k, v, ct, ctl = _inputs(seed, len(qp), len(kp))
    jdt, tdt = DTYPES[dt]
    want = _jax(q, k, v, ct, ctl, qp, kp, jdt)
    got = _port(q, k, v, ct, ctl, qp, kp, tdt)
    atol = ATOL[dt]
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0,
                               err_msg="out")
    np.testing.assert_allclose(got[1], want[1], atol=atol, rtol=0,
                               err_msg="lse")
    for name, g, w in zip("qkv", got[2], want[2]):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"d{name}")
    return got


@pytest.mark.parametrize("dt,r,s", [("f32", 0, 0), ("f32", 0, 3),
                                    ("f32", 3, 0), ("f32", 1, 2),
                                    ("f32", 2, 1), ("bf16", 0, 3),
                                    ("bf16", 2, 1)])
def test_zigzag_chunk_pairs_match_reference(dt, r, s):
    """Query chunk of rank r against the kv chunk of rank s, as the ring
    meets them; (0, 3) holds rows that see no key of the chunk."""
    got = _compare(ZIGZAG[r], ZIGZAG[s], dt, seed=10 * r + s)
    dead = ZIGZAG[r][:, None] < ZIGZAG[s][None, :]
    dead_rows = dead.all(axis=1)
    assert (got[1][:, :, dead_rows] == fa.NO_KEY_LSE).all()
    assert not got[0][:, dead_rows].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fully_masked_chunk(dt):
    """Every query precedes every key (Sq=10, Sk=25): lse is -1e30 and out
    0 on every row, and no gradient flows."""
    got = _compare(np.arange(10), np.arange(20, 45), dt, seed=3)
    assert (got[1] == fa.NO_KEY_LSE).all()
    assert not got[0].any()
    assert not any(g.any() for g in got[2])


def test_unequal_lengths_not_multiple_of_8():
    """Sq=37 against Sk=29, positions offset so that rows see different
    prefixes; both lengths need the reference's sentinel padding."""
    _compare(np.arange(37) + 5, np.arange(29), "f32", seed=4)


def test_arange_positions_equal_causal():
    """Positions 0..S-1 on both sides give top-left causal attention."""
    q, k, v, _, _ = _inputs(5, 24, 24)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.arange(24)
    got = fa.flash_attention_with_lse(tq, tk, tv, q_positions=pos,
                                      kv_positions=pos)
    want = fa.flash_attention_with_lse(tq, tk, tv, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_positions_go_together_and_are_checked():
    q, k, v, _, _ = _inputs(6, 8, 8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.arange(8)
    with pytest.raises(ValueError, match="without"):
        fa.flash_attention_with_lse(tq, tk, tv, kv_positions=pos)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_with_lse(tq, tk, tv, q_positions=pos,
                                    kv_positions=torch.arange(7))
    with pytest.raises(TypeError, match="integer"):
        fa.flash_attention_fwd(tq, tk, tv, q_positions=pos.float(),
                               kv_positions=pos)
