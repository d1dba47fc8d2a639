"""The port's threefry sampling against ``jax.random`` under its defaults
(threefry2x32, ``jax_threefry_partitionable=True``): ``split``,
``random_bits`` and ``uniform`` bit for bit; ``gumbel`` within an ulp or
two (the f32 logs of XLA and PyTorch round apart); and the engine's token
choice — tokens and new keys equal to ``Engine._select_token``, with and
without ``top_k`` — and the resume key replay."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import _advance_sample_key

from paddle_tpu_torch.inference import sampling as S
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 42, 12345, 2 ** 33 + 5, 2 ** 63 - 1]


def _key(seed):
    return np.array(S.key_from_seed(seed), np.uint32)


def _tk(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def test_jax_defaults_are_the_ported_ones():
    assert jax.config.jax_threefry_partitionable
    assert str(jax.config.jax_default_prng_impl) == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_key_layout_matches_prngkey(seed):
    # seeds below 2**32: without x64, jax.random.key keeps only the low
    # word, while both engines build the key host-side from the full seed
    np.testing.assert_array_equal(
        _key(seed), np.asarray(jax.random.key_data(jax.random.key(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split_bit_exact(seed, num):
    want = np.asarray(jax.random.split(jnp.asarray(_key(seed)), num))
    np.testing.assert_array_equal(S.split(_tk(_key(seed)), num).numpy(),
                                  want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (129,)])
def test_random_bits_bit_exact(seed, shape):
    want = np.asarray(jax.random.bits(jnp.asarray(_key(seed)), shape))
    np.testing.assert_array_equal(
        S.random_bits(_tk(_key(seed)), shape).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_bit_exact(seed):
    k = jnp.asarray(_key(seed))
    want = np.asarray(jax.random.uniform(k, (257,)))
    np.testing.assert_array_equal(S.uniform(_tk(_key(seed)), (257,)).numpy(),
                                  want)
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(jax.random.uniform(k, (64,), minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(
        S.uniform(_tk(_key(seed)), (64,), tiny, 1.0).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_gumbel_close(seed):
    want = np.asarray(jax.random.gumbel(jnp.asarray(_key(seed)), (300,)))
    got = S.gumbel(_tk(_key(seed)), (300,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_batched_split_is_per_row():
    keys = np.stack([_key(s) for s in SEEDS[:4]])
    want = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys)))
    np.testing.assert_array_equal(S.split(_tk(keys)).numpy(), want)


@pytest.mark.parametrize("top_k", [None, 5])
def test_select_token_matches_engine(top_k, rng):
    b, vocab = 6, 50
    logits = (rng.standard_normal((b, vocab)) * 2).astype(np.float32)
    greedy = logits.argmax(-1).astype(np.int32)
    temps = np.array([0.0, 0.8, 1.0, 0.0, 0.3, 2.0], np.float32)
    keys = np.stack([_key(s) for s in range(100, 100 + b)])
    for _ in range(4):  # a few chained draws, keys threaded through
        jt, jk = JaxEngine._select_token(
            SimpleNamespace(top_k=top_k), jnp.asarray(logits),
            jnp.asarray(greedy), jnp.asarray(temps), jnp.asarray(keys))
        tt, tk = S.select_token(torch.from_numpy(logits),
                                torch.from_numpy(greedy).long(),
                                torch.from_numpy(temps), _tk(keys), top_k)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        # greedy rows keep their key untouched
        np.testing.assert_array_equal(tk.numpy()[temps == 0],
                                      keys[temps == 0])
        keys = np.asarray(jk)
        logits = np.roll(logits, 3, axis=1)


@pytest.mark.parametrize("burns", [0, 1, 5])
def test_advance_sample_key_matches(burns):
    k = _key(77)
    want = np.asarray(_advance_sample_key(jnp.asarray(k), jnp.int32(burns)))
    np.testing.assert_array_equal(
        S.advance_sample_key(_tk(k), burns).numpy(), want)
