"""The port's speculative-decoding parts against paddle_tpu's on the same
inputs: ``accept_tokens`` (tokens, emitted counts and new keys bit-exact,
greedy and sampled, with and without top-k), the n-gram drafter's
proposals, and the adaptive draft controller's draft lengths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.spec.acceptance import \
    accept_tokens as jax_accept
from paddle_tpu.inference.spec.controller import \
    AdaptiveDraftController as JaxController
from paddle_tpu.inference.spec.drafter import NgramDrafter as JaxNgram

from paddle_tpu_torch.inference.spec import (AdaptiveDraftController,
                                             NgramDrafter, accept_tokens)


def _block(seed, b=6, k=4, v=40):
    r = np.random.default_rng(seed)
    logits = (r.standard_normal((b, k + 1, v)) * 2).astype(np.float32)
    greedy = logits.argmax(-1)
    # drafts that partly follow the argmax chain, so prefixes get accepted
    drafts = np.where(r.random((b, k)) < 0.7, greedy[:, :k],
                      r.integers(0, v, (b, k))).astype(np.int32)
    dlen = np.array([k, 0, 2, k, 1, 3][:b], np.int32)
    temps = np.array([0.0, 0.7, 1.0, 0.9, 0.0, 1.3][:b], np.float32)
    keys = r.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    return logits, drafts, dlen, temps, keys


@pytest.mark.parametrize("sampling,top_k", [(False, None), (True, None),
                                            (True, 7)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_tokens_bit_exact(sampling, top_k, seed):
    logits, drafts, dlen, temps, keys = _block(seed)
    if not sampling:
        temps = np.zeros_like(temps)
    jt, jn, jk = jax_accept(jnp.asarray(logits), jnp.asarray(drafts),
                            jnp.asarray(dlen), jnp.asarray(temps),
                            jnp.asarray(keys), top_k=top_k,
                            sampling=sampling)
    tt, tn, tk = accept_tokens(
        torch.from_numpy(logits), torch.from_numpy(drafts).long(),
        torch.from_numpy(dlen), torch.from_numpy(temps),
        torch.from_numpy(keys.astype(np.int64)), top_k=top_k,
        sampling=sampling)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                  np.asarray(jk))
    # greedy rows keep their keys; sampled rows burn k + 2 subkeys
    greedy_rows = temps == 0
    np.testing.assert_array_equal(tk.numpy()[greedy_rows],
                                  keys[greedy_rows].astype(np.int64))


def test_ngram_drafter_matches_jax():
    class R:
        def __init__(self, prompt, tokens):
            self.prompt = np.asarray(prompt, np.int32)
            self.tokens = list(tokens)

    r = np.random.default_rng(3)
    unit = r.integers(0, 50, (5,))
    reqs = [R(np.tile(unit, 4), [int(unit[0]), int(unit[1])]),
            R(r.integers(0, 50, (30,)), []),
            R([1, 2, 3, 1, 2], [3]),
            R([9], [])]
    want = [4, 3, 2, 4]
    jd, jl = JaxNgram().propose(None, [0, 1, 2, 3], reqs, want, 4)
    td, tl = NgramDrafter().propose(None, [0, 1, 2, 3], reqs, want, 4)
    np.testing.assert_array_equal(td, np.asarray(jd))
    np.testing.assert_array_equal(tl, np.asarray(jl))
    assert tl[0] == 4 and tl[3] == 0


def test_controller_matches_jax():
    class R:
        def __init__(self, rid, budget, done):
            self.rid, self.max_new_tokens = rid, budget
            self.tokens = [0] * done

    jc, tc = JaxController(4), AdaptiveDraftController(4)
    req = R(0, 40, 3)
    for proposed, accepted in [(4, 0), (2, 2), (1, 0), (3, 1), (4, 4)]:
        assert tc.draft_len(req) == jc.draft_len(req)
        jc.update(req, proposed, accepted)
        tc.update(req, proposed, accepted)
        assert tc.rate(req) == pytest.approx(jc.rate(req), abs=0)
    assert tc.draft_len(R(1, 5, 4)) == jc.draft_len(R(1, 5, 4)) == 0
    tc.forget(req)
    assert tc.rate(req) == 1.0
