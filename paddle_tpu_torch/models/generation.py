"""Autoregressive generation over the KV cache for the causal-LM families,
after ``paddle_tpu/models/generation.py``.

Mixin contract: the model defines ``forward(input_ids, caches=None,
time_step=None)``, ``init_caches(batch, max_seq, dtype)`` and has a
``config`` with ``max_position``.

One prefill writes the prompt's K/V into slab caches and picks the first
token; then the decode steps run, each appending its K/V at the time step
and attending over the cache (kernel #15). The decode step is written to
be captured (``inference.runner.CapturedStep``): its token, time step,
key and output column live in static device buffers beside its caches,
and the step advances them itself, so on the card it is one CUDA graph
replayed once per token with no host work between (the reference's
compiled ``lax.scan``); on the CPU the same body runs eagerly. A step is
captured at the first use of its key (batch, cache window, dtypes and the
pick: greedy, or its temperature and top-k) and made anew when the
weights change. The model keeps ONE step, with its caches, after
``generate`` returns: a call with another key drops it before making its
own, so the memory held between calls is one key's slab caches
(``2 * layers * batch * window * kv_width`` elements of the compute
dtype; 17 GB at ``llama2_7b``, bf16, batch 8, window 4096) and the graph's
scratch. Calls on one model run one at a time (a lock), since they share
the step's buffers. There is no power-of-two bucketing of the step count
(the reference's bucketing only computes surplus tokens and slices them
off).

Sampling reproduces the reference's key chain bit for bit: ``key =
key(seed)``; ``key, sub = split(key)`` and ``sub`` picks the first token;
the decode loop then does ``rkey, sub = split(rkey)`` once per step from
``rkey = key``. One key draws the noise of the whole ``[B, V]`` logits
(``sampling.categorical_array``), unlike the engine's per-row keys. The
keys live and split on the model's device. Logits are sampled in f32.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from types import SimpleNamespace

import torch

from ..inference import sampling
from ..inference.runner import GraphSet

__all__ = ["GenerationMixin"]

# one lock a model: its generate calls share the captured step's buffers
_LOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LOCKS_LOCK = threading.Lock()


def _model_lock(model) -> threading.Lock:
    with _LOCKS_LOCK:
        lock = _LOCKS.get(model)
        if lock is None:
            lock = _LOCKS[model] = threading.Lock()
        return lock


def _pick_fn(temperature, top_k, dtype):
    """The reference's ``_pick_fn``: argmax when ``temperature == 0`` or
    ``top_k == 1``; else the logits over ``max(temperature, 1e-6)``, those
    below the k-th largest masked to -inf when ``top_k > 1`` (ties with the
    k-th are kept), and a categorical draw with one key for the batch."""
    greedy = temperature == 0.0 or top_k == 1

    def pick(logits_last, key):
        if greedy:
            return torch.argmax(logits_last, dim=-1).to(dtype)
        lg = logits_last.float() / max(temperature, 1e-6)
        if top_k > 1:
            kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
            lg = torch.where(lg < kth, torch.full_like(lg, float("-inf")),
                             lg)
        return sampling.categorical_array(key.to(lg.device), lg).to(dtype)

    return pick, greedy


class GenerationMixin:
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, seed=0, max_seq=None):
        """Autoregressive generation over the KV cache. Greedy when
        ``temperature == 0`` (or ``top_k == 1``); otherwise samples from
        the (optionally top-k-truncated) softmax. ``input_ids`` [B, prompt]
        (a tensor or an array; moved to the model's device). Returns
        ``[B, prompt + new]`` ids in the input's dtype. Runs in eval mode
        under ``torch.no_grad()`` and restores training mode after. Calls
        on one model from several threads run one at a time."""
        with _model_lock(self):
            was_training = self.training
            self.eval()
            try:
                with torch.no_grad():
                    return self._generate(input_ids, max_new_tokens,
                                          temperature, top_k, seed, max_seq)
            finally:
                if was_training:
                    self.train()

    def _decode_graphs(self) -> GraphSet:
        """This model's captured decode step (one kept), made anew (the old
        one dropped) when its weights change: ``quantize_for_decode`` swaps
        them in place of the module's."""
        weights = tuple(t.data_ptr() for t in itertools.chain(
            self.parameters(), self.buffers()))
        held = self.__dict__.get("_decode_graph_set")
        if held is None or held[0] != weights:
            self.__dict__.pop("_decode_graph_set", None)
            held = (weights, GraphSet(self.device, limit=1))
            self.__dict__["_decode_graph_set"] = held
        return held[1]

    def _decode_step(self, batch, total, cache_dtype, tok_dtype, pick,
                     greedy):
        """The capturable decode step: (body, static buffers). The body
        feeds ``tok`` at ``time_step = ts`` through the model over the
        static ``caches``, splits ``key`` on the device (sampling), picks
        the next token into ``tok`` and column ``idx`` of ``out``, and
        advances ``idx`` and ``ts``."""
        dev = self.device
        b = SimpleNamespace(
            caches=self.init_caches(batch, total, dtype=cache_dtype),
            tok=torch.zeros((batch,), dtype=tok_dtype, device=dev),
            ts=torch.zeros((1,), dtype=torch.int64, device=dev),
            key=torch.zeros((2,), dtype=torch.int64, device=dev),
            out=torch.zeros((batch, total), dtype=tok_dtype, device=dev),
            idx=torch.zeros((1,), dtype=torch.int64, device=dev))

        def generate_decode_step():
            logits, _ = self(b.tok[:, None], caches=b.caches,
                             time_step=b.ts)
            sub = None
            if not greedy:
                key, sub = sampling.split(b.key)
                b.key.copy_(key)
            nxt = pick(logits[:, -1], sub)
            b.tok.copy_(nxt)
            b.out.index_copy_(1, b.idx, nxt[:, None])
            b.idx.add_(1)
            b.ts.add_(1)

        return generate_decode_step, b

    def _generate(self, input_ids, max_new_tokens, temperature, top_k, seed,
                  max_seq):
        ids = torch.as_tensor(input_ids, device=self.device)
        b, prompt = ids.shape
        if max_new_tokens <= 0:
            return ids
        total = max_seq or min(self.config.max_position,
                               prompt + max_new_tokens)
        # the cache in the model's compute dtype: a bf16 model must not pay
        # f32 cache bandwidth in the decode loop
        pdtype = next(p.dtype for p in self.parameters())
        if not pdtype.is_floating_point:
            pdtype = torch.float32
        pick, greedy = _pick_fn(temperature, top_k, ids.dtype)
        how = (True,) if greedy else (False, float(temperature), int(top_k))
        # captured before the prefill: the warm-up's writes land in the
        # caches, which are zeroed next
        step = self._decode_graphs().get(
            (b, total, pdtype, ids.dtype) + how,
            lambda: self._decode_step(b, total, pdtype, ids.dtype, pick,
                                      greedy))
        s = step.bufs
        for c in s.caches:
            c.zero_()
        logits, _ = self(ids, caches=s.caches)
        key = torch.tensor(sampling.key_from_seed(seed), dtype=torch.int64,
                           device=ids.device)
        sub = None
        if not greedy:
            key, sub = sampling.split(key)
        nxt = pick(logits[:, -1], sub)
        # the token emitted after prefill sits at position `prompt`; step t
        # writes its K/V at cache row t and predicts token t + 1
        steps = min(max_new_tokens - 1, total - 1 - prompt)
        if steps <= 0:
            return torch.cat([ids, nxt[:, None]], dim=1)
        step.load(tok=nxt, key=key)
        s.ts.fill_(prompt)
        s.idx.zero_()
        step.run(steps)
        return torch.cat([ids, nxt[:, None], s.out[:, :steps]], dim=1)
