"""The port's BERT (``models/bert.py``, ``convert.bert_from_numpy`` /
``init_bert``) and config 2's functional training step
(``examples/train_bert_torch.py`` ``mlm_step``: ``jit.functional_call`` +
autograd + ``AdamW.apply_gradients_tree``) against paddle_tpu's on the
same numpy weights and batch, f32, tiny widths.

The JAX model runs as the JAX package's tests run it on the CPU (naive
attention; the port runs the flash twins #2 and #5/#6). Its step is the
reference example's: ``jax.value_and_grad`` of ``functional_call`` +
``BertPretrainingCriterion``, then ``apply_gradients_tree``.

Tolerances: logits 2e-5 absolute and relative; the loss 1e-6 relative;
gradients and the stepped parameters 1e-5 absolute (sums over the batch
in another order; Adam's first step moves each weight by about the
learning rate whatever the gradient's size, so a 1e-4 step is held to
1e-5 of it); AdamW's moments 1e-6 absolute (the gradients' 1e-5 times
1 - beta1).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import functional_call as jfunctional_call
from paddle_tpu.jit import param_arrays as jparam_arrays
from paddle_tpu.models.bert import BertConfig as JConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBert
from paddle_tpu.models.bert import BertPretrainingCriterion as JCrit

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import bert_from_numpy, init_bert
from paddle_tpu_torch.jit import param_arrays
from paddle_tpu_torch.models.bert import (BertConfig,
                                          BertPretrainingCriterion)
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
B, S = 3, 16


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_bert_torch", REPO / "examples" / "train_bert_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    """A JAX tiny BERT with every parameter random, and the port's built
    from its ``param_arrays``."""
    jm = JBert(JConfig(**TINY))
    r = np.random.default_rng(0)
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if len(shape) > 1:
            v = 0.2 * r.standard_normal(shape)
        else:
            base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            v = base + 0.1 * r.standard_normal(shape)
        p.set_value(jnp.asarray(v, jnp.float32))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in jparam_arrays(jm).items()}
    tm = bert_from_numpy(BertConfig(**TINY), arrays, device="cpu").eval()
    return jm, tm, arrays


def _batch(seed=1):
    r = np.random.default_rng(seed)
    ids = r.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    labels = np.full((B, S), -100, np.int32)
    labels[:, :S // 8] = ids[:, :S // 8]
    return ids, labels


def test_state_dict_names_match_and_the_decoder_is_tied(models):
    jm, tm, arrays = models
    assert sorted(tm.state_dict()) == sorted(arrays)
    assert not any("decoder_weight" in k for k in tm.state_dict())
    emb = tm.bert.embeddings.word_embeddings.weight
    assert tm.cls._embedding.weight is emb


@pytest.mark.parametrize("extra", ["none", "mask", "token_types"])
def test_logits_match_jax(models, extra):
    jm, tm, _ = models
    ids, _ = _batch()
    jkw, tkw = {}, {}
    if extra == "mask":
        m = np.ones((B, S), np.int32)
        m[1, 10:] = 0
        jkw["attention_mask"] = Tensor(jnp.asarray(m))
        tkw["attention_mask"] = torch.from_numpy(m)
    if extra == "token_types":
        tt = np.zeros((B, S), np.int32)
        tt[:, S // 2:] = 1
        jkw["token_type_ids"] = Tensor(jnp.asarray(tt))
        tkw["token_type_ids"] = torch.from_numpy(tt)
    want = np.asarray(jm(Tensor(jnp.asarray(ids)), **jkw)._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("all_ignored", [False, True])
def test_criterion_matches_jax(all_ignored):
    r = np.random.default_rng(2)
    logits = r.standard_normal((B, S, 11)).astype(np.float32)
    labels = r.integers(0, 11, (B, S)).astype(np.int32)
    labels[:, 3:] = -100
    if all_ignored:
        labels[:] = -100
    want = float(np.asarray(JCrit(11)(Tensor(jnp.asarray(logits)),
                                      Tensor(jnp.asarray(labels)))._data))
    got = float(BertPretrainingCriterion(11)(torch.from_numpy(logits),
                                             torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_functional_step_matches_jax(models):
    """Two steps of the twin's ``mlm_step`` against the reference
    example's step: losses, gradients (through the flash backward twin),
    the new parameters and AdamW's state."""
    jm, tm, arrays = models
    ex = _example()
    jm.train()
    tm.train()
    jcrit, tcrit = JCrit(TINY["vocab_size"]), BertPretrainingCriterion(
        TINY["vocab_size"])
    jo = jopt.AdamW(learning_rate=1e-4)
    to = topt.AdamW(learning_rate=1e-4)
    jp = jparam_arrays(jm)
    tp = param_arrays(tm)
    js, ts = jo.init_state_tree(jp), to.init_state_tree(tp)
    ids, labels = _batch(3)
    for step in (1, 2):
        def loss_fn(p):
            logits = jfunctional_call(jm, p, Tensor(jnp.asarray(ids)))
            return jcrit(Tensor._wrap(logits),
                         Tensor(jnp.asarray(labels)))._data

        jloss, jgrads = jax.value_and_grad(loss_fn)(jp)
        # the port's gradients, as mlm_step forms them
        leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
        from paddle_tpu_torch.jit import functional_call

        tloss = tcrit(functional_call(tm, leaves, torch.from_numpy(ids)),
                      torch.from_numpy(labels))
        tgrads = torch.autograd.grad(tloss, list(leaves.values()),
                                     allow_unused=True)
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   rtol=1e-6)
        for (name, g) in zip(leaves, tgrads):
            want = np.asarray(jgrads[name])
            got = np.zeros_like(want) if g is None else g.numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=name)
        jp, js = jo.apply_gradients_tree(jp, jgrads, js, 1e-4,
                                         jnp.float32(step))
        tp, ts, loss = ex.mlm_step(tm, tcrit, to, tp, ts,
                                   torch.from_numpy(ids),
                                   torch.from_numpy(labels), step)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        for name in jp:
            # a key bias shifts every logit of a row alike, so its gradient
            # is zero up to rounding and Adam steps it by +-lr on the
            # rounding's sign: only that bound is held
            tol = 2e-4 * step if name.endswith("k_proj.bias") else 1e-5
            np.testing.assert_allclose(tp[name].numpy(),
                                       np.asarray(jp[name]), atol=tol,
                                       rtol=0, err_msg=name)
            for k in ("moment1", "moment2"):
                np.testing.assert_allclose(
                    ts[name][k].numpy(), np.asarray(js[name][k]),
                    rtol=0, atol=1e-6, err_msg=f"{name}.{k}")
    # the model's own weights are untouched by the functional steps
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[name])
    jm.eval()
    tm.eval()


def test_step_with_recompute_equals_plain(models):
    """``examples/train_bert_torch.py``'s ``use_recompute`` (every encoder
    layer under ``fleet.recompute``) leaves the step's loss, parameters and
    state as they are without it."""
    _, _, arrays = models
    ex = _example()
    ids, labels = (torch.from_numpy(a) for a in _batch(4))
    out = []
    for rc in (False, True):
        tm = bert_from_numpy(BertConfig(**TINY), arrays, device="cpu")
        if rc:
            ex.use_recompute(tm)
        crit = BertPretrainingCriterion(TINY["vocab_size"])
        opt = topt.AdamW(learning_rate=1e-4)
        p = param_arrays(tm)
        out.append(ex.mlm_step(tm, crit, opt, p, opt.init_state_tree(p),
                               ids, labels, 1))
    (p0, s0, l0), (p1, s1, l1) = out
    assert torch.equal(l0, l1)
    for name in p0:
        torch.testing.assert_close(p1[name], p0[name], atol=1e-7, rtol=0)
        torch.testing.assert_close(s1[name]["moment1"], s0[name]["moment1"],
                                   atol=1e-9, rtol=1e-6)


def test_example_runs_on_the_cpu(capsys, monkeypatch):
    """``examples/train_bert_torch.py --device cpu`` (tiny): five steps
    whose losses are finite."""
    ex = _example()
    monkeypatch.setattr("sys.argv", ["train_bert_torch.py", "--device",
                                     "cpu", "--steps", "3"])
    ex.main()
    lines = capsys.readouterr().out.splitlines()
    losses = [float(ln.split()[-1]) for ln in lines if ln.startswith("step")]
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_init_bert_is_seeded():
    cfg = BertConfig(**TINY)
    a, b = init_bert(cfg, 5, "cpu"), init_bert(cfg, 5, "cpu")
    c = init_bert(cfg, 6, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k])
        if k.endswith("norm.weight") or k.endswith("norm1.weight"):
            assert torch.equal(sa[k], torch.ones_like(sa[k]))
        if k.endswith("bias"):
            assert not sa[k].any()
    assert not torch.equal(sa["bert.embeddings.word_embeddings.weight"],
                           sc["bert.embeddings.word_embeddings.weight"])
