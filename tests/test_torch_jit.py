"""The port's ``jit`` (``functional_call``, the state dicts, the swaps,
``to_static``, ``save`` / ``load``) against paddle_tpu's, and config 5's
example twin, on the CPU.

* ``functional_call`` equals the forward with the given tensors bound and
  the reference's ``functional_call`` on the same weights (2e-5: the
  port's flash twin against the reference's naive attention); unknown
  names raise ``KeyError``; ``return_buffers`` returns a training
  BatchNorm's updated statistics.
* ``to_static`` (``torch.compile(fullgraph=True)``) equals eager within
  1e-5 and compiles again for a second signature; a graph break raises.
  The compiled forward calls the flash forward's registered operator,
  the eager one its wrapper.
* ``save`` -> ``load`` with a ``None`` batch dim runs two batch sizes
  equal to eager (1e-5), the program holding the flash operator's node; the ``.pdiparams`` pickle holds the keys,
  shapes and values the reference's ``jit.save`` writes for the same
  weights (exactly); bf16 state round-trips bitwise.

Compiles are few and tiny (a 2-layer, 32-wide encoder): they cost seconds
each on the CPU.
"""
import importlib.util
import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.framework.tensor import Tensor

import paddle_tpu_torch.nn as nn
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.nn.functional import attention as fattn
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
D, H, V = 32, 4, 50


class JaxTiny(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(V, D)
        self.encoder = jnn.TransformerEncoder(
            jnn.TransformerEncoderLayer(D, H, 2 * D, dropout=0.0), 2)
        self.head = jnn.Linear(D, V)

    def forward(self, ids):
        return self.head(self.encoder(self.emb(ids)))


class Tiny(torch.nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        kw = dict(device="cpu", dtype=dtype)
        self.emb = nn.Embedding(V, D, **kw)
        self.encoder = nn.TransformerEncoder(
            nn.TransformerEncoderLayer(D, H, 2 * D, dropout=0.0, **kw), 2)
        self.head = nn.Linear(D, V, **kw)

    def forward(self, ids):
        return self.head(self.encoder(self.emb(ids)))


@pytest.fixture(scope="module")
def models():
    jm = JaxTiny()
    r = np.random.default_rng(0)
    for _, p in jm.named_parameters():
        p.set_value(jnp.asarray(0.2 * r.standard_normal(tuple(p.shape)),
                                jnp.float32))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in jjit.param_arrays(jm).items()}
    tm = Tiny()
    tm.load_state_dict(state_dict_from_numpy(arrays, device="cpu"),
                       strict=True)
    return jm, tm.eval(), arrays


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(0, V, (b, s)).astype(
        np.int32)


def test_state_arrays_match_the_reference_names(models):
    jm, tm, arrays = models
    assert sorted(jit.param_arrays(tm)) == sorted(arrays)
    assert sorted(jit.state_arrays(tm)) == sorted(jjit.state_arrays(jm))
    bn = nn.BatchNorm1D(3, device="cpu")
    assert sorted(jit.buffer_arrays(bn)) == ["_mean", "_variance"]


def test_functional_call_matches_jax_and_leaves_the_layer(models):
    jm, tm, arrays = models
    r = np.random.default_rng(1)
    other = {k: (a + 0.1 * r.standard_normal(a.shape)).astype(np.float32)
             for k, a in arrays.items()}
    ids = _ids(2, 2, 9)
    want = np.asarray(jjit.functional_call(
        jm, {k: jnp.asarray(v) for k, v in other.items()},
        Tensor(jnp.asarray(ids))))
    got = jit.functional_call(
        tm, {k: torch.from_numpy(v) for k, v in other.items()},
        torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    for k, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[k])
    with pytest.raises(KeyError):
        jit.functional_call(tm, {"nope.weight": torch.zeros(1)},
                            torch.from_numpy(ids))


def test_functional_call_returns_updated_buffers():
    bn = nn.BatchNorm1D(3, device="cpu").train()
    state = {k: v.clone() for k, v in jit.state_arrays(bn).items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 3)).astype(np.float32))
    _, bufs = jit.functional_call(bn, state, x, return_buffers=True)
    assert sorted(bufs) == ["_mean", "_variance"]
    assert not torch.equal(bufs["_mean"], torch.zeros(3))
    assert torch.equal(bn._mean, torch.zeros(3))  # the layer's own stays


def test_swapped_params_and_tensors(models):
    _, tm, _ = models
    ids = torch.from_numpy(_ids(4, 2, 5))
    base = tm(ids)
    zeros = [torch.zeros_like(p) for p in tm.parameters()]
    with jit.swapped_params(tm, zeros):
        assert not tm(ids).any()
    assert torch.equal(tm(ids), base)
    t = torch.ones(3)
    with jit.swapped_tensors([t], [torch.full((3,), 2.0)]):
        assert torch.equal(t, torch.full((3,), 2.0))
    assert torch.equal(t, torch.ones(3))


def test_arg_signature():
    sig = jit._arg_signature((torch.zeros((8, 128)), torch.zeros(
        8, dtype=torch.int32)), {}, (("mode", "x"),))
    assert sig == "float32[8,128]|int32[8]|static(('mode', 'x'),)"


def test_to_static_layer_equals_eager_and_recompiles(models, monkeypatch):
    """Also: the compiled program reaches the flash forward through its
    registered operator, and the eager forward does not."""
    _, tm, _ = models
    calls = []
    real = fattn.flash_attention_fwd_lse_op

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(fattn, "flash_attention_fwd_lse_op", spy)
    static = jit.to_static(tm)
    assert isinstance(static, jit.StaticFunction) and static._layer is tm
    with torch.no_grad():
        for b, s in ((2, 7), (3, 11)):
            ids = torch.from_numpy(_ids(b, b, s))
            want = tm(ids)
            assert not calls
            torch.testing.assert_close(static(ids), want, atol=1e-5,
                                       rtol=1e-5)
            assert calls
            calls.clear()
    assert static.signatures == ["int32[2,7]", "int32[3,11]"]


def test_to_static_function_and_graph_breaks():
    @jit.to_static
    def f(x, y):
        return torch.tanh(x) * y + 1.0

    x, y = torch.randn(4, 3), torch.randn(4, 3)
    torch.testing.assert_close(f(x, y), torch.tanh(x) * y + 1.0)
    assert f.__name__ == "f"

    def broken(x):
        torch._dynamo.graph_break()
        return x + 1

    with pytest.raises(Exception, match="graph_break|Graph break|graph "
                                        "break"):
        jit.to_static(broken)(x)
    assert torch.equal(jit.to_static(broken, full_graph=False)(x), x + 1)


def test_save_load_round_trip_with_a_dynamic_batch(models, tmp_path):
    _, tm, _ = models
    prefix = str(tmp_path / "tiny")
    jit.save(tm, prefix, input_spec=[jit.InputSpec([None, 6], "int32")])
    loaded = jit.load(prefix, device="cpu")
    assert loaded.num_inputs == 1
    targets = {str(n.target) for n in loaded._program.graph.nodes
               if n.op == "call_function"}
    assert "paddle_tpu_torch.flash_attention_fwd_lse.default" in targets
    for b in (1, 2, 5):
        ids = torch.from_numpy(_ids(b, b, 6))
        with torch.no_grad():
            want = tm(ids)
        torch.testing.assert_close(loaded(ids), want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(loaded(ids.numpy()).numpy(),
                                   want.numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        jit.save(tm, prefix)


def test_pdiparams_match_the_reference(models, tmp_path):
    jm, tm, _ = models
    jjit.save(jm, str(tmp_path / "ref"),
              input_spec=[jjit.InputSpec([2, 6], "int32")])
    jit.save(tm, str(tmp_path / "port"),
             input_spec=[jit.InputSpec([2, 6], "int32")])
    with open(tmp_path / "ref.pdiparams", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.pdiparams", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bf16_state_round_trips(tmp_path):
    m = Tiny(torch.bfloat16)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.2)
    m.eval()
    prefix = str(tmp_path / "bf16")
    jit.save(m, prefix, input_spec=[jit.InputSpec([2, 4], "int32")])
    loaded = jit.load(prefix, device="cpu")
    for k, v in jit.state_arrays(m).items():
        assert loaded._state[k].dtype == torch.bfloat16
        assert torch.equal(loaded._state[k], v)
    ids = torch.from_numpy(_ids(5, 2, 4))
    with torch.no_grad():
        assert torch.equal(loaded(ids), m(ids))


def test_the_config5_example_runs_on_the_cpu(capsys, monkeypatch):
    """``examples/to_static_export_torch.py --device cpu``: its three
    checks pass."""
    spec = importlib.util.spec_from_file_location(
        "to_static_export_torch",
        REPO / "examples" / "to_static_export_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    monkeypatch.setattr("sys.argv", ["to_static_export_torch.py",
                                     "--device", "cpu"])
    ex.main()
    out = capsys.readouterr().out
    for check in ("to_static == eager ok", "jit.save/load round-trip ok",
                  "inference.Predictor ok"):
        assert check in out
