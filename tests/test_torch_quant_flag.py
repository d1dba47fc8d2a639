"""``FLAGS_weight_only_quant_backend`` in the port against paddle_tpu's
(``paddle_tpu/nn/quant.py`` ``quant_backend``), on the CPU.

* The route each flag value picks, at unknown, decode and prefill row
  counts: the reference's ``"pallas"`` is the port's ``"cuda"`` (kernel
  #12's wrapper), its ``"xla"`` the port's ``"xla"``; ``"auto"`` takes
  the plain path for CPU tensors in both; an unknown value raises
  ``ValueError`` in both. The port also takes ``"cuda"`` by name.
* ``weight_only_linear`` under every value gives the reference's output
  (its ``"xla"`` route: JAX 0.9's Pallas lacks ``TPUCompilerParams``, so
  the reference's ``"pallas"`` route does not run here) within 1e-5, f32:
  on a CPU tensor the kernel's wrapper takes its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nn import quant as jquant

from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.nn import quant
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

NAME = "FLAGS_weight_only_quant_backend"
PORT_NAME = {"pallas": "cuda", "xla": "xla"}


@pytest.fixture
def restore_flags():
    old_j = jflags.get_flags(NAME)[NAME]
    old_t = flags.get_flags(NAME)[NAME]
    yield
    jflags.set_flags({NAME: old_j})
    flags.set_flags({NAME: old_t})


def test_default_is_auto():
    assert flags.get_flags(NAME)[NAME] == jflags.get_flags(NAME)[NAME] \
        == "auto"


@pytest.mark.parametrize("rows", [None, 8, 300])
@pytest.mark.parametrize("value", ["auto", "pallas", "xla"])
def test_route_matches_reference(restore_flags, value, rows):
    jflags.set_flags({NAME: value})
    flags.set_flags({NAME: value})
    want = jquant.quant_backend(rows)
    assert quant.quant_backend(rows, device="cpu") == PORT_NAME[want]


def test_cuda_names_the_kernel_and_unknown_values_raise(restore_flags):
    flags.set_flags({NAME: "cuda"})
    assert quant.quant_backend(300, device="cpu") == "cuda"
    for value in ("triton", ""):
        jflags.set_flags({NAME: value})
        flags.set_flags({NAME: value})
        with pytest.raises(ValueError):
            jquant.quant_backend(8)
        with pytest.raises(ValueError):
            quant.quant_backend(8, device="cpu")


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("value", ["auto", "cuda", "pallas", "xla"])
def test_weight_only_linear_under_each_value(restore_flags, value, algo):
    r = np.random.default_rng(0)
    x = r.standard_normal((5, 64)).astype(np.float32)
    w = r.standard_normal((64, 48)).astype(np.float32)
    b = r.standard_normal(48).astype(np.float32)
    jw, js = jquant.weight_quantize(Tensor(jnp.asarray(w)), algo=algo)
    dtype = algo.rsplit("_", 1)[-1]
    jflags.set_flags({NAME: "xla"})
    want = np.asarray(jquant.weight_only_linear(
        Tensor(jnp.asarray(x)), jw, bias=Tensor(jnp.asarray(b)),
        weight_scale=js, weight_dtype=dtype)._data)
    flags.set_flags({NAME: value})
    tw, ts = quant.weight_quantize(torch.from_numpy(w), algo=algo)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw._data))
    got = quant.weight_only_linear(torch.from_numpy(x), tw,
                                   bias=torch.from_numpy(b),
                                   weight_scale=ts, weight_dtype=dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
