"""Layer-level parity of the PyTorch port against paddle_tpu: RMSNorm,
LayerNorm, neox RoPE at ragged per-slot positions, Linear (with and
without bias) and Embedding, GELU, cross entropy and dropout's semantics,
plus the port's device resolution and flags. Inputs come from a numpy
seed and go to both packages; comparisons in f32 at atol 1e-5 (different
f32 sin/cos/rsqrt/erf implementations, a few ulps apart)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import (
    fused_rotary_position_embedding as jax_rope)
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import resolve_device, resolve_dtype
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.incubate.nn.functional import (
    fused_rotary_position_embedding as torch_rope)
from paddle_tpu_torch.nn import functional as TF
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _np(t):
    return np.asarray(getattr(t, "_data", t))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 16)])
def test_rms_norm_matches(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = _np(JF.rms_norm(jnp.asarray(x), jnp.asarray(w), epsilon=1e-6))
    got = TF.rms_norm(_t(x), _t(w), epsilon=1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rms_norm_layer_keeps_dtype(rng):
    layer = tnn.RMSNorm(8, device="cpu", dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    assert layer(x.bfloat16()).dtype == torch.bfloat16
    assert torch.all(layer.weight == 1)


@pytest.mark.parametrize("with_v", [False, True])
def test_rope_at_ragged_positions(with_v, rng):
    b, s, h, d = 3, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32) \
        if with_v else None
    # per-slot positions, as a ragged serving batch rotates them
    pos = (np.array([0, 7, 93])[:, None] + np.arange(s)[None]).astype(
        np.int32)
    jq, jk, jv = jax_rope(jnp.asarray(q), jnp.asarray(k),
                          None if v is None else jnp.asarray(v),
                          position_ids=jnp.asarray(pos))
    tq, tk, tv = torch_rope(_t(q), _t(k), None if v is None else _t(v),
                            position_ids=_t(pos))
    np.testing.assert_allclose(tq.numpy(), _np(jq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL, rtol=0)
    if with_v:
        np.testing.assert_allclose(tv.numpy(), _np(jv), atol=ATOL, rtol=0)
    else:
        assert tv is None and jv is None


def test_rope_default_positions_match(rng):
    q = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    jq, _, _ = jax_rope(jnp.asarray(q), rotary_emb_base=500.0)
    tq, _, _ = torch_rope(_t(q), rotary_emb_base=500.0)
    np.testing.assert_allclose(tq.numpy(), _np(jq), atol=ATOL, rtol=0)


def test_rope_position_zero_is_identity(rng):
    q = rng.standard_normal((1, 1, 2, 8)).astype(np.float32)
    tq, _, _ = torch_rope(_t(q), position_ids=torch.zeros((1, 1)))
    np.testing.assert_allclose(tq.numpy(), q, atol=0, rtol=0)


def test_linear_matches_paddle_layout(rng):
    paddle.seed(3)
    jl = paddle.nn.Linear(12, 7, bias_attr=False)
    x = rng.standard_normal((4, 12)).astype(np.float32)
    want = _np(jl(paddle.to_tensor(x)))
    tl = tnn.Linear(12, 7, bias_attr=False, device="cpu")
    assert tuple(tl.weight.shape) == (12, 7)
    assert [n for n, _ in tl.named_parameters()] == ["weight"]
    with torch.no_grad():
        tl.weight.copy_(_t(_np(jl.weight)))
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(), want,
                               atol=ATOL, rtol=0)


def test_embedding_matches(rng):
    paddle.seed(5)
    je = paddle.nn.Embedding(20, 6)
    ids = rng.integers(0, 20, (3, 4))
    want = _np(je(paddle.to_tensor(ids)))
    te = tnn.Embedding(20, 6, device="cpu")
    with torch.no_grad():
        te.weight.copy_(_t(_np(je.weight)))
    np.testing.assert_allclose(te(_t(ids)).detach().numpy(), want,
                               atol=0, rtol=0)


def test_silu_matches(rng):
    x = rng.standard_normal((3, 10)).astype(np.float32)
    want = _np(JF.silu(jnp.asarray(x)))
    np.testing.assert_allclose(TF.silu(_t(x)).numpy(), want, atol=ATOL,
                               rtol=0)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        # no silent CPU run: asking for the card without one raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("name,want", [("bf16", torch.bfloat16),
                                       ("float32", torch.float32),
                                       ("fp32", torch.float32),
                                       (torch.int8, torch.int8)])
def test_resolve_dtype(name, want):
    assert resolve_dtype(name) is want


def test_resolve_dtype_rejects_unknown():
    with pytest.raises(ValueError):
        resolve_dtype("float7")


def test_linear_bias_matches(rng):
    """``Linear`` with its bias (the GPT layers' default): weight ``[in,
    out]`` and bias ``[out]``, zeros at construction as in the reference."""
    paddle.seed(4)
    jl = paddle.nn.Linear(12, 7)
    tl = tnn.Linear(12, 7, device="cpu")
    assert [n for n, _ in tl.named_parameters()] == ["weight", "bias"]
    assert torch.all(tl.bias == 0) and np.all(_np(jl.bias) == 0)
    b = rng.standard_normal(7).astype(np.float32)
    jl.bias.set_value(jnp.asarray(b))
    with torch.no_grad():
        tl.weight.copy_(_t(_np(jl.weight)))
        tl.bias.copy_(_t(b))
    x = rng.standard_normal((2, 3, 12)).astype(np.float32)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(),
                               _np(jl(paddle.to_tensor(x))), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches(affine, rng):
    x = (rng.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32) if affine else None
    b = rng.standard_normal(32).astype(np.float32) if affine else None
    want = _np(JF.layer_norm(jnp.asarray(x), 32,
                             None if w is None else jnp.asarray(w),
                             None if b is None else jnp.asarray(b),
                             epsilon=1e-5))
    got = TF.layer_norm(_t(x), 32, None if w is None else _t(w),
                        None if b is None else _t(b), epsilon=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    layer = tnn.LayerNorm(32, device="cpu", dtype=torch.bfloat16)
    assert layer(_t(x).bfloat16()).dtype == torch.bfloat16
    assert torch.all(layer.weight == 1) and torch.all(layer.bias == 0)
    assert tnn.LayerNorm(32, weight_attr=False, bias_attr=False,
                         device="cpu").weight is None


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches(approximate, rng):
    x = (rng.standard_normal((3, 40)) * 3).astype(np.float32)
    want = _np(JF.gelu(jnp.asarray(x), approximate=approximate))
    np.testing.assert_allclose(TF.gelu(_t(x), approximate=approximate)
                               .numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches(reduction, weighted, rng):
    """Hard labels with ``ignore_index`` entries (loss 0, and left out of
    the mean's denominator), optional class weights, labels with a
    trailing 1 axis."""
    logits = (rng.standard_normal((10, 17)) * 4).astype(np.float32)
    labels = rng.integers(0, 17, (10,))
    labels[[2, 7]] = -100
    w = rng.random(17).astype(np.float32) if weighted else None
    want = _np(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                weight=None if w is None else jnp.asarray(w),
                                reduction=reduction))
    got = TF.cross_entropy(_t(logits), _t(labels),
                           weight=None if w is None else _t(w),
                           reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-6)
    got2 = TF.cross_entropy(_t(logits), _t(labels[:, None]),
                            weight=None if w is None else _t(w),
                            reduction=reduction)
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=0, rtol=0)


def test_dropout_semantics(rng):
    """The reference's modes: ``upscale_in_train`` scales the kept values
    by 1/(1-p) in training and is the identity in inference;
    ``downscale_in_infer`` keeps values in training and scales by (1-p) in
    inference; ``axis`` drops whole slices. The mask comes from the given
    generator (JAX's bits differ, so the masks are not compared)."""
    x = _t(rng.standard_normal((64, 32)).astype(np.float32) + 5.0)
    gen = torch.Generator().manual_seed(3)
    out = TF.dropout(x, p=0.25, generator=gen)
    kept = out != 0
    assert 0.6 < kept.float().mean().item() < 0.9
    torch.testing.assert_close(out[kept], x[kept] / 0.75)
    again = TF.dropout(x, p=0.25, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(again, out, atol=0, rtol=0)
    assert TF.dropout(x, p=0.25, training=False) is x
    down = TF.dropout(x, p=0.25, mode="downscale_in_infer",
                      generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(down[down != 0], x[down != 0])
    torch.testing.assert_close(
        TF.dropout(x, p=0.25, training=False, mode="downscale_in_infer"),
        x * 0.75)
    rows = TF.dropout(x, p=0.5, axis=0,
                      generator=torch.Generator().manual_seed(5))
    zero_rows = (rows == 0).all(dim=1)
    assert torch.equal(zero_rows, (rows == 0).any(dim=1))
    assert 0 < int(zero_rows.sum()) < 64
    layer = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(1))
    layer.eval()
    assert layer(x) is x


def test_flags_registry():
    from paddle_tpu_torch.framework import flags as tflags

    # the reference's defaults (its packed route's None means "TPU only";
    # the port's, "CUDA activations")
    assert tflags.get_flags(["FLAGS_use_flash_attention",
                             "FLAGS_use_packed_attention"]) == {
        "FLAGS_use_flash_attention": True,
        "FLAGS_use_packed_attention": None}
    saved = tflags.get_flags("use_packed_attention")
    try:
        tflags.set_flags({"use_packed_attention": False})
        assert tflags.get_flags(["FLAGS_use_packed_attention"]) == {
            "FLAGS_use_packed_attention": False}
    finally:
        tflags.set_flags(saved)
    assert tflags.get_flags("FLAGS_use_packed_attention")[
        "FLAGS_use_packed_attention"] is None
