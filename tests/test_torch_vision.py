"""Config 1's layers and model in the port (``nn/functional/conv.py``,
``pooling.py``, ``norm.py``, ``nn/conv.py``, ``pooling.py``, ``norm.py``,
``vision/models/resnet.py``) against paddle_tpu's, on the same numpy
inputs and weights (weights carried across by ``convert.
resnet_from_numpy`` or as the layers' state dicts).

Tolerances (f32 on both sides): functions and layers within 1e-5 of the
largest output entry (and 1e-5 absolute on the running buffers), the
ResNets' logits within 1e-4 of the largest logit and their gradients
within 1e-3 of each tensor's largest entry (``GRAD_TOL``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.vision.models import resnet as jres

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import convert
from paddle_tpu_torch.vision.models import resnet as tres
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
# a training-mode backward through 20 batch norms, the last ones over 16
# values a channel (1x1 maps at batch 16): f32 rounding reaches ~1e-4 of
# a tensor's largest gradient
GRAD_TOL = 1e-3


def _rng(seed=0):
    return np.random.default_rng(seed)


def _j(a):
    return paddle.to_tensor(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _layer_sd(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _load(port_layer, ref_layer):
    port_layer.load_state_dict({k: _t(v) for k, v in
                                _layer_sd(ref_layer).items()}, strict=True)
    return port_layer


# --------------------------------------------------------------- conv
CONV2D = {
    "plain": dict(x=(2, 4, 9, 9), w=(6, 4, 3, 3)),
    "stride dilation": dict(x=(2, 4, 11, 10), w=(6, 4, 3, 3), stride=2,
                            padding=2, dilation=2),
    "groups bias": dict(x=(2, 4, 8, 8), w=(6, 2, 3, 3), groups=2, padding=1,
                        bias=True),
    "per-dim": dict(x=(1, 3, 8, 9), w=(4, 3, 3, 2), padding=[2, 0]),
    "SAME s2 even": dict(x=(2, 3, 8, 8), w=(4, 3, 3, 3), stride=2,
                         padding="SAME"),
    "SAME s2 odd": dict(x=(2, 3, 9, 7), w=(4, 3, 4, 3), stride=2,
                        padding="SAME"),
    "VALID s2 even": dict(x=(2, 3, 8, 8), w=(4, 3, 3, 3), stride=2,
                          padding="VALID"),
    "VALID s2 odd": dict(x=(2, 3, 9, 7), w=(4, 3, 3, 3), stride=2,
                         padding="valid"),
    "SAME dilated": dict(x=(1, 2, 9, 9), w=(3, 2, 3, 3), dilation=2,
                         padding="SAME"),
    "NHWC": dict(x=(2, 7, 7, 4), w=(5, 4, 3, 3), stride=2, padding=1,
                 data_format="NHWC", bias=True),
    "NHWC SAME": dict(x=(2, 7, 6, 4), w=(5, 4, 3, 3), stride=2,
                      padding="SAME", data_format="NHWC"),
}


@pytest.mark.parametrize("case", sorted(CONV2D))
def test_conv2d_matches_reference(case):
    kw = dict(CONV2D[case])
    r = _rng(1)
    x = r.standard_normal(kw.pop("x")).astype(np.float32)
    w = r.standard_normal(kw.pop("w")).astype(np.float32)
    b = r.standard_normal(w.shape[0]).astype(np.float32) \
        if kw.pop("bias", False) else None
    want = JF.conv2d(_j(x), _j(w), None if b is None else _j(b), **kw)
    got = TF.conv2d(_t(x), _t(w), None if b is None else _t(b), **kw)
    _close(got, want)


def test_same_padding_puts_the_odd_row_high():
    """lax's SAME at stride 2 on an even size pads (0, 1): a 1-hot input
    on the first row leaves no trace in the output's first row."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 0, :] = 1.0
    w = np.ones((1, 1, 2, 2), np.float32)
    got = TF.conv2d(_t(x), _t(w), stride=2, padding="SAME")
    _close(got, JF.conv2d(_j(x), _j(w), stride=2, padding="SAME"))
    assert got.shape == (1, 1, 2, 2)
    assert got[0, 0, 0].tolist() == [2.0, 2.0]


def test_conv1d_conv3d_and_transpose_match_reference():
    r = _rng(2)
    x1 = r.standard_normal((2, 4, 13)).astype(np.float32)
    w1 = r.standard_normal((6, 2, 3)).astype(np.float32)
    b1 = r.standard_normal(6).astype(np.float32)
    _close(TF.conv1d(_t(x1), _t(w1), _t(b1), stride=2, padding=1, groups=2),
           JF.conv1d(_j(x1), _j(w1), _j(b1), stride=2, padding=1, groups=2))
    _close(TF.conv1d(_t(x1), _t(w1), groups=2, padding="SAME", stride=3),
           JF.conv1d(_j(x1), _j(w1), groups=2, padding="SAME", stride=3))
    x3 = r.standard_normal((1, 2, 5, 6, 7)).astype(np.float32)
    w3 = r.standard_normal((3, 2, 3, 2, 3)).astype(np.float32)
    _close(TF.conv3d(_t(x3), _t(w3), stride=(1, 2, 2), padding=1),
           JF.conv3d(_j(x3), _j(w3), stride=(1, 2, 2), padding=1))
    xt = r.standard_normal((2, 4, 5, 6)).astype(np.float32)
    wt = r.standard_normal((4, 3, 3, 3)).astype(np.float32)
    bt = r.standard_normal(6).astype(np.float32)
    for kw in (dict(stride=2, padding=1, output_padding=1, groups=2),
               dict(stride=2, padding=1, output_size=(10, 12), groups=2),
               dict(stride=1, padding=0, dilation=2, groups=2)):
        _close(TF.conv2d_transpose(_t(xt), _t(wt), _t(bt), **kw),
               JF.conv2d_transpose(_j(xt), _j(wt), _j(bt), **kw))
    with pytest.raises(ValueError, match="output_padding"):
        TF.conv2d_transpose(_t(xt), _t(wt), stride=2, output_padding=2,
                            groups=2)


def test_conv_layers_layout_and_init():
    paddle.seed(0)
    ref = jnn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2)
    port = tnn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in _layer_sd(ref).items()}
    _load(port, ref)
    x = _rng(3).standard_normal((2, 4, 7, 7)).astype(np.float32)
    _close(port(_t(x)), ref(_j(x)))
    # KaimingNormal: std sqrt(2 / fan_in), fan_in = in/groups * kh * kw
    big = tnn.Conv2D(64, 128, 3, bias_attr=False,
                     generator=torch.Generator().manual_seed(0))
    assert big.bias is None
    assert abs(float(big.weight.detach().std()) - np.sqrt(2 / (64 * 9))) < 2e-3
    again = tnn.Conv2D(64, 128, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(big.weight, again.weight)
    for cls, kw in ((tnn.Conv1D, {}), (tnn.Conv3D, {})):
        layer = cls(4, 6, 3, **kw)
        assert tuple(layer.weight.shape[:2]) == (6, 4)
    tr = tnn.Conv2DTranspose(4, 6, 3, groups=2)
    assert tuple(tr.weight.shape) == (4, 3, 3, 3)
    with pytest.raises(ValueError, match="padding_mode"):
        tnn.Conv2D(4, 6, 3, padding_mode="reflect")


# ------------------------------------------------------------ pooling
POOLS = {
    "max_pool2d k3 s2 p1": ("max_pool2d", (3,), dict(stride=2, padding=1)),
    "max_pool2d k2": ("max_pool2d", (2,), {}),
    "max_pool2d wide pad": ("max_pool2d", (3,), dict(stride=1, padding=2)),
    "avg_pool2d exclusive pad": ("avg_pool2d", (3,),
                                 dict(stride=2, padding=1)),
    "avg_pool2d inclusive pad": ("avg_pool2d", (3,),
                                 dict(stride=2, padding=1, exclusive=False)),
    "avg_pool2d divisor": ("avg_pool2d", (2,),
                           dict(padding=1, divisor_override=3)),
    "max_pool1d": ("max_pool1d", (3,), dict(stride=2, padding=1)),
    "avg_pool1d pad": ("avg_pool1d", (3,), dict(stride=2, padding=1)),
    "adaptive_avg_pool2d 7 to 3": ("adaptive_avg_pool2d", ((3, 3),), {}),
    "adaptive_avg_pool2d 7 to 1": ("adaptive_avg_pool2d", (1,), {}),
    "adaptive_avg_pool2d 7x6 to 3x2": ("adaptive_avg_pool2d", ((3, 2),),
                                       {}),
    "adaptive_avg_pool1d": ("adaptive_avg_pool1d", (3,), {}),
    "adaptive_max_pool2d": ("adaptive_max_pool2d", ((1, 3),), {}),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pooling_matches_reference(case):
    name, args, kw = POOLS[case]
    shape = {"1d": (2, 3, 9), "7x6": (2, 3, 7, 6)}.get(
        "1d" if name.endswith("1d") else case[-7:-4], (2, 3, 7, 6))
    if name == "adaptive_avg_pool2d" and "7x6" not in case:
        shape = (2, 3, 7, 7)
    x = _rng(4).standard_normal(shape).astype(np.float32)
    _close(getattr(TF, name)(_t(x), *args, **kw),
           getattr(JF, name)(_j(x), *args, **kw))


def test_adaptive_avg_pool2d_buckets_are_not_torchs():
    """At 7 -> 3 the reference's disjoint buckets ([0,2), [2,4), [4,7))
    differ from F.adaptive_avg_pool2d's overlapping windows; the port
    takes the reference's."""
    x = _rng(5).standard_normal((1, 1, 7, 7)).astype(np.float32)
    got = TF.adaptive_avg_pool2d(_t(x), 3)
    _close(got, JF.adaptive_avg_pool2d(_j(x), 3))
    torchs = torch.nn.functional.adaptive_avg_pool2d(_t(x), 3)
    assert float((got - torchs).abs().max()) > 1e-2
    assert np.isclose(float(got[0, 0, 0, 0]), x[0, 0, :2, :2].mean(),
                      atol=1e-6)


def test_pool_layers_match_reference():
    x = _rng(6).standard_normal((2, 3, 8, 8)).astype(np.float32)
    pairs = [
        (tnn.MaxPool2D(3, 2, 1), jnn.MaxPool2D(3, 2, 1)),
        (tnn.AvgPool2D(3, 2, 1), jnn.AvgPool2D(3, 2, 1)),
        (tnn.AvgPool2D(3, 2, 1, exclusive=False),
         jnn.AvgPool2D(3, 2, 1, exclusive=False)),
        (tnn.AdaptiveAvgPool2D(3), jnn.AdaptiveAvgPool2D(3)),
        (tnn.AdaptiveMaxPool2D(2), jnn.AdaptiveMaxPool2D(2)),
    ]
    for port, ref in pairs:
        _close(port(_t(x)), ref(_j(x)))
    x1 = x.reshape(2, 3, 64)
    for port, ref in ((tnn.MaxPool1D(4, 2, 1), jnn.MaxPool1D(4, 2, 1)),
                      (tnn.AvgPool1D(4, 2, 1), jnn.AvgPool1D(4, 2, 1)),
                      (tnn.AdaptiveAvgPool1D(8), jnn.AdaptiveAvgPool1D(8))):
        _close(port(_t(x1)), ref(_j(x1)))


@pytest.mark.parametrize("kw", [dict(ceil_mode=True),
                                dict(return_mask=True),
                                dict(data_format="NHWC")])
def test_max_pool2d_refuses_what_the_reference_ignores(kw):
    """The reference's max_pool2d takes ceil_mode, return_mask and
    data_format and ignores them (its result is the defaults'); the port
    refuses any value but the default rather than give it torch's
    meaning."""
    x = _rng(7).standard_normal((1, 2, 7, 7)).astype(np.float32)
    ignored = JF.max_pool2d(_j(x), 2, **kw)
    _close(ignored, JF.max_pool2d(_j(x), 2))
    _close(TF.max_pool2d(_t(x), 2), ignored)
    with pytest.raises(ValueError, match="not supported"):
        TF.max_pool2d(_t(x), 2, **kw)
    with pytest.raises(ValueError, match="not supported"):
        tnn.MaxPool2D(2, **kw)(_t(x))


# --------------------------------------------------------------- norms
def test_batch_norm_training_updates_buffers_like_the_reference():
    """Three training calls on a BatchNorm2D: the output and the buffers
    after each call match the reference, and the buffers follow
    running = 0.9 * running + 0.1 * batch with the BIASED variance."""
    paddle.seed(0)
    ref = jnn.BatchNorm2D(5)
    port = tnn.BatchNorm2D(5)
    r = _rng(8)
    w = r.standard_normal(5).astype(np.float32)
    b = r.standard_normal(5).astype(np.float32)
    with torch.no_grad():
        port.weight.copy_(_t(w))
        port.bias.copy_(_t(b))
    ref.weight.set_value(w)
    ref.bias.set_value(b)
    ref.train()
    port.train()
    mean, var = np.zeros(5, np.float32), np.ones(5, np.float32)
    unbiased = np.ones(5, np.float32)  # torch's own rule would keep this
    for i in range(3):
        x = (2.0 + i + 3.0 * r.standard_normal((4, 5, 3, 3))).astype(
            np.float32)
        _close(port(_t(x)), ref(_j(x)))
        mean = 0.9 * mean + 0.1 * x.mean(axis=(0, 2, 3))
        var = 0.9 * var + 0.1 * x.var(axis=(0, 2, 3))
        unbiased = 0.9 * unbiased + 0.1 * x.var(axis=(0, 2, 3), ddof=1)
        for name, want in (("_mean", mean), ("_variance", var)):
            got = getattr(port, name).numpy()
            np.testing.assert_allclose(
                got, np.asarray(getattr(ref, name).numpy()), rtol=0,
                atol=TOL * float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(port._variance.numpy(), unbiased, rtol=1e-3)


def test_batch_norm_eval_channel_last_and_bf16():
    r = _rng(9)
    rm = r.standard_normal(6).astype(np.float32)
    rv = (1.0 + r.random(6)).astype(np.float32)
    w = r.standard_normal(6).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    x = r.standard_normal((3, 6, 4, 5)).astype(np.float32)
    want = JF.batch_norm(_j(x), _j(rm), _j(rv), _j(w), _j(b))
    _close(TF.batch_norm(_t(x), _t(rm), _t(rv), _t(w), _t(b)), want)
    xl = np.moveaxis(x, 1, -1).copy()
    for training in (False, True):
        jm, jv, tm, tv = _j(rm), _j(rv), _t(rm), _t(rv)
        _close(TF.batch_norm(_t(xl), tm, tv, _t(w), _t(b),
                             training=training, data_format="NHWC"),
               JF.batch_norm(_j(xl), jm, jv, _j(w), _j(b),
                             training=training, data_format="NHWC"))
        _close(tm, jm)
        _close(tv, jv)
    # bf16 input: f32 statistics, bf16 output, f32 buffers
    tm, tv = _t(rm), _t(rv)
    out = TF.batch_norm(_t(x).bfloat16(), tm, tv, training=True)
    assert out.dtype == torch.bfloat16 and tm.dtype == torch.float32
    ref_out = TF.batch_norm(_t(x).bfloat16().float(), _t(rm), _t(rv),
                            training=True)
    _close(out.float(), ref_out, tol=1e-2)
    # BatchNorm1D on [N, C]
    x2 = r.standard_normal((8, 6)).astype(np.float32)
    paddle.seed(0)
    ref1, port1 = jnn.BatchNorm1D(6), tnn.BatchNorm1D(6)
    _close(port1(_t(x2)), ref1(_j(x2)))
    _close(port1._variance, ref1._variance)


def test_group_instance_and_lrn_match_reference():
    r = _rng(10)
    x = r.standard_normal((2, 6, 4, 5)).astype(np.float32)
    w = r.standard_normal(6).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    _close(TF.group_norm(_t(x), 3, _t(w), _t(b)),
           JF.group_norm(_j(x), 3, _j(w), _j(b)))
    # one of weight / bias alone: no affine, as in the reference
    _close(TF.group_norm(_t(x), 2, _t(w)), JF.group_norm(_j(x), 2, _j(w)))
    xl = np.moveaxis(x, 1, -1).copy()
    _close(TF.group_norm(_t(xl), 3, _t(w), _t(b), data_format="NHWC"),
           JF.group_norm(_j(xl), 3, _j(w), _j(b), data_format="NHWC"))
    paddle.seed(0)
    for port, ref in ((tnn.GroupNorm(3, 6), jnn.GroupNorm(3, 6)),
                      (tnn.InstanceNorm2D(6), jnn.InstanceNorm2D(6))):
        _load(port, ref)
        _close(port(_t(x)), ref(_j(x)))
    for size in (3, 4):
        _close(TF.local_response_norm(_t(x), size, alpha=0.1, beta=0.7,
                                      k=2.0),
               JF.local_response_norm(_j(x), size, alpha=0.1, beta=0.7,
                                      k=2.0))


def test_cross_entropy_loss_layer():
    r = _rng(11)
    logits = r.standard_normal((6, 10)).astype(np.float32)
    labels = r.integers(0, 10, (6,)).astype(np.int64)
    labels[2] = -100
    for reduction in ("mean", "sum", "none"):
        _close(tnn.CrossEntropyLoss(reduction=reduction)(_t(logits),
                                                         _t(labels)),
               jnn.CrossEntropyLoss(reduction=reduction)(_j(logits),
                                                         _j(labels)))
    with pytest.raises(ValueError, match="not supported"):
        tnn.CrossEntropyLoss(label_smoothing=0.1)


# -------------------------------------------------------------- ResNet
@pytest.fixture(scope="module")
def resnet18_pair():
    """A reference ResNet(BasicBlock, 18, num_classes=10) and the port's
    copy of it (parameters and buffers)."""
    paddle.seed(0)
    ref = jres.ResNet(jres.BasicBlock, depth=18, num_classes=10)
    port = convert.resnet_from_numpy(_layer_sd(ref), depth=18,
                                     num_classes=10, device="cpu")
    return ref, port


def test_resnet_names_and_layouts_match(resnet18_pair):
    ref, port = resnet18_pair
    want = {k: v.shape for k, v in _layer_sd(ref).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert port.fc.weight.shape == (512, 10)  # paddle's [in, out]
    assert port.layer2[0].conv1.stride == 2  # BasicBlock: stride on conv1
    r50 = tres.resnet50(device="cpu")
    assert r50.layer2[0].conv2.stride == 2 and r50.layer2[0].conv1.stride \
        == 1
    assert sum(p.numel() for p in r50.parameters()) == 25557032
    for fn in (tres.resnet50, jres.resnet50):
        with pytest.raises(NotImplementedError):
            fn(pretrained=True)


def test_init_resnet_is_seeded():
    a = convert.init_resnet(18, seed=4, device="cpu", num_classes=10)
    b = convert.init_resnet(18, seed=4, device="cpu", num_classes=10)
    c = convert.init_resnet(18, seed=5, device="cpu", num_classes=10)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    assert torch.equal(a.bn1.weight, torch.ones(64))
    assert torch.equal(a.bn1._variance, torch.ones(64))


def test_tiny_resnet18_forward_and_backward(resnet18_pair):
    """Training-mode forward (batch statistics) and the gradient of the
    cross entropy with respect to every parameter."""
    ref, port = resnet18_pair
    r = _rng(12)
    x = r.standard_normal((16, 3, 32, 32)).astype(np.float32)
    y = r.integers(0, 10, (16,)).astype(np.int64)
    ref.train()
    port.train()
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    ref_saved = _layer_sd(ref)
    try:
        jl = ref(_j(x))
        tl = port(_t(x))
        _close(tl, jl, tol=1e-4)
        jloss = JF.cross_entropy(jl, _j(y))
        tloss = TF.cross_entropy(tl, _t(y))
        jloss.backward()
        tloss.backward()
        assert abs(float(tloss.detach()) - float(np.asarray(jloss.numpy()))) < 1e-4
        jgrads = {k: p.grad for k, p in ref.named_parameters()}
        for k, p in port.named_parameters():
            _close(p.grad, jgrads[k], tol=GRAD_TOL)
    finally:
        port.load_state_dict(saved)
        port.zero_grad(set_to_none=True)
        for p in ref.parameters():
            p.clear_grad()
        ref.set_state_dict({k: _j(v) for k, v in ref_saved.items()})
    ref.eval()
    port.eval()
    _close(port(_t(x)), ref(_j(x)), tol=1e-4)


def test_resnet50_forward_matches_reference():
    """resnet50 at 32x32, batch 2, eval-mode forward (1000 classes)."""
    paddle.seed(1)
    ref = jres.resnet50()
    ref.eval()
    port = convert.resnet_from_numpy(_layer_sd(ref), depth=50,
                                     device="cpu").eval()
    x = _rng(13).standard_normal((2, 3, 32, 32)).astype(np.float32)
    got = port(_t(x))
    assert got.shape == (2, 1000) and torch.isfinite(got).all()
    _close(got, ref(_j(x)), tol=1e-4)
