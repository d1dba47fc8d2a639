"""Which body the flash kernels run, and the tensor-core body's alignment
rule (``paddle_tpu_torch/ops/cuda/flash_attention.py``).

Both ``.cu`` files dispatch by dtype and head dim: bf16 at D 64 and 128
runs on the tensor cores, f32 at every D and bf16 at D 32 and 256 on the
f32 FMA body. ``flash_body`` states that rule in Python; the card tests
hold it against the kernels each library compiled. The tensor-core body
copies 16 bytes at a time, so ``check_tc_alignment`` refuses an operand
whose base or (batch, seq, head) stride is not a multiple of 16 bytes,
naming it.
These are pure shape and address rules, so they run here on CPU tensors;
on the CPU the wrappers take the plain versions whatever the alignment.
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("dtype,head_dim,body", [
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 32, "fma"),
    (torch.bfloat16, 256, "fma"),
    (torch.float32, 32, "fma"),
    (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 256, "fma"),
])
def test_flash_body_rule(dtype, head_dim, body):
    assert fa.flash_body(dtype, head_dim) == body


@pytest.mark.parametrize("name,head_dim", [
    ("gpt2_small", 64), ("gpt2_medium", 64), ("llama2_7b", 128)])
def test_port_models_take_the_tensor_core_body(name, head_dim):
    """The head dims of the models on the port's paths (GPT-2 small and
    medium train and generate, llama2_7b serves and rides the ring) run on
    the tensor cores in bf16."""
    from paddle_tpu_torch.models import gpt, llama

    cfg = (getattr(gpt, name, None) or getattr(llama, name))()
    d = cfg.head_dim
    assert d == cfg.hidden_size // cfg.num_heads == head_dim
    assert fa.flash_body(torch.bfloat16, d) == "tensor_core"


def _bshd(b, s, h, d, dtype=torch.bfloat16):
    return torch.zeros((b, s, h, d), dtype=dtype)


def test_contiguous_and_packed_views_are_aligned():
    """Fresh tensors and the packed route's q/k/v views of one [B, S, 3H,
    D] buffer pass: bases and strides are multiples of 16 bytes."""
    y = _bshd(2, 37, 3 * 4, 64)
    q, k, v = y[:, :, :4], y[:, :, 4:8], y[:, :, 8:]
    fa.check_tc_alignment(("q", q), ("k", k), ("v", v),
                          ("out", _bshd(2, 37, 4, 64)))
    # the projection's [B, S, 3 * H * D] output seen as heads (GPTAttention)
    p = torch.zeros((2, 37, 3 * 4 * 128), dtype=torch.bfloat16)
    t = p.view(2, 37, 12, 128)
    fa.check_tc_alignment(("q", t[:, :, :4]), ("k", t[:, :, 4:8]))


@pytest.mark.parametrize("offset", [1, 3, 7])
def test_misaligned_base_is_refused_by_name(offset):
    flat = torch.zeros(2 * 16 * 2 * 64 + 16, dtype=torch.bfloat16)
    k = flat[offset:offset + 2 * 16 * 2 * 64].view(2, 16, 2, 64)
    assert k.data_ptr() % 16
    with pytest.raises(ValueError, match=r"^k: .*base address"):
        fa.check_tc_alignment(("q", _bshd(2, 16, 2, 64)), ("k", k))


@pytest.mark.parametrize("dim,what", [(0, "batch"), (1, "seq"), (2, "head")])
def test_stride_not_16_bytes_is_refused_by_name(dim, what):
    """A (batch, seq, head) stride of 4 elements past a 16-byte multiple
    (8 bytes in bf16) is refused; its name and the dim are in the error."""
    b, s, h, d = 3, 5, 2, 64
    st = [s * h * d, h * d, d, 1]
    st[dim] += 4
    size = sum((n - 1) * x for n, x in zip((b, s, h, d), st)) + 1
    t = torch.zeros(size, dtype=torch.bfloat16).as_strided((b, s, h, d), st)
    with pytest.raises(ValueError, match=rf"^dv: .*{what} stride"):
        fa.check_tc_alignment(("dv", t))
    # the same strides in f32 are 16-byte multiples: 4 elements are 16 B
    t32 = torch.zeros(size, dtype=torch.float32).as_strided((b, s, h, d),
                                                            st)
    fa.check_tc_alignment(("dv", t32))


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_stride_of_a_unit_dim_is_ignored(dim):
    """A dim of size 1 never steps its stride, so any stride is taken."""
    shape = [2, 4, 3, 64]
    shape[dim] = 1
    st = list(torch.empty(shape).stride())
    st[dim] = 12345
    size = sum((n - 1) * x for n, x in zip(shape, st)) + 1
    t = torch.zeros(size, dtype=torch.bfloat16).as_strided(shape, st)
    fa.check_tc_alignment(("q", t))


def _inputs(seed, b, s, h, d, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g).to(dtype)
            for _ in range(4)]


def test_cpu_takes_the_plain_version_whatever_the_alignment():
    """On the CPU the wrappers run the plain twins, so a view the card's
    tensor-core body refuses still computes, equal to its contiguous copy,
    and no launch is counted."""
    q, k, v, do = _inputs(0, 2, 24, 2, 64)
    flat = torch.zeros(k.numel() + 8, dtype=k.dtype)
    ks = flat[1:1 + k.numel()].view_as(k)
    ks.copy_(k)
    with pytest.raises(ValueError):
        fa.check_tc_alignment(("k", ks))
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.tc_launches,
              fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.tc_launches)
    out, lse = fa.flash_attention_fwd(q, ks, v, return_lse=True)
    want, want_lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    got = fa.flash_attention_bwd(q, ks, v, out, do, lse)
    ref = fa.flash_attention_bwd(q, k, v, out, do, lse)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd.tc_launches,
            fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.tc_launches) == counts


@pytest.mark.parametrize("d", [64, 128])
def test_tc_cases_plain_twins_hold_the_rounding_points(d):
    """The plain twins the tensor-core body is held against round P (and
    dS) to bf16 before their products; at the tensor-core head dims they
    stay within the card checks' 2e-2 (lse 1e-4) of the same math on f32
    upcasts, which rounds nothing."""
    q, k, v, do = _inputs(1, 2, 40, 2, d)
    out, lse = fa.flash_attention_ref(q, k, v, return_lse=True)
    out32, lse32 = fa.flash_attention_ref(*(t.float() for t in (q, k, v)),
                                          return_lse=True)
    assert float((out.float() - out32).abs().max()) <= 2e-2
    assert float((lse - lse32).abs().max()) <= 1e-4
    grads = fa.flash_attention_bwd_ref(q, k, v, out, do, lse)
    want = fa.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out,
                                                             do)), lse)
    for a, b in zip(grads, want):
        top = max(1.0, float(b.abs().max()))
        assert float((a.float() - b).abs().max()) <= 2e-2 * top
