"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (sm_90a); without one they
skip (the decision is taken inside the ``cuda`` fixture, never at import).
They cover what the main path of ``chip_smoke.py`` does not reach: GQA
groups, other head dims and page sizes, lengths past the table capacity,
f32, ragged and strided flash inputs, and the wrappers' refusals.

Run them on the card with (``--noconftest``: the suite's conftest imports
JAX, which the port's machine need not have; this file uses none of it)::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py -q

Tolerances: f32 1e-4 (online vs direct softmax, summation order); bf16
2e-2 (outputs rounded to bf16, P rounded to bf16 before P.V).
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import paged_attention as pa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for "
                    "sm_90a and have no CPU mode)")
    return torch.device("cuda")


def _decode_inputs(dev, dtype, quant, B, H, Hkv, D, ps, max_pages, lengths,
                   seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + B * max_pages
    shape = (P, ps, Hkv * D)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    sc = None
    if quant:
        kq, ks = pa.quantize_rows_int8(k.view(P, ps, Hkv, D))
        vq, vs = pa.quantize_rows_int8(v.view(P, ps, Hkv, D))
        sc = torch.zeros((P, ps, 128), dtype=torch.bfloat16, device=dev)
        sc[..., :Hkv] = ks.to(torch.bfloat16)
        sc[..., Hkv:2 * Hkv] = vs.to(torch.bfloat16)
        k, v = kq.view(shape), vq.view(shape)
    else:
        k, v = k.to(dtype), v.to(dtype)
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    tables = perm[:B * max_pages].view(B, max_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    return q, k, v, tables, lens, sc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,Hkv,D,ps", [(8, 2, 64, 8), (4, 4, 128, 16),
                                        (8, 1, 32, 16), (2, 2, 256, 4)])
def test_decode_kernel_matches_plain(cuda, dtype, quant, H, Hkv, D, ps):
    max_pages = 6
    cap = max_pages * ps
    # idle, one token, a partial page, the capacity, past the capacity
    lengths = [0, 1, ps + 3, cap, cap + 7]
    q, k, v, tables, lens, sc = _decode_inputs(
        cuda, dtype, quant, len(lengths), H, Hkv, D, ps, max_pages, lengths)
    before = pa.paged_slab_decode_attention.launches
    got = pa.paged_slab_decode_attention(q, k, v, tables, lens, H,
                                         scale_pages=sc)
    torch.cuda.synchronize()
    assert pa.paged_slab_decode_attention.launches == before + 1
    want = pa.paged_slab_decode_attention_ref(q, k, v, tables, lens,
                                              scale_pages=sc)
    assert got.dtype == dtype and got.shape == (len(lengths), H, D)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.all(got[0] == 0)  # the idle row gives exact zeros


def test_decode_kernel_custom_scale(cuda):
    q, k, v, tables, lens, _ = _decode_inputs(
        cuda, torch.float32, False, 2, 4, 2, 64, 8, 4, [5, 20])
    got = pa.paged_slab_decode_attention(q, k, v, tables, lens, scale=0.3)
    want = pa.paged_slab_decode_attention_ref(q, k, v, tables, lens,
                                              scale=0.3)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_decode_kernel_refuses(cuda):
    q, k, v, tables, lens, _ = _decode_inputs(
        cuda, torch.float32, False, 2, 4, 2, 48, 8, 4, [5, 20])
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_slab_decode_attention(q, k, v, tables, lens)
    q, k, v, tables, lens, _ = _decode_inputs(
        cuda, torch.float32, False, 2, 4, 2, 64, 8, 4, [5, 20])
    with pytest.raises(TypeError, match="int32"):
        pa.paged_slab_decode_attention(q, k, v, tables.long(), lens)
    with pytest.raises(TypeError):
        pa.paged_slab_decode_attention(q, k.bfloat16(), v.bfloat16(),
                                       tables, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_slab_decode_attention(q.transpose(0, 1).contiguous()
                                       .transpose(0, 1), k, v, tables, lens)


def test_paged_state_step_on_card(cuda):
    """The paged step on the card (in-place page write, then the kernel)
    against the same step on the CPU's plain path."""
    B, H, Hkv, D, ps, mp = 3, 4, 2, 64, 8, 4
    g = torch.Generator().manual_seed(3)
    P = 1 + B * mp
    pages = torch.randn((P, ps, Hkv * D), generator=g)
    tables = torch.arange(1, P, dtype=torch.int32).view(B, mp)
    lens = torch.tensor([3, 0, mp * ps], dtype=torch.int32)
    q = torch.randn((B, H, D), generator=g)
    kk = torch.randn((B, Hkv, D), generator=g)
    vv = torch.randn((B, Hkv, D), generator=g)
    outs = []
    for dev in ("cpu", cuda):
        st = pa.PagedCacheState(pages.clone().to(dev), pages.clone().to(dev),
                                None, tables.to(dev), lens.to(dev), ps)
        out, st = pa.paged_state_step(st, q.to(dev), kk.to(dev), vv.to(dev))
        outs.append((out.cpu(), st.k_pages.cpu(), st.lengths.cpu()))
    (o0, k0, l0), (o1, k1, l1) = outs
    torch.testing.assert_close(o1, o0, atol=1e-4, rtol=1e-4)
    assert torch.equal(k1, k0) and torch.equal(l1, l0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 65, 200])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 128), (8, 2, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, S, H, Hkv, D):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((2, S, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, S, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, S, Hkv, D), generator=g, device=cuda).to(dtype)
    before = fa.flash_attention_fwd.launches
    got, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want, want_lse = fa.flash_attention_ref(q, k, v, causal=causal,
                                            return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as views into one packed [B, S, 3, H, D] tensor: the kernel
    reads the strides, no copy."""
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((2, 77, 3, 4, 64), generator=g, device=cuda)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    got = fa.flash_attention_fwd(q, k, v, causal=True, scale=0.2)
    want = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, scale=0.2)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_kernel_cross_lengths(cuda):
    """Sq != Sk (non-causal; the plain version has top-left causality)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((1, 30, 4, 64), generator=g, device=cuda)
    k = torch.randn((1, 130, 4, 64), generator=g, device=cuda)
    v = torch.randn((1, 130, 4, 64), generator=g, device=cuda)
    for causal in (False, True):
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_kernel_refuses(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 8, 2, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q, q, q)


def test_engine_greedy_matches_cacheless_on_card(cuda):
    """Tiny LLaMA (f32) served on the card: each greedy stream equals the
    argmax of the cacheless forward recomputed token by token, up to the
    first near-tie."""
    import numpy as np

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import tiny_llama_config

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_llama_config(hidden_size=256, num_heads=4, num_kv_heads=2,
                            max_position=256)
    model = init_llama(cfg, seed=0, device=cuda, dtype=torch.float32)
    eng = Engine(model, max_slots=2, num_pages=64, page_size=8,
                 chunk_size=4)
    rng = np.random.default_rng(0)
    reqs = [eng.add_request(rng.integers(0, cfg.vocab_size, (n,)), 12)
            for n in (5, 37, 70)]
    eng.run()
    for r in reqs:
        assert r.state == "FINISHED" and len(r.tokens) == 12
        seq = torch.as_tensor(r.prompt, dtype=torch.int64, device=cuda)
        with torch.no_grad():
            for tok in r.tokens:
                logits = model(seq[None])[0, -1]
                top2 = torch.topk(logits, 2).values
                if (top2[0] - top2[1]).item() < 1e-4:
                    break
                assert int(torch.argmax(logits)) == tok
                seq = torch.cat([seq, seq.new_tensor([tok])])
