"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (sm_90a); without one they
skip (the decision is taken inside the ``cuda`` fixture, never at import).
They cover what the main path of ``chip_smoke.py`` does not reach: GQA
groups, other head dims and page sizes, lengths (and verify bases) past
the table capacity, verify widths from 1 to 300, f32, int8 pages, ragged
and strided inputs, the wrappers' refusals, and the engine's modes that
ride the verify kernel; the weight-only quant matmul (#12) and the grouped
expert matmul (#13) at the main path's shapes and at odd ones (K no tile
multiple, N = 1, one row, one expert, every group empty), and the
quantized and MoE engines; the flash backward (general layout, sq != sk,
ragged lengths, D 64-256, an lse cotangent, strided packed views into one
dQKV, determinism), the autograd Functions, the packed route and a tiny
GPT's gradients against plain attention; the contiguous decode kernels
(#14 on ``[B, Hkv, S, D]`` caches, #15 on the slab, strided views) and the
head-major paged one (#4, int8 pages) at GQA groups 1/4/8, D 32-256, f32
and bf16 (f32 within 2e-5, bf16 within one bf16 ulp of the output's
largest entry), and tiny models generating on the card against the CPU;
the position forms of the flash forward and backward (zig-zag chunk pairs,
rows that see no key, ragged unequal lengths, ``llama2_7b`` widths, equal
to the causal kernels on 0..S-1) and the ring on a one-rank NCCL world
against its materialized-logits version.

Run them on the card with (``--noconftest``: the suite's conftest imports
JAX, which the port's machine need not have; this file uses none of it)::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py -q

Tolerances: f32 1e-4 (online vs direct softmax, summation order); bf16
2e-2 (outputs rounded to bf16, P rounded to bf16 before P.V). Flash
gradients are also held to NORM_TOL in relative norm (f32 1e-4, bf16
1e-2; ``_grads_close``), which catches an error spread over many small
entries.
"""
import re

import pytest
import torch

from paddle_tpu_torch.ops.cuda import decode_attention as da
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.ops.cuda import quant_matmul as qm

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
    assert all(r.state == "FINISHED" and len(r.tokens) == 12 for r in reqs)
    _greedy_matches_cacheless(model, reqs, "plain")


def _verify_inputs(dev, dtype, quant, B, m, H, Hkv, D, ps, max_pages,
                   seed=0):
    q1, k, v, tables, _, sc = _decode_inputs(
        dev, dtype, quant, B, H, Hkv, D, ps, max_pages, [0] * B, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    q = torch.randn((B, m, H, D), generator=g, device=dev).to(dtype)
    return q, k, v, tables, sc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("m", [1, 5, 17, 64, 65, 300])
@pytest.mark.parametrize("H,Hkv,D,ps", [(32, 8, 128, 16), (8, 2, 64, 8)])
def test_verify_kernel_matches_plain(cuda, dtype, quant, m, H, Hkv, D, ps):
    max_pages = 40
    cap = max_pages * ps
    # base 0, a partial page, mid-window, one that reaches the capacity
    # inside the block, and one past it
    bases = [0, ps + 3, cap // 2, cap - m // 2 - 1, cap + 5]
    q, k, v, tables, sc = _verify_inputs(cuda, dtype, quant, len(bases), m,
                                         H, Hkv, D, ps, max_pages)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    before = pa.paged_verify_slab_attention.launches
    got = pa.paged_verify_slab_attention(q, k, v, tables, base,
                                         scale_pages=sc)
    torch.cuda.synchronize()
    assert pa.paged_verify_slab_attention.launches == before + 1
    want = pa.paged_verify_slab_attention_ref(q, k, v, tables, base,
                                              scale_pages=sc)
    assert got.dtype == torch.float32 and got.shape == (len(bases), m, H, D)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernel_head_dim_256(cuda, dtype):
    q, k, v, tables, _ = _verify_inputs(cuda, dtype, False, 2, 9, 4, 2, 256,
                                        16, 6)
    base = torch.tensor([3, 70], dtype=torch.int32, device=cuda)
    got = pa.paged_verify_slab_attention(q, k, v, tables, base)
    want = pa.paged_verify_slab_attention_ref(q, k, v, tables, base)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_verify_kernel_strided_q_and_scale(cuda):
    """q as a view into a packed [B, m, 3, H, D] tensor: the kernel reads
    its strides, no copy; a custom softmax scale."""
    g = torch.Generator(device=cuda).manual_seed(9)
    _, k, v, tables, _ = _verify_inputs(cuda, torch.float32, False, 3, 7, 8,
                                        2, 64, 8, 10)
    qkv = torch.randn((3, 7, 3, 8, 64), generator=g, device=cuda)
    q = qkv[:, :, 1]
    assert not q.is_contiguous()
    base = torch.tensor([0, 30, 79], dtype=torch.int32, device=cuda)
    got = pa.paged_verify_slab_attention(q, k, v, tables, base, scale=0.3)
    want = pa.paged_verify_slab_attention_ref(q.contiguous(), k, v, tables,
                                              base, scale=0.3)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_verify_kernel_refuses(cuda):
    q, k, v, tables, _ = _verify_inputs(cuda, torch.float32, False, 2, 3, 4,
                                        2, 32, 8, 4)
    base = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_verify_slab_attention(q, k, v, tables, base)
    q, k, v, tables, _ = _verify_inputs(cuda, torch.float32, False, 2, 3, 4,
                                        2, 64, 8, 4)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_verify_slab_attention(q, k, v, tables, base.long())
    with pytest.raises(TypeError):
        pa.paged_verify_slab_attention(q, k.bfloat16(), v.bfloat16(),
                                       tables, base)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_verify_slab_attention(q, k, v, tables.t().contiguous().t(),
                                       base)


@pytest.mark.parametrize("widths", [None, [3, 5, 0]])
def test_paged_state_verify_on_card(cuda, widths):
    """The verify step on the card (in-place block write, then the kernel)
    against the same step on the CPU's plain path, in the spec form and
    the partial-prefill form."""
    B, m, H, Hkv, D, ps, mp = 3, 5, 4, 2, 64, 8, 4
    g = torch.Generator().manual_seed(4)
    P = 1 + B * mp
    pages = torch.randn((P, ps, Hkv * D), generator=g)
    tables = torch.arange(1, P, dtype=torch.int32).view(B, mp)
    # the last row's block ends at the capacity exactly (a block past it
    # would write its clamped rows to one slot in an unspecified order)
    lens = torch.tensor([3, 0, mp * ps - m], dtype=torch.int32)
    valid = None if widths is None else torch.tensor(widths,
                                                     dtype=torch.int32)
    q = torch.randn((B, m, H, D), generator=g)
    kk = torch.randn((B, m, Hkv, D), generator=g)
    vv = torch.randn((B, m, Hkv, D), generator=g)
    outs = []
    for dev in ("cpu", cuda):
        st = pa.PagedCacheState(
            pages.clone().to(dev), pages.clone().to(dev), None,
            tables.to(dev), lens.to(dev), ps,
            prefill_valid=None if valid is None else valid.to(dev),
            verify=True)
        out, st = pa.paged_state_verify(st, q.to(dev), kk.to(dev),
                                        vv.to(dev))
        outs.append((out.cpu(), st.k_pages.cpu(), st.lengths.cpu()))
    (o0, k0, l0), (o1, k1, l1) = outs
    torch.testing.assert_close(o1, o0, atol=1e-4, rtol=1e-4)
    assert torch.equal(k1[1:], k0[1:]) and torch.equal(l1, l0)


def test_engine_modes_match_cacheless_on_card(cuda):
    """Tiny LLaMA (f32) served on the card with the prefix cache, chunked
    prefill and n-gram spec decoding: each greedy stream equals the argmax
    of the cacheless forward, up to the first near-tie, and each mode
    launched the verify kernel."""
    import numpy as np

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import tiny_llama_config

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_llama_config(hidden_size=256, num_heads=4, num_kv_heads=2,
                            max_position=256)
    model = init_llama(cfg, seed=0, device=cuda, dtype=torch.float32)
    rng = np.random.default_rng(0)
    pre = rng.integers(0, cfg.vocab_size, (24,))
    tails = [rng.integers(0, cfg.vocab_size, (n,)) for n in (8, 13)]
    rep = np.tile(rng.integers(0, cfg.vocab_size, (6,)), 5)
    runs = [
        (dict(prefix_cache=True),
         [[np.concatenate([pre, tails[0]])],
          [np.concatenate([pre, tails[1]]), np.concatenate([pre, tails[0]])]]),
        (dict(prefill_chunk=8), [[rng.integers(0, cfg.vocab_size, (n,))
                                  for n in (5, 37, 70)]]),
        (dict(spec="ngram", spec_k=3), [[rep, rep[:20]]]),
    ]
    for kw, waves in runs:
        eng = Engine(model, max_slots=2, num_pages=64, page_size=8,
                     chunk_size=4, **kw)
        before = pa.paged_verify_slab_attention.launches
        reqs = []
        for wave in waves:
            reqs += [eng.add_request(p, 12) for p in wave]
            eng.run()
        assert pa.paged_verify_slab_attention.launches > before, kw
        assert all(r.state == "FINISHED" and len(r.tokens) == 12
                   for r in reqs)
        _greedy_matches_cacheless(model, reqs, kw)


# ------------------------------------------------ #12 weight-only matmul
def _quant_inputs(dev, dtype, int4, M, K, N, seed=0, bias=True):
    """x ~ N(0, 1); the weight is a normal(0, 0.02) matrix through
    ``weight_quantize``, as a model's would be."""
    from paddle_tpu_torch.nn.quant import weight_quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w, sc = weight_quantize(
        torch.randn((K, N), generator=g, device=dev) * 0.02,
        "weight_only_int4" if int4 else "weight_only_int8")
    b = torch.randn((N,), generator=g, device=dev) if bias else None
    return x, w, sc, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 4096), (40, 4096, 11008),
                                   (8, 11008, 4096), (1, 130, 1),
                                   (256, 512, 1000), (3, 2, 7),
                                   (17, 1030, 129)])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, int4, M, K, N):
    x, w, sc, b = _quant_inputs(cuda, dtype, int4, M, K, N)
    wd = "int4" if int4 else "int8"
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(x, w, sc, b, weight_dtype=wd)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == before + 1
    want = qm.quant_matmul_ref(x, w, sc, b, weight_dtype=wd)
    assert got.dtype == dtype and got.shape == (M, N)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_quant_matmul_kernel_leading_dims_no_bias(cuda):
    x, w, sc, _ = _quant_inputs(cuda, torch.bfloat16, False, 6, 256, 96,
                                bias=False)
    x3 = x.reshape(2, 3, 256)
    got = qm.quant_matmul(x3, w, sc)
    want = qm.quant_matmul_ref(x3, w, sc)
    assert got.shape == (2, 3, 96)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_quant_matmul_kernel_refuses(cuda):
    x, w, sc, _ = _quant_inputs(cuda, torch.float32, False, 4, 64, 32)
    with pytest.raises(TypeError):
        qm.quant_matmul(x.half(), w, sc)
    with pytest.raises(TypeError):
        qm.quant_matmul(x, w, sc.double())
    with pytest.raises(ValueError):
        qm.quant_matmul(x, w[:32], sc)
    with pytest.raises(ValueError):
        qm.quant_matmul(x, w.t().contiguous().t(), sc)


def test_weight_only_linear_routes_by_rows(cuda):
    from paddle_tpu_torch.nn import quant

    x, w, sc, _ = _quant_inputs(cuda, torch.bfloat16, False, 300, 128, 64,
                                bias=False)
    before = qm.quant_matmul.launches
    quant.weight_only_linear(x[:256], w, None, sc)
    assert qm.quant_matmul.launches == before + 1
    y = quant.weight_only_linear(x, w, None, sc)  # 300 rows: no kernel
    assert qm.quant_matmul.launches == before + 1
    torch.testing.assert_close(
        y.float(), quant.quant_matmul_xla(x, w, sc).float())


# ------------------------------------------------ #13 grouped matmul
def _grouped_inputs(dev, dtype, M, K, N, E, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    lhs = torch.randn((M, K), generator=g, device=dev).to(dtype)
    rhs = (torch.randn((E, K, N), generator=g, device=dev)
           / K ** 0.5).to(dtype)
    return lhs, rhs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,sizes,valid", [
    (24, 4096, 14336, [3] * 8, [3, 1, 0, 2, 3, 3, 0, 1]),
    (24, 14336, 4096, [3] * 8, [3, 3, 3, 3, 3, 3, 3, 3]),
    (300, 100, 70, [64, 0, 129, 100], [60, 0, 129, 1]),
    (40, 16, 32, [7, 13, 3, 17], None),
    (30, 16, 32, [5, 5, 5, 5], None),
    (16, 33, 1, [16], None),
    (1, 8, 9, [1, 0], None),
    (10, 8, 24, [0, 0, 0], None),
    (20, 24, 40, [30, 30], [25, 3]),
])
def test_grouped_matmul_kernel_matches_plain(cuda, dtype, M, K, N, sizes,
                                             valid):
    lhs, rhs = _grouped_inputs(cuda, dtype, M, K, N, len(sizes))
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    vs = None if valid is None else torch.tensor(valid, dtype=torch.int32,
                                                 device=cuda)
    before = gm.grouped_matmul.launches
    got = gm.grouped_matmul(lhs, rhs, gs, vs)
    torch.cuda.synchronize()
    assert gm.grouped_matmul.launches == before + 1
    want = gm.grouped_matmul_ref(lhs, rhs, gs, vs)
    assert got.dtype == dtype and got.shape == (M, N)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    dead = (want == 0).all(-1)
    assert not bool(got[dead].any())  # dead rows exactly zero


def test_grouped_matmul_kernel_prefill_capacity(cuda):
    """Mixtral prefill layout, cut to 2 experts: C = 1280 rows each with
    uneven kept counts."""
    lhs, rhs = _grouped_inputs(cuda, torch.bfloat16, 2560, 4096, 1024, 2)
    gs = torch.full((2,), 1280, dtype=torch.int32, device=cuda)
    vs = torch.tensor([1000, 1], dtype=torch.int32, device=cuda)
    got = gm.grouped_matmul(lhs, rhs, gs, vs)
    want = gm.grouped_matmul_ref(lhs, rhs, gs, vs)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert not bool(got[1000:1280].any()) and not bool(got[1281:].any())


def test_grouped_matmul_kernel_refuses(cuda):
    lhs, rhs = _grouped_inputs(cuda, torch.float32, 8, 16, 8, 2)
    gs = torch.tensor([4, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gm.grouped_matmul(lhs.half(), rhs.half(), gs)
    with pytest.raises(TypeError):
        gm.grouped_matmul(lhs, rhs.bfloat16(), gs)
    with pytest.raises(TypeError):
        gm.grouped_matmul(lhs, rhs, gs.long())
    with pytest.raises(TypeError):
        gm.grouped_matmul(lhs, rhs, gs.cpu())
    with pytest.raises(ValueError):
        gm.grouped_matmul(lhs.t(), rhs, gs)


def _greedy_matches_cacheless(model, reqs, tag):
    """Each greedy stream equals the argmax of the cacheless forward, up to
    the first near-tie (top-2 gap < 1e-4)."""
    for r in reqs:
        seq = torch.as_tensor(r.prompt, dtype=torch.int64,
                              device=model.device)
        with torch.no_grad():
            for tok in r.tokens:
                logits = model(seq[None])[0, -1]
                top2 = torch.topk(logits, 2).values
                if (top2[0] - top2[1]).item() < 1e-4:
                    break
                assert int(torch.argmax(logits)) == tok, tag
                seq = torch.cat([seq, seq.new_tensor([tok])])


def test_quantized_and_moe_engines_match_cacheless_on_card(cuda):
    """An int8-weight tiny LLaMA and a tiny MoE (f32; capacity 4.0, so
    nothing drops in either forward) served on the card: greedy streams
    equal the argmax of the cacheless forward, and each engine launched
    its kernel."""
    import numpy as np

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import (tiny_llama_config,
                                               tiny_moe_llama_config)
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    dense = init_llama(tiny_llama_config(hidden_size=256,
                                         max_position=256), seed=0,
                       device=cuda, dtype=torch.float32)
    quantize_for_decode(dense)
    moe = init_llama(tiny_moe_llama_config(hidden_size=256,
                                           max_position=256), seed=1,
                     device=cuda, dtype=torch.float32)
    for model, counter, kw in ((dense, qm.quant_matmul, {}),
                               (moe, gm.grouped_matmul,
                                dict(capacity_factor=4.0))):
        eng = Engine(model, max_slots=2, num_pages=64, page_size=8,
                     chunk_size=4, **kw)
        before = counter.launches
        reqs = [eng.add_request(rng.integers(0, 128, (n,)), 12)
                for n in (5, 19, 40)]
        eng.run()
        assert counter.launches > before
        assert all(r.state == "FINISHED" for r in reqs)
        _greedy_matches_cacheless(model, reqs, counter.__name__)
    assert eng.moe_stats()["pairs_dropped"] == 0


# ------------------------------------------------ flash backward (#5, #6,
# #10, #11) and the packed causal forward (#7-#9) on #2's kernel
def _bwd_inputs(dev, dtype, B, Sq, Sk, H, D, causal, seed=0, dlse=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, H, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, H, D), generator=g, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_lse=True)
    dl = (torch.randn((B, H, Sq), generator=g, device=dev) if dlse
          else None)
    return q, k, v, out, do, lse, dl


def _grads_close(got, want, dtype, tag=""):
    """Each gradient within TOL[dtype] of its largest entry, and within
    NORM_TOL[dtype] of ``want`` in norm relative to ``max(||want||, 1)``:
    the floor of 1, like the entrywise scale's, keeps a gradient that is
    zero by cancellation (one key per query: dP = delta) from holding
    rounding noise to its own size."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(1.0, float(b.float().abs().max()))
        err = float((a.float() - b.float()).abs().max())
        assert err <= TOL[dtype] * scale, f"{tag} {name}: {err} > " \
            f"{TOL[dtype]} * {scale}"
        rel = float(torch.linalg.vector_norm(a.float() - b.float())) / max(
            float(torch.linalg.vector_norm(b.float())), 1.0)
        assert rel <= NORM_TOL[dtype], f"{tag} {name}: relative norm " \
            f"{rel} > {NORM_TOL[dtype]}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (63, 63), (65, 65), (200, 200),
                                   (64, 130), (130, 64), (1030, 1030)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, causal, Sq, Sk, D):
    q, k, v, out, do, lse, _ = _bwd_inputs(cuda, dtype, 2, Sq, Sk, 2, D,
                                           causal, seed=Sq + D)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal)
    for a, b in zip(got, (q, k, v)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_lse_cotangent(cuda, dtype, causal):
    q, k, v, out, do, lse, dl = _bwd_inputs(cuda, dtype, 2, 100, 100, 4, 64,
                                            causal, seed=3, dlse=True)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, dl, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, dl,
                                      causal=causal)
    _grads_close(got, want, dtype)
    without = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    assert not torch.equal(without[0], got[0])


def test_flash_bwd_kernel_is_deterministic(cuda):
    args = _bwd_inputs(cuda, torch.bfloat16, 2, 300, 300, 4, 64, True)
    a = fa.flash_attention_bwd(*args[:6])
    b = fa.flash_attention_bwd(*args[:6])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_strided_packed_views(cuda, dtype):
    """q, k, v, out and dO as views of packed buffers, dq/dk/dv written
    into views of one packed dQKV: the values of the contiguous call."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, S, H, D = 2, 96, 4, 64
    y = torch.randn((B, S, 3 * H, D), generator=g, device=cuda).to(dtype)
    q, k, v = y[:, :, :H], y[:, :, H:2 * H], y[:, :, 2 * H:]
    o = torch.empty((B, S, H, D), dtype=dtype, device=cuda)
    _, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, out=o)
    do = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    dqkv = torch.empty((B, S, 3 * H, D), dtype=dtype, device=cuda)
    fa.flash_attention_bwd(q, k, v, o, do, lse, grads=(
        dqkv[:, :, :H], dqkv[:, :, H:2 * H], dqkv[:, :, 2 * H:]))
    cq, ck, cv = (t.contiguous() for t in (q, k, v))
    co, clse = fa.flash_attention_fwd(cq, ck, cv, return_lse=True)
    assert torch.equal(co, o) and torch.equal(clse, lse)
    want = fa.flash_attention_bwd(cq, ck, cv, co, do, clse)
    assert torch.equal(dqkv[:, :, :H], want[0])
    assert torch.equal(dqkv[:, :, H:2 * H], want[1])
    assert torch.equal(dqkv[:, :, 2 * H:], want[2])


def test_flash_bwd_kernel_refuses(cuda):
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q, q, q, q, q, lse)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    k = torch.zeros((1, 8, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="heads"):
        fa.flash_attention_bwd(q, k, k, q, q, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q, q, lse.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_grads_on_card(cuda, dtype):
    """``F.flash_attention``'s Function (both kernels) against autograd
    through the plain ``naive_attention``, with the lse cotangent too."""
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device=cuda).manual_seed(5)
    ts = [torch.randn((2, 200, 4, 64), generator=g, device=cuda).to(dtype)
          .requires_grad_() for _ in range(3)]
    ct = torch.randn((2, 200, 4, 64), generator=g, device=cuda).to(dtype)
    out, _ = F.flash_attention(*ts, causal=True)
    got = torch.autograd.grad((out.float() * ct.float()).sum(), ts)
    ref = [t.detach().float().requires_grad_() for t in ts]
    want_o = F.naive_attention(*ref, causal=True)
    want = torch.autograd.grad((want_o * ct.float()).sum(), ref,
                               retain_graph=True)
    _grads_close(got, want, dtype, "Function")
    ctl = torch.randn((2, 4, 200), generator=g, device=cuda)
    o2, lse2 = fa.flash_attention_with_lse(*ts)
    got2 = torch.autograd.grad((o2.float() * ct.float()).sum()
                               + (lse2 * ctl).sum(), ts)
    s = torch.einsum("bqhd,bkhd->bhqk", ref[0], ref[1]) / 8.0
    s = s.masked_fill(~torch.ones((200, 200), dtype=torch.bool,
                                  device=cuda).tril(), float("-inf"))
    want2 = torch.autograd.grad((want_o * ct.float()).sum()
                                + (torch.logsumexp(s, -1) * ctl).sum(), ref)
    _grads_close(got2, want2, dtype, "with lse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,hpb", [(256, 1), (256, 2), (1024, 2),
                                   (2048, 2), (2048, 1)])
def test_causal_flash_qkv_on_card(cuda, dtype, S, hpb):
    """The packed route on the card (#2's forward on strided views, the
    backward kernel into one dQKV) against the plain packed attention."""
    from paddle_tpu_torch.ops.cuda import causal_flash as cf

    g = torch.Generator(device=cuda).manual_seed(S + hpb)
    B, H, D = 2, 4, 64
    y = (torch.randn((B, S, 3 * H * D), generator=g, device=cuda) * 0.5
         ).to(dtype).requires_grad_()
    qkv = y.view(B, S, 3 * H // hpb, hpb * D).transpose(1, 2)
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out = cf.causal_flash_qkv(qkv, H, D)
    ct = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    (got,) = torch.autograd.grad((out.float() * ct.float()).sum(), y)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches - f0,
            fa.flash_attention_bwd.launches - b0) == (1, 1)
    yr = y.detach().float().requires_grad_()
    want_o = cf.causal_flash_qkv_ref(
        yr.view(B, S, 3 * H // hpb, hpb * D).transpose(1, 2), H, D)
    (want,) = torch.autograd.grad((want_o * ct.float()).sum(), yr)
    torch.testing.assert_close(out.float(), want_o, atol=TOL[dtype],
                               rtol=TOL[dtype])
    scale = max(1.0, float(want.abs().max()))
    assert float((got.float() - want).abs().max()) <= TOL[dtype] * scale


def test_tiny_gpt_grads_on_card(cuda):
    """A 2-layer GPT (hidden 128, two heads of 64), f32: loss and every
    gradient with the kernels (packed and general routes) against plain
    attention (``FLAGS_use_flash_attention`` off, the packed route off)."""
    from paddle_tpu_torch.convert import init_gpt
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=96, hidden_size=128, num_layers=2,
                    num_heads=2, max_position=256)
    model = init_gpt(cfg, seed=2, device=cuda)
    model.train()
    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(0, 96, (2, 200), generator=g, device=cuda)
    labels = torch.randint(0, 96, (2, 200), generator=g, device=cuda)
    names = ("FLAGS_use_packed_attention", "FLAGS_use_flash_attention")
    saved = get_flags(names)

    def run(packed, flash):
        set_flags({names[0]: packed, names[1]: flash})
        model.zero_grad(set_to_none=True)
        loss = model.loss(ids, labels)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    try:
        want_l, want = run(False, False)
        b0 = fa.flash_attention_bwd.launches
        for packed in (True, False):
            got_l, got = run(packed, True)
            assert abs(got_l - want_l) < 1e-4
            for n, w in want.items():
                scale = max(float(w.abs().max()), 1e-6)
                err = float((got[n] - w).abs().max())
                assert err <= 1e-4 * scale, (packed, n, err, scale)
        assert fa.flash_attention_bwd.launches == b0 + 2 * cfg.num_layers
    finally:
        set_flags(saved)


def _ulp_close(got, want, dtype):
    """f32: within 2e-5; bf16: within one bf16 ulp of want's largest
    entry (both round the same f32 result)."""
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        assert err <= 2e-5, err
    else:
        top = float(want.float().abs().max())
        ulp = 2.0 ** (torch.floor(torch.log2(torch.tensor(top))).item() - 7)
        assert err <= ulp, (err, ulp)


def _contig_inputs(dev, dtype, B, H, Hkv, D, S, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    cache = torch.randn((2, B, Hkv, S, D), generator=g,
                        device=dev).to(dtype)
    return q, cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["5d", "slab"])
@pytest.mark.parametrize("H,Hkv,D", [(8, 8, 64), (16, 4, 128), (16, 2, 64),
                                     (8, 1, 32), (4, 4, 256)])
def test_contiguous_decode_kernels_match_plain(cuda, dtype, layout, H, Hkv,
                                               D):
    S = 100
    # idle, one token, a partial window, the whole window, past it
    lengths = [0, 1, 37, S, S + 9]
    q, cache = _contig_inputs(cuda, dtype, len(lengths), H, Hkv, D, S)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if layout == "5d":
        fn, args = da.decode_attention, (cache[0], cache[1])
    else:
        slab = cache.transpose(2, 3).reshape(2, len(lengths), S,
                                             Hkv * D).contiguous()
        fn, args = da.decode_attention_slab, (slab,)
    before = fn.launches
    got = fn(q, *args, lens)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = da.decode_attention_ref(q, cache[0], cache[1], lens)
    assert got.dtype == dtype and got.shape == q.shape
    _ulp_close(got, want, dtype)
    assert torch.all(got[0] == 0)  # length 0 gives exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_kernel_strided_views(cuda, dtype):
    """A slab cut from a longer one (its batch stride is the long
    slab's), q a strided view of a packed QKV row, and a custom scale."""
    B, H, Hkv, D, S = 3, 8, 2, 128, 300
    g = torch.Generator(device=cuda).manual_seed(4)
    wide = torch.randn((2, B, S + 50, Hkv * D), generator=g,
                       device=cuda).to(dtype)
    slab = wide[:, :, :S]
    qkv = torch.randn((B, 3, H, D), generator=g, device=cuda).to(dtype)
    q = qkv[:, 0]
    lens = torch.tensor([5, 299, 300], dtype=torch.int32, device=cuda)
    got = da.decode_attention_slab(q, slab, lens, scale=0.2)
    want = da._slab_ref(q, slab, lens, scale=0.2)
    _ulp_close(got, want, dtype)


def test_contiguous_decode_kernel_refuses(cuda):
    q, cache = _contig_inputs(cuda, torch.float32, 2, 4, 2, 48, 16)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q, cache[0], cache[1], lens)
    q, cache = _contig_inputs(cuda, torch.float32, 2, 4, 2, 64, 16)
    with pytest.raises(TypeError, match="dtype"):
        da.decode_attention(q, cache[0].bfloat16(), cache[1].bfloat16(),
                            lens)
    k, v = (c.transpose(2, 3).contiguous().transpose(2, 3) for c in cache)
    with pytest.raises(ValueError, match="head_dim"):  # D not unit-stride
        da.decode_attention(q, k, v, lens)


def _v1_inputs(dev, dtype, quant, B, H, Hkv, D, ps, max_pages, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * max_pages + 3
    k = torch.randn((Hkv, P, ps, D), generator=g, device=dev)
    v = torch.randn((Hkv, P, ps, D), generator=g, device=dev)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = pa.quantize_rows_int8(k), pa.quantize_rows_int8(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    perm = torch.randperm(P, generator=g, device=dev)
    tables = perm[:B * max_pages].view(B, max_pages).to(torch.int32)
    # q as the model hands it over: a strided view of the QKV projection
    q = torch.randn((B, 3, H, D), generator=g, device=dev).to(dtype)[:, 0]
    return q, k, v, tables, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,Hkv,D,ps", [(8, 8, 64, 16), (16, 4, 128, 16),
                                        (8, 1, 128, 8), (4, 2, 32, 4)])
def test_paged_v1_kernel_matches_plain(cuda, dtype, quant, H, Hkv, D, ps):
    max_pages = 6
    cap = max_pages * ps
    lengths = [0, 1, ps + 3, cap, cap + 7]
    q, k, v, tables, ks, vs = _v1_inputs(cuda, dtype, quant, len(lengths),
                                         H, Hkv, D, ps, max_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, k, v, tables, lens, k_scales=ks,
                                    v_scales=vs)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    want = pa.paged_decode_attention_ref(q, k, v, tables, lens, k_scales=ks,
                                         v_scales=vs)
    assert got.dtype == dtype
    _ulp_close(got, want, dtype)
    assert torch.all(got[0] == 0)


def test_paged_kv_cache_on_card(cuda):
    """Prefill, appends and attends of a host-managed cache on the card
    (in-place writes from host indices, then #4) against the CPU's."""
    g = torch.Generator().manual_seed(8)
    kw = dict(num_pages=20, page_size=8, batch_size=3, num_kv_heads=2,
              head_dim=64, max_pages_per_seq=6, dtype=torch.float32)
    for quant in (False, True):
        caches = [pa.PagedKVCache(quantized=quant, device=d, **kw)
                  for d in ("cpu", cuda)]
        k0 = torch.randn((3, 13, 2, 64), generator=g)
        for c in caches:
            c.prefill(k0.to(c.device), (k0 * 0.5).to(c.device))
        for _ in range(5):
            k, q = torch.randn((3, 2, 64), generator=g), torch.randn(
                (3, 8, 64), generator=g)
            outs = []
            for c in caches:
                c.append(k.to(c.device), (k * 2).to(c.device))
                outs.append(c.attend(q.to(c.device)).cpu())
            torch.testing.assert_close(outs[1], outs[0], atol=2e-5, rtol=0)
        assert torch.equal(caches[1].k_pages.cpu(), caches[0].k_pages)


def _tiny_models(dev):
    from paddle_tpu_torch.convert import init_gpt, init_llama
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.models.llama import LlamaConfig

    gcfg = GPTConfig(vocab_size=96, hidden_size=128, num_layers=2,
                     num_heads=2, max_position=128)
    lcfg = LlamaConfig(vocab_size=128, hidden_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=256,
                       max_position=128)
    return (init_gpt(gcfg, seed=3, device=dev).eval(),
            init_llama(lcfg, seed=3, device=dev, dtype=torch.float32))


def test_generate_on_card_matches_cpu(cuda):
    """A tiny GPT (2 heads of 64) and a GQA LLaMA (4 over 2 heads of 64),
    f32, tf32 off: greedy and sampled ``generate`` on the card (#15 in the
    decode steps) give the CPU's tokens; per-step logits over 5-D caches
    (#14) and ``PagedKVCache``s (#4) on the card match the slab's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ids = torch.randint(0, 96, (2, 7), generator=torch.Generator()
                        .manual_seed(0))
    for cpu_m, card_m in zip(_tiny_models("cpu"), _tiny_models(cuda)):
        card_m.load_state_dict(cpu_m.state_dict())
        for kw in (dict(temperature=0.0), dict(temperature=0.9, top_k=8,
                                               seed=2)):
            before = da.decode_attention_slab.launches
            got = card_m.generate(ids.to(cuda), max_new_tokens=12, **kw)
            assert da.decode_attention_slab.launches == before + 11 * \
                card_m.config.num_layers
            want = cpu_m.generate(ids, max_new_tokens=12, **kw)
            assert torch.equal(got.cpu(), want), kw
        cfg = card_m.config
        kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
        hd = cfg.hidden_size // cfg.num_heads
        n = cfg.num_layers
        layouts = {
            "slab": card_m.init_caches(2, 32),
            "5d": [torch.zeros((2, 2, kv, 32, hd), device=cuda)
                   for _ in range(n)],
            "paged": [pa.PagedKVCache(16, 4, 2, kv, hd, 8,
                                      dtype=torch.float32, device=cuda)
                      for _ in range(n)]}
        logits = {}
        with torch.no_grad():
            for name, caches in layouts.items():
                out, caches = card_m(ids.to(cuda), caches=caches)
                steps = [out[:, -1]]
                for t in range(7, 12):
                    tok = ids[:, t - 7:t - 6].to(cuda)
                    out, caches = card_m(tok, caches=caches, time_step=t)
                    steps.append(out[:, -1])
                logits[name] = torch.stack(steps).cpu()
        for name in ("5d", "paged"):
            torch.testing.assert_close(logits[name], logits["slab"],
                                       atol=1e-4, rtol=0)


# ---- the position forms of #2 and #6, and the ring on the card --------
def _zigzag_rows(S, world):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        zigzag_indices)

    return torch.from_numpy(zigzag_indices(S, world)).view(world, -1)


def _pos_cases():
    """(tag, q positions, kv positions): zig-zag chunk pairs of a four-rank
    ring over 256 tokens (whole tiles visible, masked or diagonal; rank 0's
    first half-chunk sees no key of rank 3's), a chunk that sees no key,
    and ragged unequal lengths."""
    z = _zigzag_rows(256, 4)
    return [("pair03", z[0], z[3]), ("pair30", z[3], z[0]),
            ("pair11", z[1], z[1]), ("pair21", z[2], z[1]),
            ("none", torch.arange(40, dtype=torch.int32),
             torch.arange(50, 120, dtype=torch.int32)),
            ("ragged", torch.arange(37, dtype=torch.int32) + 5,
             torch.arange(29, dtype=torch.int32))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", range(6))
def test_flash_pos_kernels_match_plain(cuda, dtype, D, case):
    """Both position forms against their twins: out, lse (-1e30 exactly on
    rows that see no key, where out is 0), and dq/dk/dv with an lse
    cotangent; each wrapper counts one position-mode launch."""
    tag, qp, kp = _pos_cases()[case]
    g = torch.Generator(device=cuda).manual_seed(case)
    H = 4
    q = torch.randn((2, len(qp), H, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, len(kp), H, D), generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    dl = torch.randn((2, H, len(qp)), generator=g, device=cuda)
    pk = dict(q_positions=qp.to(cuda), kv_positions=kp.to(cuda))
    f0, b0 = fa.flash_attention_fwd.pos_launches, \
        fa.flash_attention_bwd.pos_launches
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **pk)
    grads = fa.flash_attention_bwd(q, k, v, out, do, lse, dl, **pk)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.pos_launches == f0 + 1
    assert fa.flash_attention_bwd.pos_launches == b0 + 1
    w_out, w_lse = fa.flash_attention_ref(q, k, v, return_lse=True, **pk)
    torch.testing.assert_close(out.float(), w_out.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    dead = w_lse == fa.NO_KEY_LSE
    assert bool((lse[dead] == fa.NO_KEY_LSE).all())
    assert not out.transpose(1, 2)[dead].any()
    torch.testing.assert_close(lse[~dead], w_lse[~dead], atol=1e-4,
                               rtol=1e-5)
    if tag == "none":
        assert bool(dead.all())
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, dl, **pk)
    _grads_close(grads, want, dtype, tag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_pos_kernels_llama_widths(cuda, dtype):
    """llama2_7b's attention widths (32 heads of 128): rank 0's chunk
    against rank 1's in a two-rank zig-zag ring over 4096 tokens."""
    z = _zigzag_rows(4096, 2).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn((1, 2048, 32, 128), generator=g,
                               device=cuda).to(dtype) for _ in range(4))
    pk = dict(q_positions=z[0], kv_positions=z[1])
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **pk)
    w_out, w_lse = fa.flash_attention_ref(q, k, v, return_lse=True, **pk)
    torch.testing.assert_close(out.float(), w_out.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert bool((lse[w_lse == fa.NO_KEY_LSE] == fa.NO_KEY_LSE).all())
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **pk)
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, **pk)
    _grads_close(got, want, dtype, "llama widths")


def test_flash_pos_equal_causal_on_card(cuda):
    """Positions 0..S-1 give the causal kernels' values, forward and
    backward (the same tiles, the same order)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn((2, 300, 4, 64), generator=g, device=cuda)
                   for _ in range(4))
    pos = torch.arange(300, dtype=torch.int32, device=cuda)
    a = fa.flash_attention_fwd(q, k, v, return_lse=True, q_positions=pos,
                               kv_positions=pos)
    b = fa.flash_attention_fwd(q, k, v, return_lse=True, causal=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ga = fa.flash_attention_bwd(q, k, v, a[0], do, a[1], q_positions=pos,
                                kv_positions=pos)
    gb = fa.flash_attention_bwd(q, k, v, b[0], do, b[1], causal=True)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


def test_ring_attention_one_rank_nccl(cuda):
    """``fleet.init`` (``sep_degree=1``) on a one-rank NCCL world, then the
    flash ring against ``impl="xla"`` in a zig-zag layout, bf16, forward
    and gradients; a CPU tensor on the NCCL group raises."""
    from paddle_tpu_torch.distributed import destroy_process_group, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ring_attention, zigzag_indices)

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        _one_rank_ring_checks(cuda, ring_attention, zigzag_indices)
    finally:
        destroy_process_group()


def _one_rank_ring_checks(cuda, ring_attention, zigzag_indices):
    g = torch.Generator(device=cuda).manual_seed(9)
    pos = torch.from_numpy(zigzag_indices(512, 4)).to(cuda)
    base = [torch.randn((2, 512, 8, 64), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(3)]
    do = torch.randn((2, 512, 8, 64), generator=g, device=cuda).to(
        torch.bfloat16)
    res = []
    for impl in ("flash", "xla"):
        ts = [t.clone().requires_grad_() for t in base]
        out = ring_attention(*ts, causal=True, q_positions=pos,
                             kv_positions=pos, impl=impl)
        out.backward(do)
        res.append([out.detach()] + [t.grad for t in ts])
    torch.testing.assert_close(res[0][0].float(), res[1][0].float(),
                               atol=2e-2, rtol=2e-2)
    _grads_close(res[0][1:], res[1][1:], torch.bfloat16, "ring")
    with pytest.raises(ValueError, match="nccl"):
        x = torch.zeros((1, 8, 8, 64))
        ring_attention(x, x, x)


# ------------------------------------------------ the tensor-core bodies of
# #2 and the backward (bf16 at D 64 and 128)
def _counts():
    return (fa.flash_attention_fwd.launches, fa.flash_attention_fwd.tc_launches,
            fa.flash_attention_bwd.launches, fa.flash_attention_bwd.tc_launches)


def _compiled_bodies(lib):
    """``{(body, dtype, D)}`` of the flash kernels that ``lib`` compiled,
    read from the mangled names in its ptxas report: a tensor-core kernel
    (``*_tc_kernel<D, POS>``) is bf16; an FMA kernel
    (``*_fma_kernel<T, D, POS>``) names its dtype."""
    from paddle_tpu_torch.kernels import build

    build.load(lib)
    found = set()
    for kind, args in re.findall(r"\dflash_\w+?_(tc|fma)_kernelI(\w+?)EEv",
                                 build.ptxas_report(lib)):
        d = int(re.search(r"Li(\d+)E", args).group(1))
        dtype = "f32" if args.startswith("f") else "bf16"
        found.add(("tensor_core" if kind == "tc" else "fma", dtype, d))
    return found


def test_flash_body_rule_matches_the_libraries(cuda):
    """Each library compiles the tensor-core body for exactly the (dtype,
    D) cases that ``flash_body`` names and the FMA body for the rest: no
    FMA body for bf16 at D 64 or 128 exists, so the wrappers'
    ``tc_launches`` (counted by ``flash_body``) is what ran."""
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    for lib, dims in (("flash_attention_fwd", (32, 64, 128, 256)),
                      ("flash_attention_bwd", (64, 128, 256))):
        want = {(fa.flash_body(dt, d), names[dt], d) for dt in names
                for d in dims}
        assert _compiled_bodies(lib) == want, lib


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 256)])
def test_flash_tc_launch_counts(cuda, dtype, D):
    """bf16 at D 64 and 128 reaches the tensor-core bodies (tc_launches +1
    in each wrapper); f32 and bf16 at D 256 do not."""
    q, k, v, out, do, lse, _ = _bwd_inputs(cuda, dtype, 1, 70, 70, 2, D,
                                           True)
    c0 = _counts()
    fa.flash_attention_fwd(q, k, v, return_lse=True)
    fa.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and D in (64, 128))
    assert tuple(b - a for a, b in zip(c0, _counts())) == (1, tc, 1, tc)


@pytest.mark.parametrize("S", [1, 63, 65, 1000, 1030])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_ragged_lengths(cuda, S, D, causal):
    """Ragged sequence lengths (no multiple of a tile) on the tensor-core
    bodies: out, lse and every gradient against the plain twins."""
    q, k, v, out, do, lse, dl = _bwd_inputs(cuda, torch.bfloat16, 2, S, S, 2,
                                            D, causal, seed=S, dlse=True)
    w_out, w_lse = fa.flash_attention_ref(q, k, v, causal=causal,
                                          return_lse=True)
    torch.testing.assert_close(out.float(), w_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, w_lse, atol=1e-3, rtol=1e-4)
    c0 = _counts()
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, dl, causal=causal)
    assert _counts()[3] == c0[3] + 1
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, dl,
                                      causal=causal)
    _grads_close(got, want, torch.bfloat16, f"S={S}")


@pytest.mark.parametrize("Sq,Sk", [(30, 130), (130, 30), (1, 700),
                                   (700, 1), (200, 1030)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_cross_lengths(cuda, Sq, Sk, causal):
    """Sq != Sk (top-left causality) on the tensor-core bodies."""
    q, k, v, out, do, lse, _ = _bwd_inputs(cuda, torch.bfloat16, 2, Sq, Sk,
                                           2, 64, causal, seed=Sq + Sk)
    w_out, w_lse = fa.flash_attention_ref(q, k, v, causal=causal,
                                          return_lse=True)
    torch.testing.assert_close(out.float(), w_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, w_lse, atol=1e-3, rtol=1e-4)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal)
    _grads_close(got, want, torch.bfloat16, f"{Sq}x{Sk}")


@pytest.mark.parametrize("S", [64, 333, 1024])
def test_flash_tc_gqa_32_8(cuda, S):
    """Native GQA on the tensor-core forward: 32 q heads over 8 kv heads
    at D = 128, k/v not expanded."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((2, S, 32, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((2, S, 8, 128), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    c0 = _counts()
    got, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    assert _counts()[1] == c0[1] + 1
    want, w_lse = fa.flash_attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, w_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_tc_packed_views(cuda, D):
    """q, k, v as views of one [B, S, 3H, D] buffer and dq/dk/dv written
    into views of one dQKV on the tensor-core bodies: the plain twins'
    values, and the contiguous call's bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(D)
    B, S, H = 2, 300, 4
    y = torch.randn((B, S, 3 * H, D), generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = y[:, :, :H], y[:, :, H:2 * H], y[:, :, 2 * H:]
    o = torch.empty((B, S, H, D), dtype=y.dtype, device=cuda)
    c0 = _counts()
    _, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, out=o)
    do = torch.randn((B, S, H, D), generator=g, device=cuda).to(y.dtype)
    dqkv = torch.empty_like(y)
    fa.flash_attention_bwd(q, k, v, o, do, lse, grads=(
        dqkv[:, :, :H], dqkv[:, :, H:2 * H], dqkv[:, :, 2 * H:]))
    assert tuple(b - a for a, b in zip(c0, _counts())) == (1, 1, 1, 1)
    want_o = fa.flash_attention_ref(q, k, v)
    torch.testing.assert_close(o.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    want = fa.flash_attention_bwd_ref(q, k, v, o, do, lse)
    _grads_close((dqkv[:, :, :H], dqkv[:, :, H:2 * H], dqkv[:, :, 2 * H:]),
                 want, torch.bfloat16, "packed")
    cq, ck, cv = (t.contiguous() for t in (q, k, v))
    co, clse = fa.flash_attention_fwd(cq, ck, cv, return_lse=True)
    assert torch.equal(co, o) and torch.equal(clse, lse)
    cg = fa.flash_attention_bwd(cq, ck, cv, co, do, clse)
    assert torch.equal(torch.cat(cg, 2), dqkv)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_tc_position_rows_without_keys(cuda, D):
    """Position mode on the tensor-core bodies: the first 48 queries see
    no key (out exactly 0, lse exactly -1e30, zero gradients), the rest a
    zig-zag-like mix of whole, masked and diagonal tiles."""
    g = torch.Generator(device=cuda).manual_seed(D)
    qp = torch.cat([torch.arange(48), torch.arange(500, 700)]).to(
        torch.int32)
    kp = (torch.arange(300, dtype=torch.int32) * 2 + 100)
    q = torch.randn((2, len(qp), 4, D), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((2, len(kp), 4, D), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    pk = dict(q_positions=qp.to(cuda), kv_positions=kp.to(cuda))
    c0 = _counts()
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **pk)
    grads = fa.flash_attention_bwd(q, k, v, out, do, lse, **pk)
    assert tuple(b - a for a, b in zip(c0, _counts())) == (1, 1, 1, 1)
    assert bool((lse[:, :, :48] == fa.NO_KEY_LSE).all())
    assert not out[:, :48].any() and not grads[0][:, :48].any()
    w_out, w_lse = fa.flash_attention_ref(q, k, v, return_lse=True, **pk)
    torch.testing.assert_close(out.float(), w_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse[:, :, 48:], w_lse[:, :, 48:], atol=1e-4,
                               rtol=1e-5)
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, **pk)
    _grads_close(grads, want, torch.bfloat16, "positions")


def test_flash_tc_backward_deterministic_at_t1(cuda):
    """The T1 training shape (GPT-medium heads, 12 x 1024, the packed
    route's views into one dQKV): two backward runs give bitwise-equal
    gradients (three launches, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, S, H, D = 12, 1024, 16, 64
    y = torch.randn((B, S, 3 * H, D), generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = y[:, :, :H], y[:, :, H:2 * H], y[:, :, 2 * H:]
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    do = torch.randn((B, S, H, D), generator=g, device=cuda).to(y.dtype)
    runs = []
    for _ in range(2):
        dqkv = torch.empty_like(y)
        fa.flash_attention_bwd(q, k, v, o, do, lse, grads=(
            dqkv[:, :, :H], dqkv[:, :, H:2 * H], dqkv[:, :, 2 * H:]))
        runs.append(dqkv)
    assert torch.equal(runs[0], runs[1])


def test_flash_tc_refuses_views_cp_async_cannot_take(cuda):
    """A base or a (batch, seq, head) stride that is no multiple of 16
    bytes raises ValueError naming the operand; the f32 FMA body takes the
    same view."""
    bf = torch.bfloat16
    q = torch.zeros((1, 16, 2, 64), dtype=bf, device=cuda)
    flat = torch.zeros(q.numel() + 8, dtype=bf, device=cuda)
    k = flat[4:4 + q.numel()].view_as(q)
    with pytest.raises(ValueError, match="^k: .*base address"):
        fa.flash_attention_fwd(q, k, q)
    wide = torch.zeros((1, 16, 2 * 64 + 4), dtype=bf, device=cuda)
    v = wide[..., :128].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="^v: .*seq stride"):
        fa.flash_attention_fwd(q, q, v)
    lse = torch.zeros((1, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="^do: .*seq stride"):
        fa.flash_attention_bwd(q, q, q, q, v, lse)
    f = torch.zeros((1, 16, 2 * 64 + 1), device=cuda)[..., :128].view(
        1, 16, 2, 64)
    fa.flash_attention_fwd(f, f, f)
    torch.cuda.synchronize()


# ------------------------------------------------ the tensor-core body and
# split-K of #3, the wgmma body of #13
def _verify_counts():
    return (pa.paged_verify_slab_attention.launches,
            pa.paged_verify_slab_attention.tc_launches)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("m", [1, 5, 17, 64, 65, 300])
@pytest.mark.parametrize("H,Hkv", [(32, 8), (8, 2)])
@pytest.mark.parametrize("D", [64, 128])
def test_verify_tc_body_matches_plain(cuda, quant, m, H, Hkv, D):
    """bf16 q at D 64/128 on the tensor-core body, bf16 and int8 pages,
    GQA groups of 4: bases at 0, mid-page, at the capacity and past it
    (every query clamped there), and one whose limits cross the capacity
    inside the block."""
    ps, max_pages = 16, 24
    cap = ps * max_pages
    bases = [0, ps // 2 + 3, cap, cap + 9, cap - m // 2 - 1]
    q, k, v, tables, sc = _verify_inputs(cuda, torch.bfloat16, quant,
                                         len(bases), m, H, Hkv, D, ps,
                                         max_pages, seed=m + D)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    assert pa.verify_body(q.dtype, k.dtype, D) == "tensor_core"
    c0 = _verify_counts()
    got = pa.paged_verify_slab_attention(q, k, v, tables, base,
                                         scale_pages=sc)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(c0, _verify_counts())) == (1, 1)
    want = pa.paged_verify_slab_attention_ref(q, k, v, tables, base,
                                              scale_pages=sc)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.bfloat16, True),
                                         (torch.float32, False),
                                         (torch.float32, True)])
@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("splits", [2, 3, 7, 16])
def test_verify_split_k_matches_plain(cuda, dtype, quant, m, splits):
    """Forced split-K over long windows (capacity 4096) at narrow m, on
    both bodies: bases at 0 (every chunk but the first holds no key), in
    the middle, at the capacity and past it; the merged result against
    the plain twin."""
    ps, max_pages = 16, 256
    cap = ps * max_pages
    bases = [0, 1000, 2049, cap - 3, cap, cap + 50]
    q, k, v, tables, sc = _verify_inputs(cuda, dtype, quant, len(bases), m,
                                         32, 8, 128, ps, max_pages,
                                         seed=splits)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    got = pa._paged_verify(q, k, v, tables, base, scale_pages=sc,
                           splits=splits)
    torch.cuda.synchronize()
    want = pa.paged_verify_slab_attention_ref(q, k, v, tables, base,
                                              scale_pages=sc)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_verify_splits_rule_on_card(cuda):
    """The wrapper's own choice at the spec-verify shape of llama2_7b
    splits the window, and its merged result matches the twin."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pa.verify_splits(8, 5, 32, 32, 4096, sms) > 1
    assert pa.verify_splits(8, 256, 32, 32, 4096, sms) == 1
    q, k, v, tables, _ = _verify_inputs(cuda, torch.bfloat16, False, 8, 5,
                                        32, 32, 128, 16, 256)
    base = torch.tensor([0, 1, 17, 300, 1000, 2049, 3333, 4094],
                        dtype=torch.int32, device=cuda)
    got = pa.paged_verify_slab_attention(q, k, v, tables, base)
    want = pa.paged_verify_slab_attention_ref(q, k, v, tables, base)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,D,quant", [(torch.bfloat16, 64, False),
                                           (torch.bfloat16, 128, True),
                                           (torch.bfloat16, 128, False),
                                           (torch.float32, 64, False),
                                           (torch.float32, 128, True),
                                           (torch.bfloat16, 256, False)])
def test_verify_tc_launch_counts(cuda, dtype, D, quant):
    """bf16 at D 64 and 128 reaches the tensor-core body (tc_launches +1);
    f32 and bf16 at D 256 stay on the FMA body. The FMA body forced on a
    bf16 call gives the same result within the bf16 tolerance."""
    q, k, v, tables, sc = _verify_inputs(cuda, dtype, quant, 2, 9, 4, 2, D,
                                         16, 6)
    base = torch.tensor([3, 70], dtype=torch.int32, device=cuda)
    c0 = _verify_counts()
    got = pa.paged_verify_slab_attention(q, k, v, tables, base,
                                         scale_pages=sc)
    tc = int(dtype == torch.bfloat16 and D in (64, 128))
    assert tuple(b - a for a, b in zip(c0, _verify_counts())) == (1, tc)
    fma = pa._paged_verify(q, k, v, tables, base, scale_pages=sc,
                           body="fma")
    torch.testing.assert_close(got, fma, atol=TOL[dtype], rtol=TOL[dtype])
    if not tc:
        with pytest.raises(ValueError, match="tensor_core"):
            pa._paged_verify(q, k, v, tables, base, scale_pages=sc,
                             body="tensor_core")


def _grouped_case(dev, M, K, N, sizes, valid, seed=0):
    lhs, rhs = _grouped_inputs(dev, torch.bfloat16, M, K, N, len(sizes),
                               seed)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    vs = None if valid is None else torch.tensor(valid, dtype=torch.int32,
                                                 device=dev)
    return lhs, rhs, gs, vs


@pytest.mark.parametrize("M,K,N,sizes,valid", [
    # ragged groups, none a multiple of 128, rows past the last group
    (1100, 256, 200, [300, 77, 0, 500, 150], [300, 0, 0, 499, 1]),
    # zero and full valid counts, N a multiple of 8 but of no tile
    (1280, 4096, 1032, [640, 640], [0, 640]),
    (520, 72, 40, [129, 260, 131], None),
    # the down projection's depth
    (640, 14336, 512, [320, 320], [320, 100]),
    # the gate/up width at 64 rows an expert (the rule's edge)
    (512, 4096, 14336, [64] * 8, [64, 63, 0, 64, 1, 64, 32, 64]),
])
def test_grouped_wgmma_body_matches_plain(cuda, M, K, N, sizes, valid):
    lhs, rhs, gs, vs = _grouped_case(cuda, M, K, N, sizes, valid, seed=M)
    assert gm.grouped_body(torch.bfloat16, M, K, N, len(sizes)) == "wgmma"
    before = (gm.grouped_matmul.launches, gm.grouped_matmul.wgmma_launches)
    got = gm.grouped_matmul(lhs, rhs, gs, vs)
    torch.cuda.synchronize()
    assert (gm.grouped_matmul.launches, gm.grouped_matmul.wgmma_launches) \
        == (before[0] + 1, before[1] + 1)
    want = gm.grouped_matmul_ref(lhs, rhs, gs, vs)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    dead = (want == 0).all(-1)
    assert not bool(got[dead].any())  # dead rows exactly zero
    end = min(sum(sizes), M)
    assert not bool(got[end:].any())  # rows past the last group


@pytest.mark.parametrize("dtype,M,K,N,E", [
    (torch.bfloat16, 24, 4096, 14336, 8),   # decode, C = 3
    (torch.float32, 1280, 256, 256, 2),     # f32
    (torch.bfloat16, 300, 100, 70, 4),      # K, N no multiple of 8
])
def test_grouped_rule_sends_to_wmma_body(cuda, dtype, M, K, N, E):
    assert gm.grouped_body(dtype, M, K, N, E) == "wmma"
    lhs, rhs = _grouped_inputs(cuda, dtype, M, K, N, E)
    gs = torch.full((E,), M // E, dtype=torch.int32, device=cuda)
    before = gm.grouped_matmul.wgmma_launches
    got = gm.grouped_matmul(lhs, rhs, gs)
    assert gm.grouped_matmul.wgmma_launches == before
    want = gm.grouped_matmul_ref(lhs, rhs, gs)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_grouped_wgmma_refuses_misaligned_operands(cuda):
    """A base address TMA cannot read raises ValueError naming the
    operand; the call is never rerouted to the WMMA body."""
    lhs, rhs, gs, _ = _grouped_case(cuda, 256, 64, 64, [128, 128], None)
    flat = torch.zeros(lhs.numel() + 8, dtype=lhs.dtype, device=cuda)
    bad = flat[4:4 + lhs.numel()].view_as(lhs)
    before = gm.grouped_matmul.launches
    with pytest.raises(ValueError, match="^lhs: .*16-byte"):
        gm.grouped_matmul(bad, rhs, gs)
    flat = torch.zeros(rhs.numel() + 8, dtype=rhs.dtype, device=cuda)
    with pytest.raises(ValueError, match="^rhs: .*16-byte"):
        gm.grouped_matmul(lhs, flat[2:2 + rhs.numel()].view_as(rhs), gs)
    assert gm.grouped_matmul.launches == before


# ------------------------------------------------ the tensor-core body of
# #12 and the split decode body of #1, #4, #14, #15
def _quant_counts():
    return qm.quant_matmul.launches, qm.quant_matmul.tc_launches


@pytest.mark.parametrize("body", ["tensor_core", "fma"])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("M", [1, 8, 40, 64, 65, 256])
@pytest.mark.parametrize("bias", [True, False])
def test_quant_bodies_match_plain(cuda, body, int4, M, bias):
    """Both bodies of #12 on bf16 x: K = 1030 (no multiple of a split or
    of a stage) and an odd N = 129 (no multiple of the column tile, the
    plain-load staging path), then the llama2_7b gate shape; one launch a
    call, on the body asked for."""
    wd = "int4" if int4 else "int8"
    for K, N in ((1030, 129), (4096, 11008)):
        x, w, sc, b = _quant_inputs(cuda, torch.bfloat16, int4, M, K, N,
                                    seed=M, bias=bias)
        c0 = _quant_counts()
        got = qm._quant_matmul(x, w, sc, b, weight_dtype=wd, body=body)
        torch.cuda.synchronize()
        tc = int(body == "tensor_core")
        assert tuple(y - a for a, y in zip(c0, _quant_counts())) == (1, tc)
        want = qm.quant_matmul_ref(x, w, sc, b, weight_dtype=wd)
        assert got.dtype == torch.bfloat16 and got.shape == (M, N)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("dtype,rows,body", [
    (torch.bfloat16, 8, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.float32, 8, "fma"), (torch.float32, 256, "fma")])
def test_quant_body_rule_on_card(cuda, dtype, rows, body):
    """The wrapper's own choice follows ``quant_body``: bf16 x on the
    tensor cores (tc_launches + 1), f32 on the FMA body; the tensor-core
    body refuses f32 x."""
    assert qm.quant_body(dtype, rows) == body
    x, w, sc, b = _quant_inputs(cuda, dtype, False, rows, 512, 256)
    c0 = _quant_counts()
    got = qm.quant_matmul(x, w, sc, b)
    tc = int(body == "tensor_core")
    assert tuple(y - a for a, y in zip(c0, _quant_counts())) == (1, tc)
    torch.testing.assert_close(got.float(), qm.quant_matmul_ref(
        x, w, sc, b).float(), atol=TOL[dtype], rtol=TOL[dtype])
    if not tc:
        with pytest.raises(ValueError, match="tensor_core"):
            qm._quant_matmul(x, w, sc, b, body="tensor_core")


@pytest.mark.parametrize("int4", [False, True])
def test_quant_tc_body_is_deterministic(cuda, int4):
    """Two calls give bitwise-equal outputs: the last block of a tile sums
    the splits in split order whichever block arrives last."""
    wd = "int4" if int4 else "int8"
    x, w, sc, b = _quant_inputs(cuda, torch.bfloat16, int4, 40, 4096, 4096)
    assert qm.split_plan(40, 4096, 4096, int4, "tensor_core")[0] > 1
    first = qm.quant_matmul(x, w, sc, b, weight_dtype=wd)
    for _ in range(3):
        assert torch.equal(qm.quant_matmul(x, w, sc, b, weight_dtype=wd),
                           first)


def test_quant_tc_counters_reset_between_calls(cuda):
    """Calls in a row on different shapes (the arrival counters of one
    call's tiles are the next call's) are all right, and the counter
    buffer is left zeroed."""
    from paddle_tpu_torch.kernels import build

    for i, (M, K, N, int4) in enumerate(((8, 4096, 11008, False),
                                         (40, 11008, 4096, True),
                                         (3, 4096, 32000, False),
                                         (8, 4096, 11008, True))):
        wd = "int4" if int4 else "int8"
        x, w, sc, b = _quant_inputs(cuda, torch.bfloat16, int4, M, K, N,
                                    seed=i)
        got = qm.quant_matmul(x, w, sc, b, weight_dtype=wd)
        want = qm.quant_matmul_ref(x, w, sc, b, weight_dtype=wd)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    torch.cuda.synchronize()
    assert not bool(build.arrival_counters(cuda, 1).any())


_SPLIT_LENS = [0, 1, 15, 16, 17, 77, 128]  # capacity 128 = 8 pages of 16


def _split_decode(cuda, layout, dtype, quant, splits, seed=0):
    """(kernel output with ``splits`` forced, plain output) of one decode
    layout at lengths with 0, 1, the tile edges 15/16/17 and the
    capacity; GQA 8/2 at D 128."""
    B, H, Hkv, D, ps, max_pages = len(_SPLIT_LENS), 8, 2, 128, 16, 8
    lens = torch.tensor(_SPLIT_LENS, dtype=torch.int32, device=cuda)
    if layout == "slab_pages":
        q, k, v, tables, _, sc = _decode_inputs(
            cuda, dtype, quant, B, H, Hkv, D, ps, max_pages, _SPLIT_LENS,
            seed)
        return (pa._paged_slab_decode(q, k, v, tables, lens, scale_pages=sc,
                                      splits=splits),
                pa.paged_slab_decode_attention_ref(q, k, v, tables, lens,
                                                   scale_pages=sc))
    if layout == "head_major":
        q, k, v, tables, ks, vs = _v1_inputs(cuda, dtype, quant, B, H, Hkv,
                                             D, ps, max_pages, seed)
        return (pa._paged_decode(q, k, v, tables, lens, k_scales=ks,
                                 v_scales=vs, splits=splits),
                pa.paged_decode_attention_ref(q, k, v, tables, lens,
                                              k_scales=ks, v_scales=vs))
    S = ps * max_pages
    q, cache = _contig_inputs(cuda, dtype, B, H, Hkv, D, S, seed)
    k, v = cache[0], cache[1]
    counter = da.decode_attention
    if layout == "slab":
        slab = cache.transpose(2, 3).reshape(2, B, S, Hkv * D).contiguous()
        k, v = da._slab_views(slab, D)
        counter = da.decode_attention_slab
    return (da._launch(q, k, v, lens, 1.0 / D ** 0.5, counter, splits),
            da.decode_attention_ref(q, k, v, lens))


_LAYOUTS = ["slab_pages", "head_major", "5d", "slab"]


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("splits", range(1, 17))
def test_decode_split_body_matches_plain(cuda, layout, splits):
    """The decode body at forced splits 1-16 on all four layouts: bf16 and
    f32 (and int8 pages on the paged layouts), against the plain twins
    (f32 within 2e-5, bf16 within one bf16 ulp of the largest entry);
    length 0 gives exact zeros."""
    cases = [(torch.bfloat16, False), (torch.float32, False)]
    if layout in ("slab_pages", "head_major"):
        cases += [(torch.bfloat16, True), (torch.float32, True)]
    for dtype, quant in cases:
        got, want = _split_decode(cuda, layout, dtype, quant, splits,
                                  seed=splits)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        _ulp_close(got, want, dtype)
        assert torch.all(got[0] == 0)


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_decode_split_body_is_deterministic(cuda, layout):
    """Two calls with the same split give bitwise-equal outputs (the
    chunks merge in split order), and calls in a row at other splits are
    all right (the counters reset)."""
    a, _ = _split_decode(cuda, layout, torch.bfloat16, False, 7)
    b, _ = _split_decode(cuda, layout, torch.bfloat16, False, 7)
    assert torch.equal(a, b)
    for splits in (3, 16, 2):
        got, want = _split_decode(cuda, layout, torch.float32, False, splits,
                                  seed=splits)
        _ulp_close(got, want, torch.float32)


def test_decode_splits_rule_on_card(cuda):
    """The wrappers' own choice at llama2_7b's serving shape splits each
    window (and leaves a wide batch whole), and its result matches the
    plain twin at the main path's ragged lengths."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pa.decode_splits(8, 32, 32, 4096, sms) > 1
    assert pa.decode_splits(8, 32, 8, 4096, sms) > 1
    assert pa.decode_splits(256, 32, 32, 4096, sms) == 1
    lengths = [0, 1, 17, 300, 1000, 2049, 3333, 4096]
    q, k, v, tables, lens, _ = _decode_inputs(
        cuda, torch.bfloat16, False, 8, 32, 8, 128, 16, 256, lengths)
    got = pa.paged_slab_decode_attention(q, k, v, tables, lens)
    want = pa.paged_slab_decode_attention_ref(q, k, v, tables, lens)
    _ulp_close(got, want, torch.bfloat16)
    assert torch.equal(got, pa._paged_slab_decode(
        q, k, v, tables, lens, splits=pa.decode_splits(8, 32, 8, 4096, sms)))


@pytest.mark.parametrize("layout", ["slab_pages", "5d"])
@pytest.mark.parametrize("splits", [2, 3, 4, 8])
def test_decode_split_floor_on_a_full_grid(cuda, layout, splits):
    """A grid that gives every SM a block (B=8, 32 kv heads) cuts only
    windows past the 512-row floor: lengths below, at and past it and up
    to the capacity, some rows in one chunk (written at once) and some in
    several (merged), against the plain twin."""
    B, H, D, ps, max_pages = 8, 32, 128, 16, 64
    lengths = [0, 1, 511, 512, 513, 700, 1000, 1024]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pa.decode_min_chunk(B, H, H, sms) == 512
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        if layout == "slab_pages":
            q, k, v, tables, _, _ = _decode_inputs(
                cuda, dtype, False, B, H, H, D, ps, max_pages, lengths,
                seed=splits)
            got = pa._paged_slab_decode(q, k, v, tables, lens, splits=splits)
            want = pa.paged_slab_decode_attention_ref(q, k, v, tables, lens)
        else:
            q, cache = _contig_inputs(cuda, dtype, B, H, H, D, ps * max_pages,
                                      seed=splits)
            got = da._launch(q, cache[0], cache[1], lens, D ** -0.5,
                             da.decode_attention, splits)
            want = da.decode_attention_ref(q, cache[0], cache[1], lens)
        torch.cuda.synchronize()
        _ulp_close(got, want, dtype)
        assert torch.all(got[0] == 0)
