"""The rules that pick the bodies of the verify kernel (#3) and the grouped
expert matmul (#13), and the arithmetic of the verify kernel's split-K and
tensor-core bodies, on the CPU.

``verify_body`` sends bf16 q at head dim 64 and 128 (bf16 or int8 pages)
to the tensor-core body and the rest to the FMA body; ``verify_splits``
cuts each row's window into chunks from host-known values only (the call
never reads ``base_len``); ``grouped_body`` sends bf16 prefill shapes (64
or more capacity rows an expert, K and N multiples of 8) to the ``wgmma``
body, whose TMA loads need 16-byte aligned bases (``check_wgmma_alignment``
refuses others by name). These are pure shape and address rules, so they
run here on CPU tensors.

``paged_verify_chunked_ref`` is the plain twin of the kernel's split-K
partials and their log-space merge, and, with ``bf16_p``, of the
tensor-core body's rounding point (the unnormalised P times each key's v
scale rounded to bf16). Both are held against the JAX
``_paged_multi_query_ref``: the merge in f32 within 1e-5 (the same math
summed in another order), the bf16 rounding point within the card tests'
bf16 tolerance, 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as J

from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

H, HKV, D, PS, MAXP = 8, 2, 32, 16, 64
CAP = PS * MAXP
SMS = 132  # the H100's SM count


@pytest.mark.parametrize("q_dtype,kv_dtype,head_dim,body", [
    (torch.bfloat16, torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, torch.int8, 128, "tensor_core"),
    (torch.bfloat16, torch.int8, 64, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 256, "fma"),
    (torch.bfloat16, torch.int8, 256, "fma"),
    (torch.float32, torch.float32, 64, "fma"),
    (torch.float32, torch.float32, 128, "fma"),
    (torch.float32, torch.int8, 128, "fma"),
])
def test_verify_body_rule(q_dtype, kv_dtype, head_dim, body):
    assert pa.verify_body(q_dtype, kv_dtype, head_dim) == body


@pytest.mark.parametrize("B,m,H_,Hkv,want", [
    (8, 5, 32, 32, "split"),     # llama2_7b spec verify
    (8, 5, 32, 8, "split"),      # Mixtral GQA spec verify
    (8, 1, 32, 32, "split"),
    (8, 256, 32, 32, 1),         # chunked prefill fills the card
    (8, 512, 32, 8, 1),          # suffix prefill
    (64, 5, 32, 32, 1),          # a wide batch fills it too
])
def test_verify_splits_rule(B, m, H_, Hkv, want):
    s = pa.verify_splits(B, m, H_, Hkv, 4096, SMS)
    if want == "split":
        assert 1 < s <= 16
    else:
        assert s == want


@pytest.mark.parametrize("cap", [1, 16, 64, 65, 200, 640, 1024, 4096,
                                 32768])
@pytest.mark.parametrize("B,m", [(1, 1), (2, 5), (8, 5), (8, 17)])
def test_verify_splits_never_exceed_the_window(cap, B, m):
    """More splits never exceed the window's 64-key tiles, and the chunks
    of ``verify_chunk`` cover the window with none wholly past it."""
    s = pa.verify_splits(B, m, 32, 8, cap, SMS)
    tiles = -(-cap // 64)
    assert 1 <= s <= tiles
    chunk = pa.verify_chunk(cap, s)
    assert chunk % 64 == 0
    assert (s - 1) * chunk < cap <= s * chunk


def test_verify_splits_is_host_only():
    """The rule takes no tensor: nothing of base_len (a card tensor on the
    engine's path) is read to choose the chunks."""
    import inspect

    params = inspect.signature(pa.verify_splits).parameters
    assert list(params) == ["batch", "m", "num_heads", "num_kv_heads",
                            "capacity", "sm_count"]
    assert pa.verify_splits(8, 5, 32, 32, 4096, SMS) == pa.verify_splits(
        8, 5, 32, 32, 4096, SMS)


@pytest.mark.parametrize("dtype,M,K,N,E,body", [
    (torch.bfloat16, 8 * 1280, 4096, 14336, 8, "wgmma"),   # gate / up
    (torch.bfloat16, 8 * 1280, 14336, 4096, 8, "wgmma"),   # down
    (torch.bfloat16, 8 * 640, 4096, 14336, 8, "wgmma"),    # a 256-chunk
    (torch.bfloat16, 8 * 64, 4096, 14336, 8, "wgmma"),     # the edge
    (torch.bfloat16, 8 * 63, 4096, 14336, 8, "wmma"),
    (torch.bfloat16, 24, 4096, 14336, 8, "wmma"),          # decode C = 3
    (torch.bfloat16, 24, 14336, 4096, 8, "wmma"),
    (torch.float32, 8 * 1280, 4096, 14336, 8, "wmma"),     # f32
    (torch.bfloat16, 1280, 100, 64, 2, "wmma"),            # K % 8
    (torch.bfloat16, 1280, 64, 70, 2, "wmma"),             # N % 8
])
def test_grouped_body_rule(dtype, M, K, N, E, body):
    assert gm.grouped_body(dtype, M, K, N, E) == body


def test_mixtral_widths_take_the_wgmma_body_at_prefill():
    """The Mixtral-width MoE layer's prefill GEMMs (capacity 1.25 * 2 * T
    / 8 rows an expert) reach wgmma from a 202-token wave on, and its
    decode GEMMs (8 tokens, C = 3) stay on the WMMA body."""
    import math

    def cap(t):
        return max(1, math.ceil(1.25 * 2 * t / 8))

    for t, body in ((8, "wmma"), (201, "wmma"), (202, "wgmma"),
                    (256, "wgmma"), (4096, "wgmma")):
        c = cap(t)
        assert gm.grouped_body(torch.bfloat16, 8 * c, 4096, 14336, 8) == body
        assert gm.grouped_body(torch.bfloat16, 8 * c, 14336, 4096, 8) == body


def test_fresh_operands_pass_the_alignment_rule():
    lhs = torch.zeros((8 * 80, 64), dtype=torch.bfloat16)
    rhs = torch.zeros((8, 64, 128), dtype=torch.bfloat16)
    gm.check_wgmma_alignment(("lhs", lhs), ("rhs", rhs))
    # the engine's dispatch buffer view: the first E * C rows of E * C + 1
    disp = torch.zeros((8 * 80 + 1, 64), dtype=torch.bfloat16)
    gm.check_wgmma_alignment(("lhs", disp[:8 * 80]))


@pytest.mark.parametrize("name,offset", [("lhs", 1), ("lhs", 4),
                                         ("rhs", 3), ("rhs", 7)])
def test_misaligned_operand_is_refused_by_name(name, offset):
    flat = torch.zeros(4096 + 16, dtype=torch.bfloat16)
    t = flat[offset:offset + 4096].view(64, 64)
    assert t.data_ptr() % 16
    ok = torch.zeros((64, 64), dtype=torch.bfloat16)
    ops = {"lhs": ok, "rhs": ok, name: t}
    with pytest.raises(ValueError, match=rf"^{name}: .*16-byte aligned"):
        gm.check_wgmma_alignment(("lhs", ops["lhs"]), ("rhs", ops["rhs"]))


def test_grouped_cpu_path_ignores_the_rule():
    """On the CPU the wrapper takes the plain twin whatever the body rule
    says, and counts no launch."""
    g = torch.Generator().manual_seed(0)
    lhs = torch.randn((2 * 64, 16), generator=g).to(torch.bfloat16)
    rhs = torch.randn((2, 16, 24), generator=g).to(torch.bfloat16)
    gs = torch.tensor([64, 50], dtype=torch.int32)
    before = (gm.grouped_matmul.launches, gm.grouped_matmul.wgmma_launches)
    got = gm.grouped_matmul(lhs, rhs, gs)
    assert (gm.grouped_matmul.launches,
            gm.grouped_matmul.wgmma_launches) == before
    torch.testing.assert_close(got, gm.grouped_matmul_ref(lhs, rhs, gs))
    assert not bool(got[114:].any())


# ------------------------------------------------ the verify arithmetic
def _pages(rng, b, kind):
    p_total = 1 + b * MAXP
    shape = (p_total, PS, HKV * D)
    sc = None
    if kind == "int8":
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        sc = np.zeros((p_total, PS, 128), np.float32)
        sc[..., :2 * HKV] = (rng.standard_normal((p_total, PS, 2 * HKV))
                             * 0.01 + 0.02)
        sc = np.asarray(jnp.asarray(sc, jnp.bfloat16).astype(jnp.float32))
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        if kind == "bf16":  # values bf16 holds exactly, on both sides
            kp, vp = (np.asarray(jnp.asarray(x, jnp.bfloat16)
                                 .astype(jnp.float32)) for x in (kp, vp))
    tables = rng.permutation(np.arange(1, p_total, dtype=np.int32))[
        :b * MAXP].reshape(b, MAXP)
    return kp, vp, sc, tables


def _jax_ref(q, kp, vp, sc, tables, base, m):
    js = J.PagedCacheState(
        jnp.asarray(kp), jnp.asarray(vp),
        None if sc is None else jnp.asarray(sc, jnp.bfloat16),
        jnp.asarray(tables), jnp.asarray(base + m), PS, verify=True)
    return np.asarray(J._paged_multi_query_ref(jnp.asarray(q), js,
                                               jnp.asarray(base)))


def _torch_args(q, kp, vp, sc, tables, base, kind):
    pages = (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    if kind == "bf16":
        pages = tuple(p.bfloat16() for p in pages)
    return dict(q=torch.from_numpy(q.copy()), k_pages=pages[0],
                v_pages=pages[1], block_tables=torch.from_numpy(tables),
                base_len=torch.from_numpy(base),
                scale_pages=(None if sc is None
                             else torch.from_numpy(sc.copy()).bfloat16()))


# bases: 0 (every chunk past the first holds no key of the first queries),
# mid-page, mid-window, one whose block crosses the capacity, past it
BASES = np.array([0, PS // 2 + 3, 517, CAP - 3, CAP + 9], np.int32)


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_split_k_merge_matches_jax_ref(splits, kind):
    """The split-K partials and their log-space merge against the JAX
    reference, f32 within 1e-5 (int8 pages: dequantised values reach
    about 5, so relative 1e-5 as well)."""
    rng = np.random.default_rng(splits)
    m = 5
    kp, vp, sc, tables = _pages(rng, len(BASES), kind)
    q = rng.standard_normal((len(BASES), m, H, D)).astype(np.float32)
    want = _jax_ref(q, kp, vp, sc, tables, BASES, m)
    got = pa.paged_verify_chunked_ref(
        **_torch_args(q, kp, vp, sc, tables, BASES, kind), splits=splits)
    assert got.dtype == torch.float32 and got.shape == (len(BASES), m, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_split_k_chunks_are_those_of_the_kernel():
    """The twin cuts the window where the kernel does: ``verify_chunk``
    keys a chunk, and a chunk holding no key of a row weighs nothing."""
    for splits in range(1, 9):
        chunk = pa.verify_chunk(CAP, splits)
        assert chunk % 64 == 0 and -(-CAP // chunk) <= splits


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("m", [1, 5, 17])
@pytest.mark.parametrize("splits", [1, 3])
def test_tensor_core_rounding_point_within_bf16_tolerance(kind, m, splits):
    """The tensor-core body's arithmetic (bf16 q, K and V exact in bf16,
    P times the v scale rounded to bf16 before P.V, every sum f32) against
    the JAX reference on the same bf16 inputs, within 2e-2."""
    rng = np.random.default_rng(m + splits)
    kp, vp, sc, tables = _pages(rng, len(BASES), kind)
    q = np.asarray(jnp.asarray(
        rng.standard_normal((len(BASES), m, H, D)), jnp.bfloat16)
        .astype(jnp.float32))
    want = _jax_ref(q, kp, vp, sc, tables, BASES, m)
    args = _torch_args(q, kp, vp, sc, tables, BASES, kind)
    args["q"] = args["q"].bfloat16()
    got = pa.paged_verify_chunked_ref(**args, splits=splits, bf16_p=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)
    # and the rounding does move the result: the point is not the f32 one
    exact = pa.paged_verify_chunked_ref(**args, splits=splits)
    assert float((got - exact).abs().max()) > 0
